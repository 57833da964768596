#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only 41 42 43 44

Phases, each of which must pass or the script exits non-zero (``--only
PHASE...`` runs phases 1 and 2, then the phases named, each after the
phases whose results it reads, and prints ``DONE`` instead of the
kernels line):

1. device: the card's name, count, and name / power limit and maximum
   SM clock (for the special-function unit's rate) from nvidia-smi;
2. build: every hand-written kernel from ``src/repro_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, all at once), with the compiler's
   register / shared-memory / spill report, K1's (forward and backward),
   K2's and K5's tensor-core kernels', K3's gather's, K4's vector forward's
   and backward's and K6's picked out: none may spill (K6: its N = 16
   instances);
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving and training paths give it (K1 forward on both
   routes, also with bf16 weights passed in; its backward on both routes
   at the train, decode and ragged shapes and at d = 192, F = 320, the
   tensor-core route also against its rounding model and repeated bit for
   bit; K2 masked similarity on both routes (bf16 rows on the tensor
   cores, f32 on FMAs) repeating bit for bit with skipped tiles zero, and
   its fused entry, the skip rules in the kernel, with every unmeasured
   entry and the measured fractions bit for bit its plain version; K3 row
   gather (int64 and int32 index) and its backward, the group-local entry
   bit for bit the general one), then
   timed (CUDA events, and profiler device time where the host's time
   could hide the kernel's) beside the plain version, a PyTorch yardstick
   (K1: f32 and bf16 bmm, in turns; the bf16 weight cast timed on its
   own; K1's backward in turns with its FMA route and the f32 and bf16
   bmm composites; K3: index_select; K2: both entries and the f32 route)
   and its bound;
4. slice: full-width moe-gpt2 (16 experts, random weights from a seed)
   served through the port's launcher, ``repro_torch.launch.serve``:
   batched prefill (warm-up + timed), step-wise prompt feed into the KV
   cache, greedy decode. K1 must have launched as many times as the path
   calls it, and its tensor-core route must have cast each expert weight
   tensor to bf16 exactly once;
5. parity: the same full-width weights at 2 layers, batched prefill on
   the card (kernels) against the CPU (plain versions);
6. profile: where a full-width prefill's and decode step's time goes
   (torch.profiler: device-busy share and the top device ops);
7. train: full-width, full-depth moe-gpt2 trained through
   ``repro_torch.launch.train`` (B=8, S=1024, condensation with the
   adaptive threshold, AdamW, 6 steps, so the rate bucket switches from
   step 3 on). Losses must be finite, the bucket must switch, and K1
   forward, K1 backward, K2 (every launch through its fused entry), K3
   and K3's backward must have launched as many times as the path calls
   them (the per-layer recompute included),
   and each expert weight tensor must have been cast to bf16 once per
   step (the recompute and the backward read the forward's copy), its
   second bf16 term made once per step by the backward.
   The same run is made again from the same seed and must repeat its
   losses, condensation rates and buckets bit for bit;
8. train parity: one train step of a 2-layer full-width cut (B=2,
   S=256, f32 compute) on the card against the CPU: rep maps, loss and
   gradient norm; the card's step, made twice, repeats every gradient
   bit for bit; then one bf16 step of the same cut on the card, its
   gradients through K1's tensor-core backward against those with the
   backward forced to its FMA kernels (global norm within 1e-2, every
   parameter's cosine >= 0.999);
9. train profile: where one full-width train step's time goes;
10. K4: the dedup wire's pack-quantize kernel (f8 and cast variants) and
    its backward kernel against their plain versions on the card, at the
    expert-parallel train shape (8192 token rows of 768, 4 ranks x 2 nodes
    x 2048 wire slots) and at d=33 with empty slots; bitwise for the
    forward, then timed (CUDA events, profiler device time and the
    wrapper's host time a call) beside the plain version, the PyTorch
    composite (index_select, then the codec) and the byte bound;
11. EP train: full-width, full-depth moe-gpt2 trained expert-parallel over
    4 virtual ranks (2 nodes x 2) through ``repro_torch.launch.train
    --model-axis 4 --comm-mode hier --nodes 2 --hier-dedup on --wire-dtype
    f8e4m3`` (B=8, S=1024, condensation and migration on, 6 steps): the
    shipped-bytes law on every step, exact launch counts of K1 forward and
    backward, K2, K3, K3's backward, K4 and K4's backward, and a second
    run from the same seed bit-equal (losses, rates, buckets and every
    migration perm);
12. EP bf16 wire: the same at ``--wire-dtype bf16`` for 2 steps, which
    launches K4's cast kernel;
13. EP parity: one f32 EP step of a 2-layer full-width cut (B=4, S=256,
    4 ranks) on the card against the CPU: loss, gradient norm, migration
    perms and rep maps;
14. EP profile: where one full-width EP train step's time goes, with the
    host planner's time and the device time of the virtual-rank
    collectives (device-memory permutes, not network transfers) and K4;
15. K5 and K6: flash attention against its plain version at hymba's
    batched-prefill shape ([4,2048,25,64] bf16 on 5 KV heads, window
    1024), causal without a window, non-causal, the tensor-core kernel's
    bf16 edges (ragged S=100, S=1000 with window 1000, S=64, H == KV,
    q x 8, hd 128), bf16 at hd 32 (the FMA kernel) and f32; a second
    launch at the prefill shape bitwise equal to the first; K6's two
    entries, the Mamba scan and its final state against the recurrence,
    and the fused entry (softplus, scan, skip, silu gate, rounding)
    against the mixer's ops one by one, at [4,2048,3200]x16, a ragged
    [2,100,200]x16 and [1,33,70]x8 (fused: f32 within 2e-5, bf16 within
    one bf16 ulp of each element plus the f32 gate, z a strided view);
    then timed (CUDA events and profiler device time for K6) beside the
    plain version, SDPA with the same band mask (K5, in turns) and the
    bounds (K6's with the special-function unit's: one exp per state
    update), with K5's TFLOP/s on live pairs and its share of the bound,
    and K6's resident blocks per SM from the occupancy calculator;
16. hymba serve: full-width hymba-1.5b (32 layers, random weights from a
    seed), the serving engine's batched prefill at B=4, prompt 2048, twice:
    K5 and K6 launched exactly 32 times per prefill, every K6 launch
    through its fused entry; then a 6-layer full-width cut fed a prompt of
    1100 tokens step by step (past the 1024 window) and 32 greedy tokens,
    launching neither; its step-fed and batched last-token logits agree;
17. hymba paths and parity: a 4-layer full-width cut at f32 compute, the
    batched prefill (K5 + K6) against the step feed (attn_decode +
    mamba_step) past the window; reduced hymba at f32 with GQA kept,
    card against CPU;
18. hymba profile: full-width batched prefills, tokens/s over three on
    the host clock, then one under torch.profiler: the top-10 device ops,
    K5's and K6's shares and the device-busy share.
19. EP serve: full-width moe-gpt2 served over 4 virtual ranks through
    ``repro_torch.launch.serve --model-axis 4`` (the run of phase 4
    otherwise: the batched prefill sequence-sharded over the ranks; the
    decode the one-device one, which the reference's all-reduce decode
    equals on virtual ranks): K1 launched exactly 12 x (2 + 128 + 32) =
    1944 times (one launch per MoE sublayer holds every rank's rows) and
    no other kernel, 36 bf16 weight casts, finite logits, the decode's
    tokens and logits bit for bit phase 4's (M = 1, same seed); then
    phase 6's profile over the 4 ranks, and prefill tokens/s, decode
    ms/step and device-busy shares beside M = 1's;
20. EP serve parity: a 2-layer full-width cut over 4 virtual ranks, the
    sequence-sharded prefill and 8 decode steps on the card against the
    CPU, within 3e-2, on a prompt of three token ids that must make some
    rank drop tokens (each rank's and layer's dispatch drop is logged);
21. sequence-sharded train: full-width moe-gpt2 through
    ``repro_torch.launch.train --model-axis 4 --global-batch 6`` (6
    sequences do not split over 4 ranks, so the sequence does;
    condensation and migration off, as in the reference), 2 steps: finite
    losses, K1 and its backward launched exactly as the path calls them
    and nothing else, one bf16 weight cast and second term per expert
    weight tensor a step; then one f32 step of a 2-layer cut (B=2,
    S=256) on the card against the CPU: loss within 1e-4, every gradient
    leaf within 1e-5 by its relative norm error (the worst is logged);
22. reuse and lsh: (a) K2's fused entry restricted to LSH buckets (the
    ``CODES`` instances) against its plain version at 64 groups of
    [128, 768], bf16 and f32, with and without a carried s_prev, codes
    of ``lsh_codes`` at bits 8 and 1: measured entries within 1e-5, the
    rest and the measured fractions bit for bit, a bitwise repeat, no
    ptxas spill in the CODES instances; timed in turns with the exact
    entry (profiler device time) beside the byte bound; (b) phase 11's
    EP run with ``--plan-reuse always --condense-reuse always
    --similarity-backend lsh``: launch counts derived from the step
    records (K2's fused entry 2 x condense_built a step, the greedy
    2 x plans_built), the shipped-bytes law, finite losses, a second run
    from the same seed bit for bit (losses, rep maps, perms); then phase
    14's profile with the same flags, the planner's host time and the
    step's device syncs beside phase 14's; (c) the reuse guarantee at
    full width, condensation off: one forward with zeroed routers,
    ``plan_reuse="signature"`` bit for bit "off" with plans_built 12 ->
    1, then random routers bit for bit with plan_reuse_mismatch 11;
    (d) reduced EP at f32 with always / lsh, card against CPU: LSH
    codes, rep maps, perms and counters equal, loss within 1e-4.
23. paper kernels: phases 3 and 10's checks and timings at the paper
    models' width (d 1024, F 4096, 16 experts): K1 at R = 1024, 512, 8
    and 160 and its backward at R = 1024 and 160, K2's two entries on 32
    groups of [128, 1024], K3 and its backwards on [4096, 1024], K4 (f8,
    cast, backward) at 4 ranks x 1024 tokens of 1024;
24. paper train: moe-transformerxl (18 layers, B=16, S=256, AdamW) and
    moe-bert-large (24 layers, non-causal, B=8, S=512, Adafactor) trained
    at full width and depth through ``repro_torch.launch.train``, 6 steps
    each: exact launch counts of K1 and its backward, K2 (fused), K3 and
    its backward, one bf16 copy and one second term per expert weight a
    step, the peak memory under the card's, finite losses, and a second
    run from the same seed bit for bit (losses, rates, buckets);
25. paper serve: full-width moe-transformerxl through
    ``repro_torch.launch.serve`` (B=8, prompt 256, 16 greedy tokens): K1
    exactly 18 x (2 + 256 + 16) launches and nothing else, one bf16 copy
    per expert weight, finite logits;
26. paper EP: full-width moe-bert-large cut to 4 layers over 4 virtual
    ranks (``--comm-mode hier --nodes 2 --hier-dedup on --wire-dtype
    f8e4m3 --wire-error-feedback --optimizer adafactor``, B=8, S=512, 4
    steps): exact launch counts (K4 and its backward included), the
    shipped-bytes law, the residual buffer nonzero on every step, and a
    second run bit for bit (losses, perms, rep maps, residual buffer);
27. paper parity: one f32 train step of 2-layer full-width cuts of both
    models (B=2, S=256, condensation on) on the card against the CPU: rep
    maps equal, loss within 1e-4, every gradient leaf within 1e-5; one
    Adafactor and one SGD update of the moe-bert-large cut on those
    gradients, card against CPU (parameters and second moments within
    1e-5, Adafactor's bf16 momentum within one bf16 ulp);
28. paper EP parity: one f32 step of reduced moe-bert-large over 4 ranks
    on the f8 dedup wire with error feedback and a carried residual, card
    against CPU: perms and rep maps equal, loss within 1e-4, the
    refreshed residual within 1e-6 on all but the entries whose payload
    crosses an e4m3 rounding boundary between the two (at most 1e-4 of
    the first layer's, half of a later one's), its norm per layer within
    1e-3;
29. paper profile: one train step of each paper model at its phase-24
    shape and optimizer under torch.profiler: device-busy share, top
    device ops, each kernel's share;
30. pipelined executor, K1 at its chunk: K1 at [16, 512, 768] x 3072
    (the dense wire's chunk: 4 ranks x a quarter of the capacity of 512)
    against its plain version and timed as in phase 3; each chunk's rows
    (RMS norm, then K1) bit for bit the same rows of one [16, 2048, 768]
    launch, on both routes, at 4 and 3 chunks;
31. pipelined EP train, dense wire: full-width moe-gpt2 over 4 virtual
    ranks in 2 nodes of 2 (``--comm-mode hier``, no dedup, bf16 rows,
    condensation and migration on) with ``--exec-mode pipeline
    --pipeline-chunks 4``, 2 steps: step 0's loss and forward metrics
    (``local_frac``, traffic, bytes, counters) bit for bit a sync run's
    step 0, exact launches (K1 and its backward once per chunk, the
    recompute too), one bf16 weight copy and second term per expert
    weight a step, a second run bit for bit (losses, perms);
32. pipelined EP train, dedup wire: phase 11's run with ``--exec-mode
    pipeline`` for 2 steps: step 0 bit for bit phase 11's, the
    shipped-bytes law, K1, K4 and their backwards launched as in sync
    (only the node hop is chunked);
33. pipelined EP serve: phase 19's run with ``--exec-mode pipeline``:
    the prefill's logits and the greedy tokens bit for bit phase 19's,
    K1 exactly 12 x (2 x 4 + 128 + 32) launches;
34. pipelined parity: one f32 step of a 2-layer cut of phase 31's
    configuration (B=4, S=256): on the card pipeline bit for bit sync
    (loss, forward metrics); card against CPU: loss within 1e-4, perms,
    rep maps and counters equal, every gradient leaf within 1e-5;
35. pipelined profile: one step of phase 31's configuration, sync and
    pipelined in the same call, under torch.profiler: wall and device
    ms, busy share, the collectives' device ms, the kernels of each
    stream and how much of K1's time the side stream was busy; fails
    unless the pipelined step's collectives ran on a second stream.

36. K1's group map: K1 and its backward with the replica lanes' map at
    [20, 2048, 768] x 3072 over the 16-expert stack against their plain
    versions (idle groups exactly zero), timed beside a launch without a
    map and the concatenated stack;
37. replicate EP train: phase 31's dense-wire run under
    ``--plan-objective replicate`` with every router biased toward expert
    0, 2 steps: live lanes, exact launches, one bf16 copy and second term
    per expert weight a step, a bit-equal repeat, pipelined step 0 bit
    for bit sync's; against "traffic" without condensation a lower drop
    and the same launches; a profiled step of each;
38. replicate parity: one f32 step of a 2-layer cut, card against CPU;
39. overlap EP train: ``--plan-objective overlap --exec-mode pipeline`` at
    the estimate's chunk count, exact launches, a bit-equal repeat;
40. cached serve: ``--plan-cache --precompute-plans`` on one device and
    over 4 ranks, no plan built, bit for bit the uncached run, timed in 6
    alternating rounds;
41. continuous serve: full-width moe-gpt2 through ``repro_torch.launch.
    serve --continuous`` (8 slots, prompt 64, 32 tokens, 24 requests in
    bursts of 3 every 4 steps) with ``--metrics-json`` and ``--trace-out``:
    every request finishes, at least 16 admissions into a recycled slot,
    K1 exactly 12 launches a model call and no other kernel, 36 bf16
    weight casts, a ``serve/*`` record and a ``decode`` span a model call
    in a valid Chrome trace, requests 0-7 bit for bit the fixed batch of
    the same 8 prompts; untraced, uncached and with a warm plan cache (no
    plan built, tokens bit for bit): tokens/s, the SLO means (queue,
    TTFT, TPOT), ms a model call, the untraced run's device syncs a
    model call beside one decode step's; one profiled window of the loop
    on a short run of its own (the first 8 requests; device-busy share);
42. recycled slot: a slot recycled by ``admit_slot`` decodes bit for bit
    as a fresh cache's, full-width moe-gpt2 with global attention and with
    a window of 48 that the warm-up wraps, and a 4-layer full-width hymba
    cut (its Mamba rows zeroed);
43. traced EP train: phase 11's run with ``--trace-out --metrics-json
    --log-file``: losses, rates, buckets and perms bit for bit phase 11's
    untraced run; every exchange phase span once per MoE sublayer forward
    (none from the recompute); ``exchange`` covering ``dispatch``,
    ``expert_ffn`` and ``combine``; ``residual/step/*`` records from step
    4 on; the untraced step's device syncs (phase 14) logged;
44. checkpoint: one train step of a 2-layer full-width cut with
    ``--ckpt``, restored onto the card bit for bit;
45. calibration: ``repro_torch.obs.calibrate.run_calibration`` on the
    card over 4 virtual ranks (2 nodes of 2; its collectives are copies
    in device memory): every fitted constant finite and within the
    rails, K1 and K2 each launched 4 times by the FFN and similarity
    probes (their counters), a second call loading the artifact and
    launching neither, ``force=True`` measuring again; the fit, K1's and
    K2's probe times logged beside the card's name and power limit;
46. calibrated, autotuned EP train: full-width moe-gpt2 over 4 virtual
    ranks (``--model-axis 4 --nodes 2 --calibrate --autotune`` on phase
    45's directory), 3 steps: the fit loaded, finite losses, the knobs
    equal to ``autotune_config`` recomputed from phase 45's fit, the
    run_info flags set; the modeled step beside the measured median, and
    the default knobs' modeled and measured beside them;
47. traced probe: phase 46's run, 1 step, under ``--trace-out``: one
    ``probe_exchange`` span on device 0 and a residual record of the
    probe's expert FFN against the calibrated speed;
48. tuned serve and dry run: full-width moe-gpt2 served over 4 ranks
    with ``--autotune`` and an explicit ``--exec-mode pipeline``, tokens
    and prefill logits bit for bit the run given those knobs explicitly;
    ``repro_torch.launch.dryrun`` priced on phase 45's artifact, its
    ``calibration`` key set and the reference's ledger key sets.

49. item 8.1 kernels: K5 at the prefill shapes of olmoe-1b-7b
    ([4,2048,16,128] on 16 KV heads), yi-34b ([2,2048,56,128] on 8),
    stablelm-12b ([4,2048,32,160] on 8), starcoder2-15b ([1,8192,48,128]
    on 4, window 4096) and gemma3-12b ([2,4096,16,256] on 8, window 1024
    and global), bf16, against its plain version one KV head group at a
    time (3e-2 elementwise and 1e-2 of each query row's norm), a second
    launch bit for bit, timed (CUDA events,
    profiler device time) beside the plain version, SDPA with the same
    band and the bound; K5 at hd 160 and 256 on short ragged S, bf16 and
    f32 (2e-5, and 1e-4 of a row); K1 at olmoe's widths (64 experts, d 2048, F 1024) at its
    prefill capacity of 1280 rows and a decode's 8, as phase 3 checks and
    times it (silu); K1 at the calibration probe's [1,512,256]x1024 beside
    a bf16 bmm;
50. item 8.1 serve: olmoe-1b-7b (16 layers), yi-34b (60), stablelm-12b
    (40), starcoder2-15b (40) and gemma3-12b (48) at full width and
    depth, random weights from a seed, bf16 compute: two batched
    prefills (B=4 x 2048; yi B=2 x 2048; starcoder2 B=1 x 8192, its
    4096 window biting; gemma3 B=2 x 4096) with every counter set to 0
    just before and read just after (K5 once a layer a prefill, olmoe's
    K1 once a MoE sublayer, nothing else), then 32 greedy tokens from the
    cache the prefill's K / V fill (K1 once a MoE sublayer a step, no
    K5): finite logits, prefill tokens/s, decode ms/step, peak memory,
    each model freed before the next; then ``repro_torch.launch.serve
    --num-layers`` on a one-period cut of each (prompt 64, 4 tokens) with
    exact launches;
51. item 8.1 parity: each arch's full-width cut of one layer period
    (gemma3 6 layers, the others 2) at prompt 256 and 8 greedy tokens,
    the card (K5, K1) against the CPU (attend, plain versions): prefill
    logits within 3.2e-2 (one bf16 ulp of a logit in [4, 8), 3.125e-2,
    is over the serve gate of 3e-2), greedy tokens equal; and gemma3's
    local and global layer, one each, at a prompt of 3072 (the CPU's
    streaming path against K5). First, the decode cache that phases 50
    and 51 build from the prefill's K / V against the launcher's, fed the
    prompt a token a step (gemma3, full width, a local layer whose ring
    the prompt wraps and a global one, f32): positions equal, K / V and
    the next logits within 1e-4;
52. olmoe EP serve: olmoe cut to 4 layers through the launcher at M = 1
    and over 4 virtual ranks (16 experts a rank): exact launches, the
    decode's logits and tokens bit for bit M = 1's;
53. olmoe train: olmoe-1b-7b at full width cut to 4 layers through
    ``repro_torch.launch.train`` (B=4, S=1024, condensation, AdamW, 3
    steps): finite losses, K1 and its backward, K2 (fused), K3 and its
    backward launched exactly as the path calls them, step ms, peak
    memory, a second run bit for bit;
56. slice 18 kernels: K1 on one llama4-maverick MoE layer's bf16 expert
    stack (128 experts, d 5120, F 8192: 5.37e9 elements a tensor) at the
    prefill's 192 rows an expert and a decode's 8, bf16 h and weights,
    against its plain version one expert at a time (5e-2), bit for bit
    repeated, no weight cast; K5 folded for a chunked-local layer (chunk
    8192; 40 heads on 8 KV heads, hd 128) at S 16384 (one launch) and
    9192 (two: a tail of 1000), and at internvl2's [4,2048,16 on 8,128],
    against the plain version of the layer's function (3e-2, and 1e-2 of
    a row); each timed beside a bf16 bmm or SDPA with the same mask and
    its bound;
57. slice 18 serve: llama4 at full width cut to 2 chunked-local layers
    (B=1 x 16384) and internvl2-2b at full width and depth (B=4 x 256
    prefix slots + 1792 tokens, through ``prefill(prefix=)``), as phase
    50 serves (two prefills, 32 greedy tokens from the prefill's cache):
    exact launches (K5 once a layer a prefill; llama4's K1 once a MoE
    sublayer a prefill and a step), finite logits, tokens/s, ms/step,
    peak memory (llama4's under 80e9 B); then internvl2 through the
    launcher's text path at B=4 x 2048, cut to 2 layers;
58. slice 18 parity: reduced llama4 over one period (chunk 64) at
    prompts of 256 and 200 (a tail), f32 compute, prefill logits within
    1e-4 (its bf16 run recorded: two correct attention cores already
    differ there by more than the bf16 gate), and internvl2 at full
    width cut to 2 layers with a 256-slot prefix before 256 tokens, bf16,
    within 3.2e-2: the card against the CPU, 8 greedy tokens equal, K5
    as counted;
59. llama4 EP serve: llama4 at full width cut to 1 layer through the
    launcher (B=4 x 256) at M = 1, over 4 virtual ranks (32 experts a
    rank) and over 4 under ``--exec-mode decode_overlap``: exact
    launches, the decode bit for bit M = 1's, decode_overlap bit for bit
    sync;
60. slice 19 kernels: K5 at seamless-m4t-large-v2's shapes (16 heads
    of 64) without a mask and at Sq != Sk: the encoder's [4,2048]
    non-causal, the decoder's causal, the cross layers' [4, 2048 q,
    2048 k] and the ragged [4, 2048 q, 1000 k] and [2, 100 q, 3000 k],
    bf16 (tensor cores) and f32 (FMA kernel), against the plain version
    (3e-2 / 2e-5 elementwise, 1e-2 / 1e-4 of each query row), a second
    launch bit for bit, timed beside SDPA with the same mask and the
    bound;
61. slice 19 serve: seamless-m4t-large-v2 at full width and depth (24
    encoder + 24 decoder layers) through ``prefill(enc_input=)``, B=4 x
    2048 tokens over 2048 encoder frames: K5 exactly 72 times a prefill
    (24 encoder and 24 cross layers non-causal, 24 self-attention
    causal), prefill tokens/s, 32 greedy tokens from the cache the
    prefill's self and cross K/V fill (ms a step, no K5), peak memory;
    then the launcher at full depth (B=4, prompt 64 fed a token a step,
    8 tokens) with exact launches;
62. slice 19 parity: reduced seamless (2 + 2 layers) at a prompt of 256
    over 300 encoder frames (cross at Sq != Sk on K5), card against CPU
    at f32: prefill and decode logits within 1e-4, 8 greedy tokens
    equal; bf16 recorded.

63. RWKV-6 kernel: K7 (``csrc/wkv6.cu``, the WKV6 recurrence of
    RWKV-6's time-mix) against its plain version at rwkv6-3b's prefill
    [4,2048,40,64] from the zero state and a random one, a decode step's
    [4,1,40,64] and [1,1,40,64] from a random state, a ragged
    [2,1000,4,64], S = 15, 16, 17 and 35 at the edges of K7's 16-step
    chunk and 167 heads that leave the last wave of blocks partial: y
    within 2e-5 of each row's norm over the head and the final state
    within 2e-5 of each head's state norm, a second launch bit for bit;
    at the prefill from the zero state also y within 2e-5 of an f64
    recurrence; 67 chained launches at S = 1 ([1,67,40,64], each from the
    state the last returned, as the decode step carries it) bit for bit
    one launch over S; grad mode through K7's autograd function; no
    spill (phase 2); each
    case timed (CUDA events, profiler device time) beside the plain
    version and the bound;
64. RWKV-6 serve: rwkv6-3b at full width and depth (32 layers, random
    weights from a seed): two batched prefills of B=4 x 2048 with K7
    exactly 32 launches a prefill and nothing else (no K5), tokens/s,
    peak memory; the decode cache built by the step feed of a 64-token
    prompt and 32 greedy tokens, K7 exactly 32 launches a step, ms a
    step; the step-fed last logits within 0.125 (four bf16 ulps of a
    logit in [4, 8)) of the batched prefill of the same 64 tokens, its
    greedy tokens equal up to ties within that gate, and within 1e-4 at
    f32 on a 4-layer cut, tokens equal; a profiled prefill and decode
    step; a slot recycled by ``admit_slot`` (its WKV6 state and token
    shifts zeroed) bit for bit a fresh cache's; then the launcher (B=4,
    prompt 64, 8 tokens) and a short ``--continuous`` run (4 requests
    through 2 slots), each with exact launches;
65. RWKV-6 parity: reduced rwkv6 (2 layers, d 256) at a prompt of 64,
    the prompt's step feed and 8 greedy tokens, card against CPU: at f32
    logits within 1e-4 and tokens equal, K7 once a layer a prefill and a
    step on the card; at bf16 logits within 3.2e-2.
66. K7's backward (``csrc/wkv6_bwd.cu``) against its plain version
    (``ref.wkv6_scan_bwd_ref``) at rwkv6-3b's train shape
    [4,2048,40,64] from the zero state, [1,2048,40,64] from a random
    state with a cotangent on the final state (dS0), a ragged
    [2,1000,4,64], 87 heads (a partial last round of blocks), one
    (batch, head) (one cluster) and S = D - 1, D, D + 1, C + 1, 2 C + 3
    of the built design: dr, dk, dv, dw, du and dS0 each within 1e-4 of
    its norm, a second call bit for bit, each checkpoint (every
    ``BWD_CHUNK`` steps) K7's state over the same prefix bit for bit; at
    [1,2048,40,64] also against an f64 autograd through the plain
    forward (the f32 plain version's own error beside it); timed beside
    the plain version and the bound, the train shape's device time by
    kernel; no spill (phase 2);
67. dense training: rwkv6-3b, internvl2-2b (a prefix of 256 slots and
    1792 tokens) and seamless-m4t-large-v2 (2048 encoder frames) at full
    width and depth through ``repro_torch.launch.train`` (AdamW, 3 steps,
    B=4 x 2048, seed 0): finite losses, step ms, tokens/s, peak memory;
    rwkv6's K7 forward exactly 2 x 32 launches a step (with the remat
    recompute) and its backward 32 calls a step (three kernels a call),
    K1-K6 never launched, K7 never in the other two; rwkv6 again from
    the same seed under torch.profiler, its losses bit for bit and K7's
    share of the step's device time;
68. dense train parity: reduced rwkv6 (2 layers, d 256), one f32 train
    step on the card against the CPU: loss within 1e-5, every gradient
    leaf within 1e-4 of its norm, K7 and its backward once a layer on
    the card and never on the CPU.

Two phases run only when named by ``--only``:

54. K5's gate against a wrong K5: ``csrc/flash_attn.cu`` built again
    with the tensor-core kernel's band starting one 64-key tile late
    (its first live tile left out) and held to phase 49's gates at the
    windowed arch shapes (starcoder2's 4096, gemma3's 1024): the row
    gate must reject it (and the real kernel pass);
55. prefill on K5 against ``attend``: the serve prefill of moe-gpt2 (12
    layers, B=8 x 128), moe-transformerxl (18, B=8 x 256) and olmoe cut
    to 4 layers (B=4 x 2048) with its attention core on K5 and on
    ``attend`` (the engine's own, ``flash_takes`` answering no), in
    alternating rounds: wall ms, profiler device ms, K5's device ms and
    the logits' largest difference, bf16 and at f32 compute.

Since slice 17 every decoder's batched prefill on the card attends on
K5 wherever K5 takes the mask (causal or a window): phases 4, 19, 25 and
33 count its launches (once a layer a prefill), phase 5 holds the card's
K5 prefill against the CPU's ``attend`` at 3e-2.

Phase 23 runs right after phase 10, then phases 49-53, 56-59, 60-62,
63-65 and 66-68, and
phases 30-32,
34 and 35 after phase 14, where the profiler still records every launch;
phase 33 runs after phase 19, phases 36-48 after phase 35. Then one JSON
line with every kernel's record (the paper width's as
``<kernel>@d1024``, K1 at the pipeline's chunk as ``expert_ffn@chunk``,
with the lane map as
``expert_ffn@lanes`` and ``expert_ffn_bwd@lanes``, K5 at each item-8.1
arch's prefill as ``flash_attention@<arch>``, K1 at olmoe's as
``expert_ffn@olmoe-1b-7b``, K1 at llama4's prefill and decode as
``expert_ffn@llama4-prefill`` / ``-decode``, K5 folded for llama4's
chunked layers as ``flash_attention@llama4-chunked-<S>`` and at
internvl2's prefill as ``flash_attention@internvl2-2b``, K5 at
seamless's shapes as ``flash_attention@seamless-m4t-large-v2-<case>-
<dtype>``, K7 as ``wkv6_scan``, its backward as ``wkv6_scan_bwd``; K1's
launches on
every serve and train path of the run, the continuous one included, and
K1's and K2's in the calibration probes), and last ``{"ok": true,
"device": {...}}``. Exits non-zero, printing no result, without a CUDA
device or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# special-function unit (ex2, lg2, rcp): 16 results per clock per SM on
# sm_90, one eighth of the FMA rate; the clock is the card's maximum SM
# clock, read by phase 1
SMS = 132
SFU_PER_CLK_SM = 16
CARD = {}

# K1 at the shapes of the serve run below: B=8 x S=128 prefill gives
# C=256 rows per expert, a decode step of B=8 gives C=8; R=160 is ragged;
# the train run's B=8 x S=1024 gives C=2048 at bucket 0.
E, D, F_ = 16, 768, 3072
K1_SHAPES = {"prefill": 256, "decode": 8, "ragged": 160, "train": 2048}
K1_TOL = {"float32": 1e-4, "bfloat16": 5e-2}

# K1 backward at the train path's shapes: B=8 x S=1024 gives C=2048 rows
# per expert at bucket 0; R=8 is decode-like, R=160 ragged.
K1_BWD_SHAPES = {"train": 2048, "decode": 8, "ragged": 160}
# ... and d, F multiples of 64 but not of 128 (half tiles), E=4, R=160
K1_BWD_NARROW = (4, 160, 192, 320)
# the tensor-core backward against its rounding model
# (ref.expert_ffn_bwd_bf16_ref): f32 sums in another order, and a P, DU
# or DG entry that rounds to the other side of a bf16 tie; a share of
# each tensor's largest entry
K1_BWD_MODEL_TOL = 1e-2
# K2 at full width: 64 groups of G=128 tokens (B=8 x S=1024); K3 gathers
# the 8192 token rows. K3's backward sums them into the representatives:
# at the train run's condensation rate (~0.93) a group of 128 keeps ~9.
K2_GROUPS, K2_G = 64, 128
K3_T = 8192
K3_REPS_PER_GROUP = 9
K2_TOL = 1e-5          # f32 sums of the same rows in another order
K2_S1, K2_S2 = 0.8, 0.2   # the skip rules' thresholds (LuffyConfig's)

TRAIN_ARGS = ["--arch", "moe-gpt2", "--steps", "6", "--global-batch", "8",
              "--seq-len", "1024", "--device", "cuda", "--seed", "0"]
TRAIN_PARITY = dict(B=2, S=256, layers=2)

EP_FLAGS = ["--model-axis", "4", "--comm-mode", "hier", "--nodes", "2",
            "--hier-dedup", "on"]
EP_ARGS = (TRAIN_ARGS + EP_FLAGS + ["--wire-dtype", "f8e4m3"])
EP_BF16_ARGS = ["--arch", "moe-gpt2", "--steps", "2", "--global-batch", "8",
                "--seq-len", "1024", "--device", "cuda", "--seed", "0"] \
    + EP_FLAGS + ["--wire-dtype", "bf16"]
EP_PARITY = dict(B=4, S=256, layers=2, M=4, nodes=2)
# K4 at the EP train shape: 4 ranks x 2048 tokens of 768, top-2 routing
# over 16 experts (4 per rank, 2 nodes of 2 ranks), a third of the tokens
# kept (condensation drops the rest, as at the first steps)
K4_M, K4_N, K4_T, K4_KEEP = 4, 2, 2048, 0.35

# hymba-1.5b's batched prefill: K5 at [4,2048,25,64] on 5 KV heads with a
# 1024 window, K6 at [4,2048,3200] x 16
# hymba-1.5b's batched prefill at full depth: K5 at [4,2048,25,64] on 5
# KV heads with a 1024 window, K6 at [4,2048,3200] x 16; the step feed
# (a 2048-step feed at 32 layers took 184-297 s) at a full-width cut of
# 6 layers, on a prompt past the window, then 32 greedy tokens
HYMBA_PREFILL = dict(B=4, S=2048)
HYMBA_FEED = dict(S=1100, gen=32, layers=6)
K5_SHAPE = (4, 2048, 25, 5, 64)           # B, S, H, KV, hd
K5_WINDOW = 1024
K6_SHAPE = (4, 2048, 3200, 16)            # B, S, di, N
# K6 (both entries): hymba's prefill, a ragged S and di, N = 8
K6_CASES = {"prefill": K6_SHAPE, "ragged": (2, 100, 200, 16),
            "n8": (1, 33, 70, 8)}
K5_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# ... and per query row, ||got - want|| / ||want|| over the head dim. At
# a long S a row's softmax spreads over thousands of keys and its outputs
# are ~0.02-0.05, the size of the elementwise gate; the row's norm scales
# with them. bf16: the output rounded on each side and P rounded to bf16
# before P V, a few 1e-3; a 64-key tile left out of a band of 1024 keys
# moves a row by ~0.25 (phase 54 holds a K5 with such a band to it).
K5_ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# (name, (B, S, H, KV, hd), dtype, causal, window, q scale). bf16 at hd 64
# and 128 runs the tensor-core kernel, the rest the FMA kernel. The
# tensor-core kernel's edges: a ragged S, a window edge not aligned to a
# 128-key tile, S under one query tile, H == KV, logits of tens (q x 8).
K5_CASES = (
    ("prefill", K5_SHAPE, "bfloat16", True, K5_WINDOW, 1.0),
    ("causal", K5_SHAPE, "bfloat16", True, None, 1.0),
    ("noncausal", (2, 512, 25, 5, 64), "bfloat16", False, None, 1.0),
    ("ragged_w30", (2, 100, 25, 5, 64), "bfloat16", True, 30, 1.0),
    ("s1000_w1000", (2, 1000, 25, 5, 64), "bfloat16", True, 1000, 1.0),
    ("s64", (2, 64, 25, 5, 64), "bfloat16", True, None, 1.0),
    ("h_eq_kv", (2, 300, 8, 8, 64), "bfloat16", True, 100, 1.0),
    ("q_x8", (2, 512, 25, 5, 64), "bfloat16", True, 200, 8.0),
    ("hd128", (2, 1024, 8, 2, 128), "bfloat16", True, 300, 1.0),
    ("hd32_fma", (2, 100, 4, 2, 32), "bfloat16", True, 30, 1.0),
    ("ragged_f32", (2, 100, 25, 5, 64), "float32", True, 30, 1.0),
    ("noncausal_f32", (2, 100, 4, 2, 64), "float32", False, None, 1.0))
K6_TOL = 2e-5
# phase 16's bf16 cut: the batched prefill (K5's softmax weights
# rounded to bf16 before normalising, the conv as a sum of bf16
# products) and the step feed (normalised bf16 softmax weights in
# attn_decode, the conv as an einsum) round bf16 at other points
# (through all 32 layers: 8 bf16 ulps of logits in [4, 8)). The
# algorithm is held at f32 by HYMBA_PATHS_TOL.
HYMBA_FEED_TOL = 0.25
# f32 compute: the same sums in another order (CPU, reduced: 2e-6)
HYMBA_PATHS = dict(B=2, S=1100, layers=4)
HYMBA_PATHS_TOL = 1e-3
HYMBA_PARITY_TOL = 1e-4

SERVE_ARGS = ["--arch", "moe-gpt2", "--batch", "8", "--prompt-len", "128",
              "--gen", "32", "--prefill", "batch", "--device", "cuda",
              "--seed", "0"]
PARITY_TOL = 3e-2
# expert-parallel serving over 4 virtual ranks (sequence-sharded prefill;
# the decode is the one-device one), the same run as SERVE_ARGS otherwise
EP_SERVE_ARGS = SERVE_ARGS + ["--model-axis", "4"]
EP_SERVE_PARITY = dict(B=2, S=64, steps=8, layers=2, M=4)
# the sequence-sharded train shape: 6 sequences do not split over 4 ranks
SEQ_TRAIN_ARGS = ["--arch", "moe-gpt2", "--steps", "2", "--global-batch",
                  "6", "--seq-len", "1024", "--model-axis", "4", "--device",
                  "cuda", "--seed", "0"]
SEQ_TRAIN_PARITY = dict(B=2, S=256, layers=2, M=4)
# f32: every gradient leaf's relative norm error, card against CPU
SEQ_TRAIN_GRAD_TOL = 1e-5
# plan reuse, condense reuse and the lsh backend on the EP train run
REUSE_FLAGS = ["--plan-reuse", "always", "--condense-reuse", "always",
               "--similarity-backend", "lsh"]
EP_REUSE_ARGS = EP_ARGS + REUSE_FLAGS
REUSE_PARITY = dict(B=8, S=128, layers=3, M=4, nodes=2)
# the paper's other two models (Table II) at full width: moe-transformerxl
# at S=256 (Table II's 250 is no multiple of the condensation group of
# 128, so condensation, and with it K2 and K3, would be off),
# moe-bert-large at S=512 under Adafactor (AdamW's f32 moments and K1's
# bf16 weight terms do not fit its 5.0e9 parameters on 80 GB)
PAPER_D, PAPER_F = 1024, 4096
PAPER_T = 4096                   # tokens a train step: 16 x 256, 8 x 512
PAPER_EP_T = 1024                # tokens a rank: 8 x 512 over 4 ranks
# K1 at the paper paths' rows per expert: the train step's capacity at
# bucket 0 (4096 tokens), the served prompt's (8 x 256), a decode step
# of 8, and a ragged R
PAPER_K1_R = {"train": 1024, "prefill": 512, "decode": 8, "ragged": 160}
PAPER_K1_BWD_R = {"train": 1024, "ragged": 160}
TXL_TRAIN_ARGS = ["--arch", "moe-transformerxl", "--steps", "6",
                  "--global-batch", "16", "--seq-len", "256",
                  "--optimizer", "adamw", "--device", "cuda", "--seed", "0"]
BERT_TRAIN_ARGS = ["--arch", "moe-bert-large", "--steps", "6",
                   "--global-batch", "8", "--seq-len", "512",
                   "--optimizer", "adafactor", "--device", "cuda",
                   "--seed", "0"]
TXL_SERVE_ARGS = ["--arch", "moe-transformerxl", "--batch", "8",
                  "--prompt-len", "256", "--gen", "16", "--prefill", "batch",
                  "--device", "cuda", "--seed", "0"]
BERT_EP_ARGS = ["--arch", "moe-bert-large", "--num-layers", "4", "--steps",
                "4", "--global-batch", "8", "--seq-len", "512",
                "--optimizer", "adafactor", "--device", "cuda", "--seed",
                "0"] + EP_FLAGS + ["--wire-dtype", "f8e4m3",
                                   "--wire-error-feedback"]
PAPER_PARITY = dict(B=2, S=256, layers=2)
PAPER_EP_PARITY = dict(B=8, S=128, layers=2, M=4, nodes=2)
# the pipelined executor (exec_mode="pipeline"): 4 chunks of the EP train
# capacity of 512 (2048 tokens a rank), so K1 runs at R = 4 x 128 rows;
# the dense wire (hier, no dedup, rows at the compute dtype) for 2 steps,
# phase 11's f8 dedup wire for 2, phase 19's EP serve run
SCHED_CHUNKS = 4
SCHED_FLAGS = ["--exec-mode", "pipeline", "--pipeline-chunks",
               str(SCHED_CHUNKS)]
SCHED_CAPACITY = 512
SCHED_K1_R = 4 * SCHED_CAPACITY // SCHED_CHUNKS
DENSE_EP_ARGS = ["--arch", "moe-gpt2", "--steps", "2", "--global-batch", "8",
                 "--seq-len", "1024", "--device", "cuda", "--seed", "0",
                 "--model-axis", "4", "--comm-mode", "hier", "--nodes", "2"]
SCHED_DEDUP_ARGS = EP_ARGS + ["--steps", "2"]
SCHED_PARITY = dict(B=4, S=256, layers=2, M=4, nodes=2)
SCHED_GRAD_TOL = 1e-5
# a train step's forward metrics, which pipeline holds bit for bit to sync
FWD_KEYS = ("loss", "aux_loss", "dispatch_drop", "combine_drop",
            "condense_rate", "local_frac", "traffic_before", "traffic_after",
            "inter_bytes_flat", "inter_bytes_dedup", "inter_bytes_shipped",
            "plans_built", "plans_reused", "plan_reuse_mismatch",
            "measured_pairs", "condense_built", "condense_reused", "bucket",
            "capacity")


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn`` (every kernel, copy and memset it
    launched), from torch.profiler: what a call costs the card, where the
    CUDA-event time of back-to-back calls may be the host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    if not rows:
        # late in a long process the profiler can record no launch at
        # all; the card's time is then the events' over the same calls
        ms = start.elapsed_time(end) / n
        log(f"    profiler: no launch recorded in {n} calls; CUDA events "
            f"{ms:.4f} ms a call instead")
        return ms
    return _per_call_ms(rows, n)


def _host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` over calls that are not synchronised
    (a wrapper's own cost while the card keeps up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _per_call_ms(rows, n: int) -> float:
    """Device ms per call from the profiler's (us, name, count) rows of n
    calls: each kernel's mean duration times its launches per call. The
    profiler can record fewer launches than were made (seen in a long
    process); a mean over the recorded ones does not count the missing
    ones as zero."""
    for _, key, c in rows:
        if c % n:
            log(f"    profiler: {c} launches of {key[:50]} recorded in {n} "
                f"calls")
    return sum(d / c * max(1, round(c / n)) for d, _, c in rows) / 1e3


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"device: {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi[0])
    CARD["smi"] = smi[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD["sm_clock_hz"] = float(clk) * 1e6
    log(f"max SM clock {clk} MHz: special-function rate "
        f"{SMS * SFU_PER_CLK_SM * CARD['sm_clock_hz'] / 1e12:.3f} T/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul off, cudnn off (plain versions run in full f32)")
    return name, count, smi[0]


def _ptxas_report(text: str, symbol: str):
    """ptxas -v lines of each entry function whose name holds ``symbol``:
    [{"entry", "registers", "spill_stores", "spill_loads", "target"}]."""
    import re
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for '(\w+)'", line)
        if m:
            cur = (dict(entry=m.group(1), target=m.group(2))
                   if symbol in m.group(1) else None)
            if cur:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"build: {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f}s")
    for name, path in paths.items():
        log(f"  {name}: {path.relative_to(ROOT)}")
        for line in _build.BUILD_LOG.get(name, "(cached)").splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling", "(cached)")):
                log(f"    {line.strip()}")
    tc = {k: _ptxas_report(_build.BUILD_LOG.get(src, ""), sym)
          for k, src, sym in (("K1", "expert_ffn", "ffn_wgmma_kernel"),
                              ("K1_bwd", "expert_ffn_bwd",
                               "bwd_wgmma_kernel"),
                              ("K2", "similarity", "sim_wgmma_kernel"),
                              ("K3", "condense", "gather_kernel"),
                              ("K4", "pack", "pack_quant_kernel"),
                              ("K4_bwd", "pack", "pack_quant_bwd_kernel"),
                              ("K5", "flash_attn", "flash_wgmma_kernel"),
                              ("K6", "mamba_scan", "mamba_scan_kernel"),
                              ("K7", "wkv6", "wkv6_kernel"),
                              ("K7_bwd", "wkv6_bwd", "bwd_kernel"),
                              ("K7_bwd_ckpt", "wkv6_bwd", "ckpt_kernel"),
                              ("K7_bwd_du", "wkv6_bwd", "du_kernel"))}
    for k, reps in tc.items():
        for r in reps:
            log(f"  {k} kernel {r['entry']} for {r['target']}: "
                f"{r.get('registers')} registers, spill stores / loads "
                f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes")
    # K6: the N = 16 instances (hymba's) must not spill; N = 8's are
    # reported
    spills = [r['entry'] for k, reps in tc.items() for r in reps
              if (r.get("spill_stores") or r.get("spill_loads"))
              and not (k == "K6" and "ILi16E" not in r["entry"])]
    if spills:
        raise SystemExit(f"register spills in {spills}")
    return paths, tc


def _widths(arch: str):
    """(experts, d_model, expert d_ff) of ``arch``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff


def _k1_inputs(R: int, h_dtype, gen, arch: str = "moe-gpt2"):
    """K1's inputs: ``arch``'s expert stack from ``moe_init`` and R rows
    per expert."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import moe_init
    cfg = get_config(arch)
    ew = moe_init(gen, cfg, device="cuda")["experts"]
    h = torch.randn((cfg.moe.num_experts, R, cfg.d_model), generator=gen,
                    device="cuda").to(h_dtype)
    return h, ew["w_up"], ew["w_gate"], ew["w_down"]


def _k1_library(h, wu, wg, wd, act):
    """One-call-per-product PyTorch yardstick (torch.bmm, f32 on the
    kernel's own inputs), never used by the port."""
    import torch
    import torch.nn.functional as F
    hf = h.float()
    gt = torch.bmm(hf, wg)
    a = F.gelu(gt, approximate="tanh") if act == "gelu" else F.silu(gt)
    return torch.bmm(a * torch.bmm(hf, wu), wd).to(h.dtype)


def _k1_library_bf16(h, wu, wg, wd, act):
    """The bf16 yardstick: torch.bmm on bf16 h and bf16 weights (cuBLAS on
    the tensor cores), the hidden in bf16; never used by the port."""
    import torch
    import torch.nn.functional as F
    gt = torch.bmm(h, wg)
    a = F.gelu(gt, approximate="tanh") if act == "gelu" else F.silu(gt)
    return torch.bmm(a * torch.bmm(h, wu), wd)


def phase_kernels(arch: str = "moe-gpt2", shapes=K1_SHAPES,
                  act: str = "gelu"):
    """K1 against its plain version at every shape, both h types and
    both activations (f32 weights, as the paths hold them: bf16 h takes
    the tensor-core route through the bf16 weight cache, f32 h the FMA
    route), and bf16 weights passed in directly; then timed at the path's
    setting with a warm cache, in turns with the f32 and bf16 bmm
    yardsticks, and the weight cast on its own. ``arch`` sets the widths
    (its expert stack), ``shapes`` the rows per expert, ``act`` the
    timed activation (the arch's own)."""
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    E, D, F_ = _widths(arch)
    checks = []

    def check(shape, R, h_name, w_name, act, args):
        got = kexp.expert_ffn(*args, act)
        torch.cuda.synchronize()
        want = ref.expert_ffn_ref(*args, act)
        err = (got.float() - want.float()).abs().max().item()
        tol = K1_TOL[h_name]
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        rt = kexp.route(args[0].dtype, args[1].dtype, D, F_)
        checks.append(dict(shape=shape, R=R, h=h_name, w=w_name, act=act,
                           route=rt, max_abs_err=err, tol=tol, ok=ok))
        log(f"  K1 {shape:8s} R={R:4d} h={h_name:8s} w={w_name:8s} {act} "
            f"({rt}): max|err|={err:.3e} tol={tol:g} "
            f"{'ok' if ok else 'FAIL'}")

    for shape, R in shapes.items():
        for h_name in ("bfloat16", "float32"):
            for act in ("gelu", "silu"):
                args = _k1_inputs(R, getattr(torch, h_name), gen, arch)
                check(shape, R, h_name, "float32", act, args)
                del args
        args = _k1_inputs(R, torch.bfloat16, gen, arch)
        args = (args[0], *(w.to(torch.bfloat16) for w in args[1:]))
        check(shape, R, "bfloat16", "bfloat16", "gelu", args)
        del args
        torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"K1 disagrees with its plain version: {bad}")

    timed = {}
    for shape, R in shapes.items():
        # the path's setting: bf16 rows, f32 weights, tanh-gelu; the first
        # call fills the weight cache, the timed ones read it
        args = _k1_inputs(R, torch.bfloat16, gen, arch)
        h, wu, wg, wd = args
        wb = [w.to(torch.bfloat16) for w in (wu, wg, wd)]
        kexp.expert_ffn(*args, act)
        iters = 50 if R <= 8 else 20
        ms, lib_ms, lib16_ms = [], [], []
        for _ in range(2):      # in turns, as in one call
            ms.append(time_ms(lambda: kexp.expert_ffn(*args, act), iters))
            lib_ms.append(time_ms(lambda: _k1_library(*args, act), iters))
            lib16_ms.append(time_ms(lambda: _k1_library_bf16(h, *wb, act),
                                    iters))
        dev_ms = device_ms(lambda: kexp.expert_ffn(*args, act))
        cast_ms = time_ms(lambda: [w.to(torch.bfloat16) for w in
                                   (wu, wg, wd)], iters)
        plain_ms = time_ms(lambda: ref.expert_ffn_ref(*args, act), iters)
        # the bound at bf16 weights (the tensor-core route's operands):
        # h read, out written, each weight read once
        flops = 2.0 * E * R * D * F_ * 3
        io = 2 * h.numel() * h.element_size()
        b16 = _bound(io + sum(w.numel() * 2 for w in wb), flops,
                     BF16_TC_FLOPS)
        b32 = _bound(io + sum(w.numel() * 4 for w in (wu, wg, wd)), flops)
        err = max(c["max_abs_err"] for c in checks if c["shape"] == shape
                  and c["h"] == "bfloat16" and c["act"] == act)
        t = dict(R=R, route=kexp.route(h.dtype, wu.dtype, D, F_),
                 ms=min(ms), ms_runs=ms, device_ms=dev_ms, plain_ms=plain_ms,
                 library_ms=min(lib_ms), library_ms_runs=lib_ms,
                 library_bf16_ms=min(lib16_ms), library_bf16_ms_runs=lib16_ms,
                 cast_ms=cast_ms, **b16,
                 bound_f32_weights_ms=b32["bound_ms"],
                 bound_f32_weights_by=b32["bound_by"], max_abs_err=err)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        timed[shape] = t
        log(f"  K1 {shape:8s} [{E},{R},{D}]x{F_} bf16 h, f32 w, {act} "
            f"({t['route']}): kernel {t['ms']:.4f} ms (runs {ms}; device "
            f"time {dev_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bmm f32 {t['library_ms']:.4f} ms, bmm bf16 "
            f"{t['library_bf16_ms']:.4f} ms; weight cast (not in the kernel's "
            f"time) {cast_ms:.4f} ms; bound at bf16 weights "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['bytes'] / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
            f"{100 * t['bound_share']:.1f}% of it); at f32 weights and f32 "
            f"FMAs {t['bound_f32_weights_ms']:.4f} ms; kernel / bmm f32 "
            f"{t['ms'] / t['library_ms']:.3f}, / bmm bf16 "
            f"{t['ms'] / t['library_bf16_ms']:.3f}")
        del args, h, wu, wg, wd, wb
        torch.cuda.empty_cache()
    return checks, timed


def _act_and_grad(gt, act):
    """act(gt) and act'(gt) in gt's type, through PyTorch's own ops."""
    import torch
    import torch.nn.functional as F
    if act == "gelu":
        with torch.enable_grad():
            g = gt.detach().requires_grad_()
            a = F.gelu(g, approximate="tanh")
            da = torch.autograd.grad(a.sum(), g)[0]
        return a.detach(), da
    s = torch.sigmoid(gt)
    return gt * s, s * (1 + gt * (1 - s))


def _k1_bwd_products(h, wu, wg, wd, dy, act):
    """The backward as eight torch.bmm products and the elementwise terms
    between them, in the inputs' types: a yardstick the port never calls
    (f32 inputs: cuBLAS f32; bf16 inputs: the tensor cores, f32 sums,
    bf16 results)."""
    import torch
    gt, up = torch.bmm(h, wg), torch.bmm(h, wu)
    a, da = _act_and_grad(gt, act)
    dhh = torch.bmm(dy, wd.transpose(1, 2))
    dup, dgt = dhh * a, dhh * up * da
    ht = h.transpose(1, 2)
    dwd = torch.bmm((a * up).transpose(1, 2), dy)
    dwu, dwg = torch.bmm(ht, dup), torch.bmm(ht, dgt)
    dh = torch.bmm(dup, wu.transpose(1, 2)) + torch.bmm(dgt, wg.transpose(1, 2))
    return dh, dwu, dwg, dwd


def _k1_bwd_library(h, wu, wg, wd, dy, act):
    """The f32 yardstick: the products on f32 copies of h and dy and the
    f32 weights."""
    dh, dwu, dwg, dwd = _k1_bwd_products(h.float(), wu, wg, wd, dy.float(),
                                         act)
    return dh.to(h.dtype), dwu, dwg, dwd


def _k1_bwd_plain(h, wu, wg, wd, dy, act):
    """The backward's plain version: autograd through the plain forward."""
    import torch
    from repro_torch.kernels import ref
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (h, wu, wg, wd)]
        out = ref.expert_ffn_ref(*leaves, act)
        return torch.autograd.grad(out, leaves, dy)


def _bound(nbytes, flops, peak=F32_FLOPS):
    """Bound at ``peak`` FLOP/s (f32 outside the tensor cores unless the
    inputs' type says otherwise), with the bf16 tensor-core bound and the
    f32 one beside it."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / peak * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bf16_tc_ms=max(t_bytes, flops / BF16_TC_FLOPS * 1e3),
                bound_f32_ms=max(t_bytes, flops / F32_FLOPS * 1e3))


def _bound_sfu(nbytes, flops, sfu_ops):
    """The bound with the special-function unit's: max(bytes / HBM,
    FMA-pipe FLOPs / 67 TFLOP/s, SFU ops / (SMs x 16 x the max SM
    clock)); ``bound_by`` "operations" where either pipe bounds it."""
    rec = _bound(nbytes, flops)
    t_sfu = sfu_ops / (SMS * SFU_PER_CLK_SM * CARD["sm_clock_hz"]) * 1e3
    rec.update(sfu_ops=sfu_ops, bound_sfu_ms=t_sfu,
               sm_clock_mhz=CARD["sm_clock_hz"] / 1e6,
               bound_fma_ms=flops / F32_FLOPS * 1e3,
               bound_bytes_ms=nbytes / HBM_BPS * 1e3)
    if t_sfu > rec["bound_ms"]:
        rec.update(bound_ms=t_sfu, bound_by="operations")
    return rec


def _k1_narrow_inputs(E_, R, D_, Fw, h_dtype, gen):
    """K1 inputs at other widths, scaled as moe_init scales them."""
    import torch
    h = torch.randn((E_, R, D_), generator=gen, device="cuda").to(h_dtype)
    ws = [torch.randn(s, generator=gen, device="cuda") * sc
          for s, sc in (((E_, D_, Fw), D_ ** -0.5), ((E_, D_, Fw), D_ ** -0.5),
                        ((E_, Fw, D_), Fw ** -0.5 / math.sqrt(24)))]
    return (h, *ws)


def _k1_bwd_timed(h, wu, wg, wd, dy, err):
    """K1's backward at the train shape on its route (the tensor cores) in
    turns with the FMA route (forced through bwd_route), the plain
    version, and the f32 and bf16 bmm composites; its device time; the
    bound at the bf16 tensor-core rate."""
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    args = (h, wu, wg, wd, dy, "gelu")
    wb = [w.to(torch.bfloat16) for w in (wu, wg, wd)]
    route = kexp.bwd_route

    def fma():
        kexp.bwd_route = lambda *a: "fma"
        try:
            return kexp.expert_ffn_bwd(*args)
        finally:
            kexp.bwd_route = route

    kexp.expert_ffn_bwd(*args)            # the weight terms' cache warm
    ms, fma_ms, plain_ms, lib_ms, lib16_ms = [], [], [], [], []
    for _ in range(2):                    # in turns, as in one call
        ms.append(time_ms(lambda: kexp.expert_ffn_bwd(*args), 10, 2))
        fma_ms.append(time_ms(fma, 3, 1))
        plain_ms.append(time_ms(lambda: _k1_bwd_plain(*args), 3, 1))
        lib_ms.append(time_ms(lambda: _k1_bwd_library(*args), 3, 1))
        lib16_ms.append(time_ms(lambda: _k1_bwd_products(
            h, *wb, dy, "gelu"), 10, 2))
    dev_ms = device_ms(lambda: kexp.expert_ffn_bwd(*args), 5)
    E_, R_, D_ = h.shape
    Fw = wu.shape[-1]
    nbytes = (2 * h.numel() * h.element_size()      # h, dy
              + h.numel() * h.element_size()        # dh
              + sum(w.numel() * (w.element_size() + 4)
                    for w in (wu, wg, wd)))         # w, dw
    flops = 8 * 2.0 * E_ * R_ * D_ * Fw
    t = dict(R=R_, route=kexp.bwd_route(h.dtype, wu.dtype, D_, Fw),
             ms=min(ms), ms_runs=ms, device_ms=dev_ms, fma_ms=min(fma_ms),
             fma_ms_runs=fma_ms, plain_ms=min(plain_ms),
             library_ms=min(lib_ms), library_ms_runs=lib_ms,
             library_bf16_ms=min(lib16_ms), library_bf16_ms_runs=lib16_ms,
             **_bound(nbytes, flops, BF16_TC_FLOPS),
             # the hi + lo terms double the products the kernels issue
             bound_issued_ms=2 * flops / BF16_TC_FLOPS * 1e3,
             max_abs_err=err)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    log(f"  K1 bwd [{E_},{R_},{D_}]x{Fw} bf16 h and dy, f32 w, gelu "
        f"({t['route']}): kernel {t['ms']:.4f} ms (runs {ms}; device time "
        f"{dev_ms:.4f} ms), FMA route {t['fma_ms']:.3f} ms, plain "
        f"{t['plain_ms']:.3f} ms, bmm f32 {t['library_ms']:.3f} ms, bmm "
        f"bf16 {t['library_bf16_ms']:.4f} ms (runs {lib16_ms}); bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} at the bf16 tensor-core "
        f"rate ({flops / 1e12:.3f} TFLOP, {100 * t['bound_share']:.1f}% of "
        f"it; the 16 products issued {t['bound_issued_ms']:.4f} ms), "
        f"{t['bound_f32_ms']:.3f} ms at f32 FMA; kernel / bmm f32 "
        f"{t['ms'] / t['library_ms']:.3f}, / bmm bf16 "
        f"{t['ms'] / t['library_bf16_ms']:.3f}")
    return t


def phase_kernels_train(arch: str = "moe-gpt2", bwd_shapes=K1_BWD_SHAPES,
                        narrow=K1_BWD_NARROW, n_tok: int = K3_T):
    """K1 backward, K2, K3 and K3's backward against their plain versions
    at the train path's shapes, then timed beside the plain version, a
    PyTorch yardstick and the bound: K1's backward at ``arch``'s widths and
    ``bwd_shapes`` rows (and the ``narrow`` widths, if given), K2 on
    ``n_tok`` / 128 groups and K3 on ``n_tok`` rows of d_model. Returns
    {kernel: record}."""
    import numpy as np
    import torch
    from repro_torch.kernels import condense as kcond
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import ref
    from repro_torch.kernels import similarity as ksim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    E, D, F_ = _widths(arch)
    n_groups = n_tok // K2_G
    out = {}

    # ---- K1 backward: f32 h takes the FMA route, bf16 h the tensor cores
    # (bwd_route), which is also held to its rounding model and repeated
    checks, timed = [], {}
    shapes = [(name, (E, R, D, F_)) for name, R in bwd_shapes.items()]
    if narrow is not None:
        shapes.append(("narrow", narrow))
    for shape, (E_, R, D_, Fw) in shapes:
        for h_name in ("float32", "bfloat16"):
            h, wu, wg, wd = (_k1_inputs(R, getattr(torch, h_name), gen, arch)
                             if shape != "narrow" else
                             _k1_narrow_inputs(E_, R, D_, Fw,
                                               getattr(torch, h_name), gen))
            dy = torch.randn(h.shape, generator=gen, device="cuda").to(h.dtype)
            rt = kexp.bwd_route(h.dtype, wu.dtype, D_, Fw)
            got = kexp.expert_ffn_bwd(h, wu, wg, wd, dy, "gelu")
            torch.cuda.synchronize()
            want = _k1_bwd_plain(h, wu, wg, wd, dy, "gelu")
            tol = K1_TOL[h_name]
            errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)]
            ok = all(torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
                     for g, w in zip(got, want))
            c = dict(shape=shape, E=E_, R=R, d=D_, F=Fw, h=h_name, route=rt,
                     tol=tol, max_abs_err=max(errs))
            msg = ""
            if rt == "wgmma":
                # the rounding model the CPU tests hold to the reference;
                # 1e-2 of each tensor's largest entry; a bitwise repeat
                model = ref.expert_ffn_bwd_bf16_ref(h, wu, wg, wd, dy, "gelu")
                rel = [(g.float() - m.float()).abs().max().item()
                       / m.float().abs().max().item()
                       for g, m in zip(got, model)]
                again = kexp.expert_ffn_bwd(h, wu, wg, wd, dy, "gelu")
                rep = all(torch.equal(a, b) for a, b in zip(again, got))
                ok = ok and max(rel) <= K1_BWD_MODEL_TOL and rep
                c.update(model_rel_err=max(rel), repeat_bitwise=rep)
                msg = (f"; against its rounding model max|err|/max = "
                       + "/".join(f"{e:.2e}" for e in rel)
                       + f" (tol {K1_BWD_MODEL_TOL:g}), repeats {rep}")
                del model, again
            c["ok"] = ok
            checks.append(c)
            log(f"  K1 bwd {shape:6s} [{E_},{R},{D_}]x{Fw} h={h_name:8s} gelu "
                f"({rt}): max|err| dh/dwu/dwg/dwd = "
                + "/".join(f"{e:.2e}" for e in errs)
                + f" tol={tol:g}{msg} {'ok' if ok else 'FAIL'}")
            if shape == "train" and h_name == "bfloat16":
                timed = _k1_bwd_timed(h, wu, wg, wd, dy, max(errs))
            del h, wu, wg, wd, dy, got, want
            torch.cuda.empty_cache()
    if not all(c["ok"] for c in checks):
        raise SystemExit(f"K1 backward disagrees with its plain version: "
                         f"{[c for c in checks if not c['ok']]}")
    out["expert_ffn_bwd"] = dict(timed, checks=checks)

    # ---- K2: 64 groups of [128, 768]; the mask is the first block's
    # same-expert mask (16 experts), plus whole groups with nothing to
    # measure, whose tiles the kernel skips. bf16 rows take the tensor
    # cores (route "wgmma"), f32 rows the FMA kernel
    r = np.random.default_rng(11)
    top2 = torch.as_tensor(r.integers(0, E, (n_groups * K2_G, 2)),
                           device="cuda")
    expert = top2[:, 0].reshape(n_groups, K2_G)   # the path's strided ids
    mask = expert[:, :, None] == expert[:, None, :]
    mask[::4] = False
    checks, timed = [], {}
    xs = {}
    for x_name in ("float32", "bfloat16"):
        x = torch.randn((n_groups, K2_G, D), generator=gen,
                        device="cuda").to(getattr(torch, x_name))
        xs[x_name] = x
        rt = ksim.route(x.dtype, D)
        got = ksim.masked_similarity(x, mask)
        torch.cuda.synchronize()
        want = ref.masked_similarity_ref(x, mask)
        err = (got - want).abs().max().item()
        skipped_zero = bool(torch.all(got[::4] == 0))
        again = bool(torch.equal(ksim.masked_similarity(x, mask), got))
        ok = err <= K2_TOL and skipped_zero and again
        checks.append(dict(x=x_name, route=rt, max_abs_err=err,
                           repeat_bitwise=again, ok=ok))
        log(f"  K2 [{n_groups}x{K2_G},{D}] x={x_name:8s} ({rt}): max|err|="
            f"{err:.3e} tol={K2_TOL:g}, skipped tiles zero: {skipped_zero}, "
            f"repeats {again} {'ok' if ok else 'FAIL'}")
    if not all(c["ok"] for c in checks):
        raise SystemExit(f"K2 disagrees with its plain version: {checks}")
    # the fused entry (the skip rules in the kernel), as fast_similarity
    # calls it: the first block's s_prev (0.5: every same-expert pair
    # measured) and a carried one with pairs known high and known low,
    # from rows near 16 centres
    xb = xs["bfloat16"]
    centres = torch.randn((E, D), generator=gen, device="cuda")
    cid = torch.as_tensor(r.integers(0, E, (n_groups, K2_G)), device="cuda")
    x0 = centres[cid] + 0.6 * torch.randn((n_groups, K2_G, D),
                                          generator=gen, device="cuda")
    first = torch.full((n_groups, K2_G, K2_G), 0.5, device="cuda")
    carried = ref.masked_similarity_fused_ref(x0, expert, first, K2_S1,
                                              K2_S2)[0].contiguous()
    same = expert[:, :, None] == expert[:, None, :]
    fused_checks = []
    for sp_name, sp in (("first", first), ("carried", carried),
                        ("none", None)):
        for x_name, x in (("bfloat16", xb), ("float32", xs["float32"])):
            sim, frac = ksim.masked_similarity_fused(x, expert, sp, K2_S1,
                                                     K2_S2)
            torch.cuda.synchronize()
            want, wfrac = ref.masked_similarity_fused_ref(x, expert, sp,
                                                          K2_S1, K2_S2)
            measured = same if sp is None else \
                same & ~(sp > K2_S1) & ~(sp < K2_S2)
            exact = bool(torch.equal(sim[~measured], want[~measured]))
            err = (sim[measured] - want[measured]).abs().max().item()
            frac_eq = bool(torch.equal(frac, wfrac))
            again = ksim.masked_similarity_fused(x, expert, sp, K2_S1, K2_S2)
            rep = bool(torch.equal(again[0], sim)
                       and torch.equal(again[1], frac))
            ok = exact and err <= K2_TOL and frac_eq and rep
            fused_checks.append(dict(
                s_prev=sp_name, x=x_name, route=ksim.route(x.dtype, D),
                measured_share=measured.float().mean().item(),
                unmeasured_bitwise=exact, max_abs_err=err,
                measured_frac_bitwise=frac_eq, repeat_bitwise=rep, ok=ok))
            log(f"  K2 fused s_prev={sp_name:7s} x={x_name:8s}: measured "
                f"{measured.float().mean().item():.4f} of the pairs, the "
                f"rest bitwise {exact}, measured max|err|={err:.3e} tol="
                f"{K2_TOL:g}, measured_frac bitwise {frac_eq}, repeats "
                f"{rep} {'ok' if ok else 'FAIL'}")
    if not all(c["ok"] for c in fused_checks):
        raise SystemExit(f"K2's fused entry disagrees with its plain "
                         f"version: {fused_checks}")
    # timed at bf16 (the path's rows), both entries, by profiler device
    # time. The bound counts what this mask needs: the rows of the groups
    # with an entry to measure (a skipped tile loads none), the products
    # of the 64 x 64 tiles with one, all of the mask and the output
    tiles = mask.reshape(n_groups, 2, 64, 2, 64).any(dim=(2, 4))
    n_tiles = int(tiles.sum())
    live_groups = int(mask.any(dim=(1, 2)).sum())
    x = xb
    contract = lambda: ksim.masked_similarity(x, mask)      # noqa: E731
    fused = lambda: ksim.masked_similarity_fused(           # noqa: E731
        x, expert, carried, K2_S1, K2_S2)
    ms = time_ms(contract, 50)
    dev = device_ms(contract, 50)
    f32_dev = device_ms(lambda: ksim.masked_similarity(xs["float32"], mask),
                        20)
    plain_ms = time_ms(lambda: ref.masked_similarity_ref(x, mask), 50)
    nbytes = (live_groups * K2_G * D * x.element_size() + mask.numel()
              + 4 * mask.numel())
    flops = n_tiles * 64 * 64 * D * 2.0        # this run's tiles
    timed = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=None,
                 route=ksim.route(x.dtype, D),
                 tile=ksim.TILES[ksim.route(x.dtype, D)],
                 computed_tiles=n_tiles, live_groups=live_groups,
                 **_bound(nbytes, flops, BF16_TC_FLOPS),
                 device_ms_f32_route=f32_dev,
                 max_abs_err=max(c["max_abs_err"] for c in checks))
    timed["bound_share_device"] = timed["bound_ms"] / dev
    log(f"  K2 bf16 ({timed['route']}, {timed['tile']} tiles): {dev:.4f} ms "
        f"of device time ({100 * timed['bound_share_device']:.1f}% of the "
        f"bound), events {ms:.4f} ms, plain {plain_ms:.4f} ms; f32 route "
        f"{f32_dev:.4f} ms device; {n_tiles} of {tiles.numel()} 64 x 64 "
        f"tiles and {live_groups} of {n_groups} groups live; bound "
        f"{timed['bound_ms']:.4f} ms by {timed['bound_by']} at the bf16 "
        f"tensor-core rate ({nbytes / 1e6:.2f} MB), "
        f"{timed['bound_f32_ms']:.4f} at f32 FMA")
    out["masked_similarity"] = dict(timed, checks=checks)
    # the fused entry at the carried s_prev: rows of the groups with a pair
    # to measure, expert ids, s_prev in, similarity and fractions out
    f_meas = same & ~(carried > K2_S1) & ~(carried < K2_S2)
    f_tiles = int(f_meas.reshape(n_groups, 2, 64, 2, 64)
                  .any(dim=(2, 4)).sum())
    f_groups = int(f_meas.any(dim=(1, 2)).sum())
    f_ms = time_ms(fused, 50)
    f_dev = device_ms(fused, 50)
    f_plain = time_ms(lambda: ref.masked_similarity_fused_ref(
        x, expert, carried, K2_S1, K2_S2), 50)
    f_bytes = (f_groups * K2_G * D * x.element_size() + expert.numel() * 8
               + 4 * carried.numel() + 4 * carried.numel()
               + 4 * n_groups)
    f_flops = f_tiles * 64 * 64 * D * 2.0
    rec = dict(ms=f_ms, device_ms=f_dev, plain_ms=f_plain, library_ms=None,
               route=ksim.route(x.dtype, D),
               tile=ksim.TILES[ksim.route(x.dtype, D)],
               computed_tiles=f_tiles, live_groups=f_groups,
               **_bound(f_bytes, f_flops, BF16_TC_FLOPS),
               max_abs_err=max(c["max_abs_err"] for c in fused_checks))
    rec["bound_share_device"] = rec["bound_ms"] / f_dev
    log(f"  K2 fused (carried s_prev): {f_dev:.4f} ms of device time "
        f"({100 * rec['bound_share_device']:.1f}% of the bound), events "
        f"{f_ms:.4f} ms, plain (the op sequence it replaces) {f_plain:.4f} "
        f"ms; {f_tiles} of {n_groups * 4} 64 x 64 tiles and {f_groups} "
        f"groups live; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
        f"({f_bytes / 1e6:.2f} MB)")
    out["masked_similarity_fused"] = dict(rec, checks=fused_checks)

    # ---- K3: [8192, 768] bf16 rows (the residual stream's type); the
    # path's map is the un-condense map of 64 groups of 128 tokens, each
    # token sent to one of its group's 9 representatives
    reps = np.sort(np.stack([r.choice(K2_G, K3_REPS_PER_GROUP, replace=False)
                             for _ in range(n_groups)]), axis=1)
    pick = r.integers(0, K3_REPS_PER_GROUP, (n_groups, K2_G))
    rep_of = np.take_along_axis(reps, pick, axis=1)
    rep_of[np.arange(n_groups)[:, None], reps] = reps     # reps keep theirs
    idx = torch.as_tensor((rep_of + K2_G * np.arange(n_groups)[:, None])
                          .reshape(-1), device="cuda")
    y = torch.randn((n_tok, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    rand_idx = torch.as_tensor(r.integers(0, n_tok, n_tok), device="cuda")
    exact = {name: bool(torch.equal(kcond.gather_rows(y, ix),
                                    ref.gather_rows_ref(y, ix)))
             for name, ix in (("path_map", idx), ("random_map", rand_idx),
                              ("int32_index", rand_idx.to(torch.int32)))}
    log(f"  K3 [{n_tok},{D}] bf16: bitwise equal to the plain version: "
        f"{exact}")
    if not all(exact.values()):
        raise SystemExit(f"K3 disagrees with its plain version: {exact}")
    ms, lib_ms = [], []
    for _ in range(2):          # in turns, as in one call
        ms.append(time_ms(lambda: kcond.gather_rows(y, idx), 200))
        lib_ms.append(time_ms(lambda: torch.index_select(y, 0, idx), 200))
    plain_ms = time_ms(lambda: ref.gather_rows_ref(y, idx), 200)
    dev = {k: device_ms(f, 50) for k, f in (
        ("device_ms", lambda: kcond.gather_rows(y, idx)),
        ("library_device_ms", lambda: torch.index_select(y, 0, idx)))}
    # the bytes this map needs: each distinct source row read once, every
    # output row written once, the index read
    n_src = int(torch.unique(idx).numel())
    nbytes = (n_src + n_tok) * D * y.element_size() + idx.numel() * 8
    out["gather_rows"] = dict(ms=min(ms), ms_runs=ms, plain_ms=plain_ms,
                              library_ms=min(lib_ms), library_ms_runs=lib_ms,
                              **dev, source_rows=n_src,
                              **_bound(nbytes, 0.0), max_abs_err=0.0,
                              bitwise=exact)
    r3 = out["gather_rows"]
    log(f"  K3 on the path's map ({n_src} source rows): kernel "
        f"{r3['ms']:.4f} ms (runs {ms}), index_select {r3['library_ms']:.4f}"
        f" ms (runs {lib_ms}), plain {plain_ms:.4f} ms by CUDA events; "
        f"device time (profiler) {dev['device_ms']:.4f} ms, index_select "
        f"{dev['library_device_ms']:.4f} ms; bound {r3['bound_ms']:.4f} ms "
        f"by bytes ({nbytes / 1e6:.1f} MB)")

    # ---- K3 backward on the same map
    dy = torch.randn((n_tok, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    got = kcond.gather_rows_bwd(dy, idx, n_tok)
    torch.cuda.synchronize()
    # on the CPU the plain version adds in index order, as the kernels
    # do: bitwise; on the card it adds with atomics: within f32
    # reassociation, rounded once to bf16
    exact = bool(torch.equal(got.cpu(), ref.gather_rows_bwd_ref(
        dy.cpu(), idx.cpu(), n_tok)))
    want = ref.gather_rows_bwd_ref(dy, idx, n_tok)
    err = (got.float() - want.float()).abs().max().item()
    ok_card = torch.allclose(got.float(), want.float(), atol=1e-5,
                             rtol=8e-3)
    again = bool(torch.equal(kcond.gather_rows_bwd(dy, idx, n_tok), got))
    log(f"  K3 bwd [{n_tok},{D}] bf16, {K3_REPS_PER_GROUP} reps per group of "
        f"{K2_G}: bitwise equal to the plain version on the CPU: {exact}; "
        f"against it on the card max|err|={err:.3e} (tol 8e-3 rel) "
        f"{'ok' if ok_card else 'FAIL'}; a second launch repeats: {again}")
    if not (exact and ok_card and again):
        raise SystemExit("K3 backward disagrees with its plain version")
    # the group-local entry the path takes (the map is group-local):
    # bit for bit the general entry, the CPU plain version and itself
    got_g = kcond.gather_rows_bwd(dy, idx, n_tok, K2_G)
    torch.cuda.synchronize()
    same_g = dict(general=bool(torch.equal(got_g, got)),
                  cpu_plain=bool(torch.equal(got_g.cpu(), got.cpu()))
                  and exact,
                  repeat=bool(torch.equal(
                      kcond.gather_rows_bwd(dy, idx, n_tok, K2_G), got_g)))
    log(f"  K3 bwd grouped (G={K2_G}): bitwise equal to {same_g}")
    if not all(same_g.values()):
        raise SystemExit(f"K3's grouped backward differs: {same_g}")
    ms, gen_ms, lib_ms = [], [], []
    for _ in range(2):          # in turns, as in one call
        ms.append(time_ms(lambda: kcond.gather_rows_bwd(dy, idx, n_tok, K2_G),
                          100))
        gen_ms.append(time_ms(lambda: kcond.gather_rows_bwd(dy, idx, n_tok),
                              100))
        lib_ms.append(time_ms(lambda: dy.new_zeros((n_tok, D)).index_add_(
            0, idx, dy), 100))
    plain_ms = time_ms(lambda: ref.gather_rows_bwd_ref(dy, idx, n_tok), 100)
    dev = {k: device_ms(f, 50) for k, f in (
        ("device_ms", lambda: kcond.gather_rows_bwd(dy, idx, n_tok, K2_G)),
        ("general_device_ms", lambda: kcond.gather_rows_bwd(dy, idx, n_tok)),
        ("library_device_ms", lambda: dy.new_zeros((n_tok, D)).index_add_(
            0, idx, dy)))}
    nbytes = 2 * dy.numel() * dy.element_size() + idx.numel() * 8
    out["gather_rows_bwd"] = dict(ms=min(ms), ms_runs=ms,
                                  general_ms=min(gen_ms),
                                  general_ms_runs=gen_ms, plain_ms=plain_ms,
                                  library_ms=min(lib_ms),
                                  library_ms_runs=lib_ms, **dev,
                                  **_bound(nbytes, float(dy.numel())),
                                  max_abs_err=err, bitwise=same_g)
    r3 = out["gather_rows_bwd"]
    log(f"  K3 bwd: grouped kernel {r3['ms']:.4f} ms (runs {ms}), general "
        f"(with its sort) {r3['general_ms']:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bf16 index_add_ {r3['library_ms']:.4f} ms (runs {lib_ms}); "
        f"bound {r3['bound_ms']:.4f} ms by {r3['bound_by']}; device time "
        f"(profiler) grouped {dev['device_ms']:.4f}, general "
        f"{dev['general_device_ms']:.4f}, index_add_ "
        f"{dev['library_device_ms']:.4f} ms; grouped "
        f"{'faster' if r3['ms'] < r3['library_ms'] else 'NOT faster'} than "
        f"index_add_")
    torch.cuda.empty_cache()
    return out


def phase_slice():
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import serve
    from repro_torch.configs import get_config
    n_layers = get_config("moe-gpt2").num_layers
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    kexp.weight_bf16.casts = 0
    res = serve.main(SERVE_ARGS)
    launches, casts = kexp.expert_ffn.launches, kexp.weight_bf16.casts
    all_launches = {k: fn.launches for k, fn in counters.items()}
    B, S, G = res["batch"], res["prompt_len"], res["gen"]
    want = n_layers * (serve.N_BATCHED_PREFILLS + S + G)
    # since slice 17 the batched prefills attend on K5, once a layer;
    # nothing else launches
    want_all = dict.fromkeys(all_launches, 0)
    want_all["expert_ffn"] = want
    want_all["flash_attention"] = n_layers * serve.N_BATCHED_PREFILLS
    logits = ([res["prefill_logits"]] + res["step_logits"]
              + res["gen_logits"])
    finite = all(bool(torch.isfinite(t).all()) for t in logits)
    shapes_ok = all(tuple(t.shape) == (B, 50257) for t in logits)
    feed_vs_batch = (res["step_logits"][-1]
                     - res["prefill_logits"]).abs().max().item()
    info = dict(arch=res["arch"], batch=B, prompt_len=S, gen=G,
                prefill_s=res["prefill_s"],
                prefill_tok_s=res["prefill_tok_s"],
                prompt_feed_s=res["prompt_feed_s"],
                decode_ms_per_step=res["decode_ms_per_step"],
                peak_mem_gib=res["peak_mem_bytes"] / 2 ** 30,
                k1_launches=launches, k1_launches_expected=want,
                launches=all_launches, launches_expected=want_all,
                # the tensor-core route's bf16 weight copies: one per
                # weight tensor for the whole run (the weights never change)
                weight_casts=casts, weight_casts_expected=3 * n_layers,
                feed_vs_batch_max_abs=feed_vs_batch,
                sample_tokens=res["tokens"][0, :10].tolist())
    log("slice: " + json.dumps(info))
    if not finite or not shapes_ok:
        raise SystemExit(f"slice logits: finite={finite} shapes={shapes_ok}")
    if launches != want:
        raise SystemExit(f"K1 launched {launches} times in the slice run, "
                         f"the path calls it {want} times")
    if all_launches != want_all:
        raise SystemExit(f"slice run kernel launches {all_launches} differ "
                         f"from what the path calls, {want_all}")
    if casts != 3 * n_layers:
        raise SystemExit(f"{casts} bf16 weight casts in the slice run, not "
                         f"one per expert weight tensor ({3 * n_layers})")
    # the decode's logits and tokens, for the EP serve phase (M = 4)
    out = {"step": torch.stack(res["step_logits"]).cpu(),
           "gen": torch.stack(res["gen_logits"]).cpu(),
           "tokens": res["tokens"], "prefill": res["prefill_logits"].cpu()}
    del res, logits
    torch.cuda.empty_cache()
    return info, out


def phase_parity():
    """Batched prefill of full-width moe-gpt2 cut to 2 layers: card
    (kernels) against CPU (plain versions), same weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("moe-gpt2"), num_layers=2)
    model = build_model(cfg, device="cuda", seed=0)
    toks = torch.as_tensor(
        np.random.default_rng(7).integers(1, cfg.vocab_size, (2, 64)))
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    from repro_torch.kernels import flash_attn as kfa
    before = kexp.expert_ffn.launches
    k5_before = kfa.flash_attention.launches
    lg = model.prefill(toks.cuda(), 64, luffy=luffy)[0].cpu()
    launched = kexp.expert_ffn.launches - before
    k5_launched = kfa.flash_attention.launches - k5_before
    model.to("cpu")             # the same parameters, moved
    lc = model.prefill(toks, 64, luffy=luffy)[0]
    err = (lg - lc).abs().max().item()
    log(f"parity: 2-layer full-width prefill B=2 S=64, cuda vs cpu "
        f"max|dlogits|={err:.3e} (tol {PARITY_TOL:g}, |logits| max "
        f"{lc.abs().max().item():.3f}); K1 launches on cuda {launched}, "
        f"K5 {k5_launched} (the card attends on K5, the CPU on attend)")
    if launched != cfg.num_layers or k5_launched != cfg.num_layers:
        raise SystemExit(f"parity run launched K1 {launched} and K5 "
                         f"{k5_launched} times")
    if not (err <= PARITY_TOL and math.isfinite(err)):
        raise SystemExit(f"cuda vs cpu prefill differ by {err}")
    return err


def _device_rows(prof):
    """(device us, name, count) of every kernel, copy and memset the
    profiler saw on the card, largest first. Only device-side events
    count: a CPU op's self device time repeats the time of the kernels
    it launched, so summing both counts it twice."""
    from torch.autograd import DeviceType
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def _profile(fn, n: int):
    """Run ``fn`` n times under torch.profiler; returns the device-busy
    share of the wall time and the top device ops (ms per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    top = [{"op": k[:60], "ms_per_call": d / n / 1e3, "count_per_call":
            c / n} for d, k, c in rows[:6]]
    return dict(wall_ms_per_call=wall_us / n / 1e3,
                device_ms_per_call=busy / n / 1e3,
                device_busy_share=busy / wall_us if rows else None,
                top=top)


def phase_profile(model_axis: int = 1):
    """Where the time goes at full width: one batched prefill (B=8,
    S=128) and 8 decode steps (B=8) under torch.profiler, on one rank or
    over ``model_axis`` virtual ranks (the launcher's prefill context;
    the decode is the one-device one). Runs after the serve runs' launch
    counts were read."""
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    cfg = get_config("moe-gpt2")
    model = build_model(cfg, device="cuda", seed=0)
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    pdist = None
    if model_axis > 1:
        pdist = make_dist(make_host_mesh(model=model_axis), "prefill", 8,
                          moe_arch=True)
    import numpy as np
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(1, cfg.vocab_size, (8, 128)),
        dtype=torch.int32, device="cuda")
    model.prefill(toks, 160, luffy=luffy, dist=pdist)
    pf = _profile(lambda: model.prefill(toks, 160, luffy=luffy, dist=pdist),
                  2)
    state = {"cache": model.new_cache(8, 160)}

    def step():
        _, state["cache"] = model.decode_step(state["cache"], toks[:, :1],
                                              luffy=luffy)

    for _ in range(4):
        step()
    dec = _profile(step, 8)
    info = {"model_axis": model_axis, "prefill": pf, "decode_step": dec}
    log("profile: " + json.dumps(info))
    if not pf["top"] or not dec["top"]:
        log("profile: the profiler saw no device time (not measured)")
    del model, state
    torch.cuda.empty_cache()
    return info


def _kernel_counters():
    from repro_torch.kernels import condense as kcond
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import mamba_scan as kms
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import similarity as ksim
    return {"expert_ffn": kexp.expert_ffn,
            "flash_attention": kfa.flash_attention,
            "mamba_scan": kms.mamba_scan,
            "mamba_scan_fused": kms.mamba_scan_fused,
            "expert_ffn_bwd": kexp.expert_ffn_bwd,
            "masked_similarity": ksim.masked_similarity,
            "masked_similarity_fused": ksim.masked_similarity_fused,
            "gather_rows": kcond.gather_rows,
            "gather_rows_bwd": kcond.gather_rows_bwd,
            "pack_quant": kpack.pack_quant,
            "pack_cast": kpack.pack_cast,
            "pack_quant_bwd": kpack.pack_quant_bwd}


def phase_train():
    """Full-width, full-depth moe-gpt2 trained through the launcher with
    every kernel counter set to 0 just before and read just after; then
    the same run again, which must repeat the first bit for bit."""
    import statistics
    import torch
    from repro_torch.launch import train
    from repro_torch.kernels import expert_ffn as kexp
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    kexp.weight_bf16.casts = kexp.weight_bf16.lo_casts = 0
    res = train.main(TRAIN_ARGS)
    launches = {k: fn.launches for k, fn in counters.items()}
    casts = kexp.weight_bf16.casts
    lo_casts = kexp.weight_bf16.lo_casts
    cfg, steps = res["cfg"], res["steps"]
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    fwd = n_moe * (2 if cfg.remat else 1) * len(steps)   # + recompute
    # K2: every launch through the fused entry (fast_similarity)
    want = {"expert_ffn": fwd, "expert_ffn_bwd": n_moe * len(steps),
            "masked_similarity": fwd, "masked_similarity_fused": fwd,
            "gather_rows": fwd,
            "gather_rows_bwd": n_moe * len(steps), "pack_quant": 0,
            "pack_cast": 0, "pack_quant_bwd": 0, "flash_attention": 0,
            "mamba_scan": 0, "mamba_scan_fused": 0}
    for st in steps:
        log(f"  train step {st['step']}: loss {st['loss']:.5f} "
            f"condense_rate {st['condense_rate']:.5f} bucket {st['bucket']}"
            f" (C={st['capacity']}) {st['step_ms']:.1f} ms")
    med = statistics.median(st["step_ms"] for st in steps[1:])
    tokens = res["global_batch"] * res["seq_len"]
    info = dict(arch=res["arch"], global_batch=res["global_batch"],
                seq_len=res["seq_len"], remat=cfg.remat,
                losses=[st["loss"] for st in steps],
                condense_rates=[st["condense_rate"] for st in steps],
                buckets=[st["bucket"] for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                median_step_ms_after_0=med, tokens_per_s=tokens / med * 1e3,
                peak_mem_gib=max(st["peak_mem_bytes"] for st in steps)
                / 2 ** 30, launches=launches, launches_expected=want,
                # one bf16 copy per expert weight tensor and optimizer step:
                # the remat recompute and the backward read the forward's;
                # the backward makes each one's second bf16 term once
                weight_casts=casts, weight_lo_casts=lo_casts,
                weight_casts_expected=3 * n_moe * len(steps))
    log("train: " + json.dumps(info))
    if not all(math.isfinite(x) for x in info["losses"]):
        raise SystemExit(f"train losses not finite: {info['losses']}")
    if not any(b > 0 for b in info["buckets"][4:]):
        raise SystemExit(f"no rate-bucket switch after step 3: "
                         f"{info['buckets']}")
    if launches != want:
        raise SystemExit(f"kernel launches {launches} differ from what the "
                         f"path calls, {want}")
    if casts != info["weight_casts_expected"] \
            or lo_casts != info["weight_casts_expected"]:
        raise SystemExit(f"{casts} bf16 weight casts and {lo_casts} second "
                         f"terms in the train run, not "
                         f"{info['weight_casts_expected']} each")
    del res, steps
    torch.cuda.empty_cache()
    again = train.main(TRAIN_ARGS)["steps"]
    same = {k: [st[k] for st in again] == info[key]
            for k, key in (("loss", "losses"),
                           ("condense_rate", "condense_rates"),
                           ("bucket", "buckets"))}
    info["repeat_bitwise"] = same
    log(f"train repeat, same seed: bit-equal {same}; losses "
        f"{[st['loss'] for st in again]}")
    if not all(same.values()):
        raise SystemExit(f"the train run does not repeat: {same}")
    del again
    torch.cuda.empty_cache()
    return info


def _train_step_once(model, batch, cap, luffy, thr):
    """Loss, global gradient norm, per-call rep maps and the gradients of
    one forward and backward."""
    import torch
    import repro_torch.condense.plan as tplan
    reps = []
    orig = tplan.condense_tokens

    def rec(*a, **kw):
        o = orig(*a, **kw)
        reps.append(o.rep_idx.cpu())
        return o

    tplan.condense_tokens = rec
    try:
        model.zero_grad(set_to_none=True)
        loss, _ = model.forward_train(batch, thr, cap, luffy=luffy)
        loss.backward()
    finally:
        tplan.condense_tokens = orig
    grads = [p.grad for p in model.parameters()]
    gn = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).item()
    model.zero_grad(set_to_none=True)
    return loss.item(), gn, reps, grads


def phase_train_parity():
    """One train step of a 2-layer full-width cut at f32 compute on the
    card (kernels) and on the CPU (plain versions), same parameters and
    batch: rep maps, loss and gradient norm."""
    import torch
    from repro_torch.config import LuffyConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import capacity_for
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import build_model
    B, S = TRAIN_PARITY["B"], TRAIN_PARITY["S"]
    cfg = dataclasses.replace(get_config("moe-gpt2"),
                              num_layers=TRAIN_PARITY["layers"],
                              compute_dtype="float32")
    model = build_model(cfg, device="cuda", seed=0)
    batch = SyntheticLM(cfg, ShapeConfig("t", S, B, "train")).batch(0)
    luffy = LuffyConfig(condense_group=128, combine_slack=2.0)
    cap = capacity_for(cfg.moe, B * S, cfg.moe.num_experts)
    thr = torch.tensor(0.6)
    runs = {}
    for dev in ("cuda", "cuda_again", "cpu"):
        model.to(dev[:4])
        tb = {k: torch.as_tensor(v, device=dev[:4])
              for k, v in batch.items()}
        runs[dev] = _train_step_once(model, tb, cap, luffy, thr.to(dev[:4]))
    (lg, gg, rg, dg), (lc, gc, rc, _) = runs["cuda"], runs["cpu"]
    la, _, ra, da = runs["cuda_again"]
    repeats = (la == lg and all(torch.equal(a, b) for a, b in zip(ra, rg))
               and all(torch.equal(a, b) for a, b in zip(da, dg)))
    n_tok = sum(r.numel() for r in rc)
    n_diff = sum(int((a != b).sum()) for a, b in zip(rg, rc))
    info = dict(loss_cuda=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
                grad_norm_cuda=gg, grad_norm_cpu=gc,
                grad_norm_rel=abs(gg - gc) / gc, rep_tokens=n_tok,
                rep_differ=n_diff, rep_agree=1 - n_diff / n_tok,
                cuda_repeats_bitwise=repeats)
    log("train parity: " + json.dumps(info))
    if len(rg) != len(rc) or info["rep_agree"] < 0.999:
        raise SystemExit(f"rep maps differ on {n_diff} of {n_tok} tokens")
    if not info["loss_rel"] <= 1e-4:
        raise SystemExit(f"cuda vs cpu train loss differ: {info}")
    if not info["grad_norm_rel"] <= 1e-3:
        raise SystemExit(f"cuda vs cpu gradient norm differ: {info}")
    if not repeats:
        raise SystemExit("the card's train step does not repeat bit for bit")
    del model, runs, dg, da
    torch.cuda.empty_cache()
    info["bf16_grad_check"] = _bf16_grad_check(cfg, batch, cap, luffy, thr)
    return info


def _bf16_grad_check(cfg, batch, cap, luffy, thr):
    """One bf16 train step of the same cut (bf16 compute, same parameters
    and batch) on the card, its gradients made twice: through K1's
    tensor-core backward and with bwd_route forced to the FMA kernels
    (f32 sums of the bf16 operands). The bf16 loss curve moves with
    rounding, so this is the backward's end-to-end check: the global
    gradient norms within 1e-2 relative and every parameter's gradient
    cosine >= 0.999."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.models.model import build_model
    cfg16 = dataclasses.replace(cfg, compute_dtype=get_config(
        "moe-gpt2").compute_dtype)
    model = build_model(cfg16, device="cuda", seed=0)
    tb = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    route = kexp.bwd_route
    names = [n for n, _ in model.named_parameters()]
    runs = {}
    for name in ("tensor_cores", "fma"):
        before = kexp.expert_ffn_bwd.launches
        if name == "fma":
            kexp.bwd_route = lambda *a: "fma"
        try:
            runs[name] = _train_step_once(model, tb, cap, luffy,
                                          thr.to("cuda"))
        finally:
            kexp.bwd_route = route
        runs[name] += (kexp.expert_ffn_bwd.launches - before,)
    (lt, gt, rt, dt, nt), (lf, gf, rf, df, nf) = (runs["tensor_cores"],
                                                  runs["fma"])
    cos = {}
    for n, a, b in zip(names, dt, df):
        if a is None or b is None:
            cos[n] = 1.0 if a is b else 0.0
            continue
        a, b = a.double().flatten(), b.double().flatten()
        na, nb = a.norm().item(), b.norm().item()
        cos[n] = 1.0 if na == nb == 0.0 else (
            (a @ b).item() / (na * nb) if na and nb else 0.0)
    worst = min(cos, key=cos.get)
    info = dict(compute_dtype=cfg16.compute_dtype, loss_tensor_cores=lt,
                loss_fma=lf, grad_norm_tensor_cores=gt, grad_norm_fma=gf,
                grad_norm_rel=abs(gt - gf) / gf, min_cosine=cos[worst],
                min_cosine_param=worst, k1_bwd_launches=[nt, nf],
                rep_maps_equal=len(rt) == len(rf) and all(
                    torch.equal(a, b) for a, b in zip(rt, rf)))
    log("train parity, bf16 gradients (tensor cores vs FMA backward): "
        + json.dumps(info))
    if not (info["grad_norm_rel"] <= 1e-2 and info["min_cosine"] >= 0.999):
        raise SystemExit(f"the bf16 gradients of K1's tensor-core backward "
                         f"differ from the FMA route's: {info}")
    if nt != nf or nt == 0 or lt != lf or not info["rep_maps_equal"]:
        raise SystemExit(f"the two bf16 steps did not run the same forward "
                         f"through K1's backward: {info}")
    del model, runs, dt, df
    torch.cuda.empty_cache()
    return info


KERNEL_OPS = {"expert_ffn": ("gate_up_kernel", "down_kernel",
                             "ffn_wgmma_kernel"),
              "expert_ffn_bwd": ("hidden_kernel", "wgrad_kernel",
                                 "dh_kernel", "bwd_wgmma_kernel"),
              "masked_similarity": ("sim_kernel", "sim_wgmma_kernel"),
              "gather_rows": ("gather_kernel",),
              "gather_rows_bwd": ("segment_sum_kernel", "group_sum_kernel")}


def _train_step_profile(cfg, shape, ocfg):
    """One train step (after one warm-up step) of ``cfg`` at ``shape``
    under torch.profiler: device-busy share, top device ops, each
    kernel's share of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim, train_lib
    from repro_torch.config import LuffyConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import build_model
    model = build_model(cfg, device="cuda", seed=0)
    params = model.params
    luffy = LuffyConfig(condense_group=128, combine_slack=2.0)
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0)
    step = train_lib.make_train_step(cfg, luffy, ocfg, cap)
    state = [optim.init_opt_state(params, ocfg),
             train_lib.init_luffy_state("cuda")]
    data = SyntheticLM(cfg, shape)

    def one(i):
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch(i).items()}
        _, state[0], state[1], _ = step(params, state[0], state[1], b)

    one(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one(1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    shares = {k: sum(d for d, key, _ in rows if any(n in key for n in ops))
              / busy if busy else None for k, ops in KERNEL_OPS.items()}
    info = dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
                device_busy_share=busy / wall_us if rows else None,
                kernel_share=shares,
                top=[{"op": k[:60], "ms": d / 1e3, "count": c}
                     for d, k, c in rows[:10]])
    del model, params, state, prof
    torch.cuda.empty_cache()
    return info


def phase_train_profile():
    """One full-width moe-gpt2 train step under torch.profiler."""
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.configs import get_config
    info = _train_step_profile(get_config("moe-gpt2"),
                               ShapeConfig("train", 1024, 8, "train"),
                               OptimConfig(lr=1e-3, total_steps=6,
                                           warmup_steps=2))
    log("train profile: " + json.dumps(info))
    if info["device_busy_share"] is None:
        log("train profile: the profiler saw no device time (not measured)")
    return info


def _k4_tok(gen, T=K4_T):
    """The dedup wire's slot -> token map at the EP train shape (``T``
    tokens a rank), built as ``repro_torch.condense.wire.dedup_dispatch``
    builds it: each kept token's one row per destination node."""
    import torch
    from repro_torch.condense.wire import dedup_capacity
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import capacity_for
    cfg = get_config("moe-gpt2")         # 16 experts, top-2, factor 2
    M, N = K4_M, K4_N
    E, L = cfg.moe.num_experts, K4_M // K4_N
    e_local = E // M
    C = capacity_for(cfg.moe, T, E)
    C_u = dedup_capacity(T, e_local, L, C)
    first = torch.randint(0, E, (M, T), generator=gen, device="cuda")
    second = (first + torch.randint(1, E, (M, T), generator=gen,
                                    device="cuda")) % E
    keep = torch.rand((M, T), generator=gen, device="cuda") < K4_KEEP
    node = torch.stack([first, second], -1) // e_local // L       # [M,T,2]
    headed = (node[..., None] == torch.arange(N, device="cuda")).any(2) \
        & keep[..., None]                                         # [M,T,N]
    h = headed.long()
    urank = torch.cumsum(h, 1) - h
    ranks = torch.arange(M, device="cuda")
    slot = (ranks[:, None, None] * N + torch.arange(N, device="cuda")) \
        * C_u + urank
    R = M * N * C_u
    tok = torch.full((R + 1,), -1, dtype=torch.int32, device="cuda")
    gid = (ranks[:, None, None] * T
           + torch.arange(T, device="cuda")[None, :, None]).expand(M, T, N)
    tok[torch.where(headed, slot, torch.full_like(slot, R)).reshape(-1)] = \
        gid.reshape(-1).to(torch.int32)
    return tok[:R], C_u


def phase_kernels_k4(d_model: int = D, T: int = K4_T):
    """K4 (f8 and cast) and its backward against their plain versions on
    the card, then timed, at ``d_model`` and ``T`` tokens a rank.
    Returns {record name: record}."""
    import torch
    from repro_torch.comm import dtypes as wdt
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(777)
    D = d_model
    tok, C_u = _k4_tok(gen, T)
    R = tok.numel()
    n_rows = int((tok >= 0).sum())
    x = torch.randn((K4_M * T, D), generator=gen, device="cuda") \
        .to(torch.bfloat16)

    def u8(t):
        return t.view(torch.uint8) if t.dtype == wdt.F8 else t

    checks = []
    small_x = torch.randn((64, 33), generator=gen, device="cuda")
    small_tok = torch.randint(-1, 64, (96,), generator=gen, device="cuda",
                              dtype=torch.int32)
    small_tok[::7] = -1
    for name, xx, tt in (("train", x, tok), ("d33", small_x, small_tok),
                         ("d33_bf16", small_x.to(torch.bfloat16),
                          small_tok)):
        for wire in ("f8e4m3", "bf16", "f32"):
            q, sc = kpack.pack_quantize(xx, tt, wire)
            torch.cuda.synchronize()
            wq, wsc = ref.pack_quantize_ref(xx, tt, wire)
            ok = torch.equal(u8(q), u8(wq)) and (
                sc is None or torch.equal(sc, wsc))
            again = kpack.pack_quantize(xx, tt, wire)[0]
            ok = ok and torch.equal(u8(again), u8(q))
            checks.append(dict(shape=name, wire=wire, ok=ok))
            log(f"  K4 {name:8s} {tuple(xx.shape)} -> {tuple(q.shape)} "
                f"{wire:6s}: bitwise equal to the plain version and "
                f"repeats: {ok}")
    if not all(c["ok"] for c in checks):
        raise SystemExit(f"K4 disagrees with its plain version: {checks}")
    out = {}
    d_pad = wdt.pad_to_block(D)
    in_bytes = n_rows * D * x.element_size() + R * 4
    for wire, rec_name in (("f8e4m3", "pack_quantize_f8"),
                           ("bf16", "pack_quantize_cast")):
        fn = lambda: kpack.pack_quantize(x, tok, wire)      # noqa: E731
        ms = time_ms(fn, 50)
        dev = device_ms(fn, 50)
        host_us = _host_us(fn)
        plain_ms = time_ms(lambda: ref.pack_quantize_ref(x, tok, wire), 50)
        lib_ms = time_ms(lambda: wdt.quantize_rows(
            x.index_select(0, tok.clamp(min=0).long()), wire), 50)
        out_bytes = (R * d_pad + R * (d_pad // 32) * 4 if wire == "f8e4m3"
                     else R * D * 2)
        rec = dict(ms=ms, device_ms=dev, host_us=host_us, plain_ms=plain_ms,
                   library_ms=lib_ms, rows=R, filled_rows=n_rows,
                   **_bound(in_bytes + out_bytes, 0.0), max_abs_err=0.0)
        rec["bound_share_device"] = rec["bound_ms"] / dev
        out[rec_name] = rec
        log(f"  K4 {wire} [{K4_M * T},{D}] bf16 -> {R} wire rows "
            f"({n_rows} filled): {dev:.4f} ms of device time "
            f"({100 * rec['bound_share_device']:.1f}% of the bound), events "
            f"{ms:.4f} ms, the wrapper's host time {host_us:.1f} us a call; "
            f"plain {plain_ms:.4f} ms, index_select+codec {lib_ms:.4f} ms; "
            f"bound {rec['bound_ms']:.4f} ms by bytes")
    # the backward kernel: the f8 codec's transpose at the same rows, at
    # the cotangent scales the CPU codec test uses. At 1 most of the
    # payload's cotangent f8(g * scale) is nonzero on the filled rows; at
    # 1e-2 and 1e-4 it is zero there and only the scale's (tie) term is
    # left, as in the reference's f8 training (ROADMAP, parity rules).
    _, sc = wdt.quantize_rows(ref.pack_rows_ref(x, tok), "f8e4m3")
    filled = tok >= 0
    errs = {}
    for g_scale in (1.0, 1e-2, 1e-4):
        g = (torch.randn((R, D), generator=gen, device="cuda") * g_scale) \
            .to(torch.bfloat16)
        ct_q = (g.float().reshape(R, -1, wdt.SCALE_BLOCK) * sc[..., None]) \
            .to(wdt.F8).float()
        share = (ct_q[filled] != 0).float().mean().item()
        got = kpack.pack_quant_bwd(x, tok, g)
        torch.cuda.synchronize()
        want = ref.pack_quant_bwd_ref(x, tok, g)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        again = torch.equal(kpack.pack_quant_bwd(x, tok, g), got)
        ok = err <= 2e-2 * scale and again
        if g_scale == 1.0:
            ok = ok and share > 0.5
        errs[g_scale] = err
        log(f"  K4 bwd [{R},{D}] bf16, cotangent x{g_scale:g}: "
            f"f8(g*scale) nonzero on {share:.4f} of the filled entries; "
            f"max|err|={err:.3e} (tol 2e-2 x {scale:.3e}: one bf16 "
            f"rounding of sums in another order); repeats {again} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K4's backward disagrees with its plain "
                             f"version at cotangent x{g_scale:g} (or its "
                             f"payload path went unexercised)")
    ms = time_ms(lambda: kpack.pack_quant_bwd(x, tok, g), 50)
    dev_ms = device_ms(lambda: kpack.pack_quant_bwd(x, tok, g), 50)
    plain_ms = time_ms(lambda: ref.pack_quant_bwd_ref(x, tok, g), 20)
    nbytes = in_bytes + 2 * R * D * 2
    rec = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
               **_bound(nbytes, 0.0), max_abs_err=max(errs.values()),
               errs=errs)
    rec["bound_share_device"] = rec["bound_ms"] / dev_ms
    out["pack_quantize_bwd"] = rec
    log(f"  K4 bwd: kernel {ms:.4f} ms by CUDA events, {dev_ms:.4f} ms of "
        f"device time ({100 * rec['bound_share_device']:.1f}% of the "
        f"bound), plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms "
        f"by bytes")
    del x, tok, g, got, want
    torch.cuda.empty_cache()
    return out


def _record_plans():
    """Wrap the expert-parallel planner entry to keep every plan's perm
    and rep map (on the card) and count the greedy's calls, forward and
    recompute. Returns (plans, greedy, undo)."""
    import repro_torch.plan.exchange as tex
    from repro_torch.plan import objectives
    plans, greedy = [], [0]
    orig = tex.build_exchange_plan
    plan_orig = objectives.plan_migration_with_objective

    def rec(*a, **kw):
        pl = orig(*a, **kw)
        plans.append((None if pl.perm is None else pl.perm.copy(),
                      pl.condense_plan.rep_idx.clone()))
        return pl

    def count(*a, **kw):
        greedy[0] += 1
        return plan_orig(*a, **kw)

    tex.build_exchange_plan = rec
    objectives.plan_migration_with_objective = count

    def undo():
        tex.build_exchange_plan = orig
        objectives.plan_migration_with_objective = plan_orig

    return plans, greedy, undo


def _ep_run(args):
    """One launcher run with every kernel counter set to 0 just before
    and read just after; returns (result, launches, plans, greedy calls),
    plans as (perm, rep map) pairs."""
    from repro_torch.launch import train
    from repro_torch.kernels import similarity as ksim
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    ksim.masked_similarity_fused.lsh_launches = 0
    plans, greedy, undo = _record_plans()
    try:
        res = train.main(args)
    finally:
        undo()
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["masked_similarity_fused_lsh"] = \
        ksim.masked_similarity_fused.lsh_launches
    return res, launches, plans, greedy[0]


def _ep_expected(cfg, n_steps: int, f8: bool):
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    fwd = n_moe * (2 if cfg.remat else 1) * n_steps     # + recompute
    bwd = n_moe * n_steps
    return {"expert_ffn": fwd, "expert_ffn_bwd": bwd,
            "masked_similarity": fwd, "masked_similarity_fused": fwd,
            "gather_rows": fwd,
            "gather_rows_bwd": bwd, "pack_quant": fwd if f8 else 0,
            "pack_cast": 0 if f8 else fwd,
            # the dispatch pack's and the combine partials' codec
            "pack_quant_bwd": 2 * bwd if f8 else 0,
            "flash_attention": 0, "mamba_scan": 0, "mamba_scan_fused": 0,
            "masked_similarity_fused_lsh": 0}


def _check_law(steps, luffy, cfg):
    """shipped == flat / (dedup x precision) on every step."""
    from repro_torch.comm import dtypes as wdt
    prec = wdt.wire_precision(cfg.d_model, luffy.wire_dtype, 2)
    bad = []
    for st in steps:
        flat, dedup = st["inter_bytes_flat"], st["inter_bytes_dedup"]
        shipped = st["inter_bytes_shipped"]
        want = flat / (flat / dedup * prec)
        if not (shipped > 0 and abs(shipped - want) <= 1e-5 * want):
            bad.append((st["step"], shipped, want))
    return bad


def phase_ep_train():
    """Full-width EP train run (6 steps, f8 dedup wire) with exact launch
    counts and the shipped-bytes law, then again from the same seed."""
    import statistics
    import numpy as np
    import torch
    res, launches, plans, _ = _ep_run(EP_ARGS)
    perms = [p for p, _ in plans]
    cfg, steps, luffy = res["cfg"], res["steps"], res["luffy"]
    want = _ep_expected(cfg, len(steps), f8=True)
    for st in steps:
        log(f"  EP step {st['step']}: loss {st['loss']:.5f} condense_rate "
            f"{st['condense_rate']:.5f} bucket {st['bucket']} (C="
            f"{st['capacity']}) local_frac {st['local_frac']:.4f} traffic "
            f"{st['traffic_before']:.1f}->{st['traffic_after']:.1f} inter "
            f"flat/dedup/shipped {st['inter_bytes_flat']:.0f}/"
            f"{st['inter_bytes_dedup']:.0f}/{st['inter_bytes_shipped']:.0f} "
            f"B {st['step_ms']:.1f} ms")
    med = statistics.median(st["step_ms"] for st in steps[1:])
    tokens = res["global_batch"] * res["seq_len"]
    keys = ("loss", "condense_rate", "bucket", "local_frac",
            "traffic_before", "traffic_after", "inter_bytes_flat",
            "inter_bytes_dedup", "inter_bytes_shipped", "measured_pairs",
            "step_ms")
    info = dict(arch=res["arch"], model_axis=res["dist"].model_size,
                nodes=res["dist"].nodes, wire=luffy.wire_dtype,
                global_batch=res["global_batch"], seq_len=res["seq_len"],
                per_step={k: [st[k] for st in steps] for k in keys},
                median_step_ms_after_0=med, tokens_per_s=tokens / med * 1e3,
                peak_mem_gib=max(st["peak_mem_bytes"] for st in steps)
                / 2 ** 30, launches=launches, launches_expected=want,
                plans=len(perms))
    log("EP train: " + json.dumps(info))
    info["_perms"] = perms          # for phase 43, not logged
    losses = info["per_step"]["loss"]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"EP train losses not finite: {losses}")
    bad = _check_law(steps, luffy, cfg)
    if bad:
        raise SystemExit(f"shipped-bytes law broken on steps {bad}")
    if launches != want:
        raise SystemExit(f"EP kernel launches {launches} differ from what "
                         f"the path calls, {want}")
    del res, steps
    torch.cuda.empty_cache()
    again, _, plans2, _ = _ep_run(EP_ARGS)
    perms2 = [p for p, _ in plans2]
    same = {k: [st[k] for st in again["steps"]] == info["per_step"][k]
            for k in ("loss", "condense_rate", "bucket")}
    same["perms"] = len(perms) == len(perms2) and all(
        (a is None and b is None) or np.array_equal(a, b)
        for a, b in zip(perms, perms2))
    info["repeat_bitwise"] = same
    log(f"EP repeat, same seed: bit-equal {same}")
    if not all(same.values()):
        raise SystemExit(f"the EP train run does not repeat: {same}")
    del again
    torch.cuda.empty_cache()
    return info


def phase_ep_bf16():
    """2 full-width EP steps on the bf16 wire: K4's cast kernel."""
    import torch
    res, launches, _, _ = _ep_run(EP_BF16_ARGS)
    cfg, steps = res["cfg"], res["steps"]
    want = _ep_expected(cfg, len(steps), f8=False)
    info = dict(wire=res["luffy"].wire_dtype,
                losses=[st["loss"] for st in steps],
                shipped=[st["inter_bytes_shipped"] for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                launches=launches, launches_expected=want)
    log("EP bf16 wire: " + json.dumps(info))
    if not all(math.isfinite(x) for x in info["losses"]):
        raise SystemExit("EP bf16 losses not finite")
    bad = _check_law(steps, res["luffy"], cfg)
    if bad:
        raise SystemExit(f"shipped-bytes law broken on the bf16 wire: {bad}")
    if launches != want:
        raise SystemExit(f"EP bf16 launches {launches} differ from {want}")
    del res
    torch.cuda.empty_cache()
    return info


def phase_ep_parity():
    """One f32 EP step of a 2-layer full-width cut on the card and on the
    CPU: loss, gradient norm, perms and rep maps."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch.config import LuffyConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch import train_lib
    P = EP_PARITY
    cfg = dataclasses.replace(get_config("moe-gpt2"), num_layers=P["layers"],
                              compute_dtype="float32")
    shape = ShapeConfig("t", P["S"], P["B"], "train")
    dist = make_dist(make_host_mesh(model=P["M"], nodes=P["nodes"]), "train",
                     P["B"], moe_arch=True)
    luffy = LuffyConfig(condense_group=128, combine_slack=2.0,
                        comm_mode="hier", hier_dedup="on",
                        wire_dtype="f8e4m3")
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
    model = build_model(cfg, device="cuda", seed=0)
    batch = SyntheticLM(cfg, shape).batch(0)
    thr = torch.tensor(0.6)
    runs = {}
    orig = tex.build_exchange_plan
    for dev in ("cuda", "cpu"):
        model.to(dev)
        plans = []

        def rec(*a, **kw):
            pl = orig(*a, **kw)
            plans.append((pl.perm.copy(), pl.condense_plan.rep_idx.cpu()))
            return pl

        tex.build_exchange_plan = rec
        try:
            model.zero_grad(set_to_none=True)
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, _ = model.forward_train(tb, thr.to(dev), cap, luffy=luffy,
                                          dist=dist)
            loss.backward()
        finally:
            tex.build_exchange_plan = orig
        gn = torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                            for p in model.parameters())).item()
        runs[dev] = (loss.item(), gn, plans)
    (lg, gg, pg), (lc, gc, pc) = runs["cuda"], runs["cpu"]
    perms_equal = len(pg) == len(pc) and all(
        np.array_equal(a[0], b[0]) for a, b in zip(pg, pc))
    n_tok = sum(b[1].numel() for b in pc)
    n_diff = sum(int((a[1] != b[1]).sum()) for a, b in zip(pg, pc))
    info = dict(loss_cuda=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
                grad_norm_cuda=gg, grad_norm_cpu=gc,
                grad_norm_rel=abs(gg - gc) / gc, plans=len(pg),
                perms_equal=perms_equal, rep_tokens=n_tok, rep_differ=n_diff)
    log("EP parity: " + json.dumps(info))
    if not perms_equal:
        raise SystemExit(f"cuda vs cpu migration perms differ: {info}")
    if n_diff:
        raise SystemExit(f"cuda vs cpu rep maps differ on {n_diff} of "
                         f"{n_tok} tokens")
    if not info["loss_rel"] <= 1e-4:
        raise SystemExit(f"cuda vs cpu EP loss differ: {info}")
    if not info["grad_norm_rel"] <= 1e-3:
        raise SystemExit(f"cuda vs cpu EP gradient norm differ: {info}")
    del model
    torch.cuda.empty_cache()
    return info


COMM_OPS = ("all_to_all", "node_all_to_all", "local_all_gather",
            "local_psum_scatter")


def _count_syncs(fn):
    """The synchronizing CUDA calls ``fn`` makes (torch's sync debug
    mode warns on each), or None where the mode reports none."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return n or None


def phase_ep_profile(overrides=None, label="EP profile"):
    """One full-width EP train step (after a warm-up step) under
    torch.profiler: device-busy share, top device ops, each kernel's
    share, the device time inside the virtual-rank collectives
    (device-memory permutes) and the host planner's time; then one more
    step outside the profiler, counting its device syncs. ``overrides``:
    LuffyConfig fields beyond the EP run's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import optim, train_lib
    from repro_torch.comm.hierarchical import CommContext
    from repro_torch.config import LuffyConfig, OptimConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.plan import objectives
    cfg = get_config("moe-gpt2")
    shape = ShapeConfig("train", 1024, 8, "train")
    dist = make_dist(make_host_mesh(model=4, nodes=2), "train", 8,
                     moe_arch=True)
    model = build_model(cfg, device="cuda", seed=0)
    params = model.params
    ocfg = OptimConfig(lr=1e-3, total_steps=6, warmup_steps=2)
    luffy = LuffyConfig(condense_group=128, combine_slack=2.0,
                        comm_mode="hier", hier_dedup="on",
                        wire_dtype="f8e4m3", **(overrides or {}))
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
    step = train_lib.make_train_step(cfg, luffy, ocfg, cap, dist)
    state = [optim.init_opt_state(params, ocfg),
             train_lib.init_luffy_state("cuda")]
    data = SyntheticLM(cfg, shape)

    def one(i):
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch(i).items()}
        _, state[0], state[1], _ = step(params, state[0], state[1], b)

    one(0)
    torch.cuda.synchronize()
    originals = {n: getattr(CommContext, n) for n in COMM_OPS}
    from repro_torch.core import migration as mig
    plan_orig = objectives.plan_migration_with_objective
    home_orig = mig.home_plan
    planner = {"ms": 0.0, "calls": 0, "home_ms": 0.0, "home_calls": 0}

    def wrap(name, fn):
        def inner(self, x):
            with record_function("comm::" + name):
                return fn(self, x)
        return inner

    def timed_plan(*a, **kw):
        t0 = time.perf_counter()
        out = plan_orig(*a, **kw)
        planner["ms"] += (time.perf_counter() - t0) * 1e3
        planner["calls"] += 1
        return out

    def timed_home(*a, **kw):
        t0 = time.perf_counter()
        out = home_orig(*a, **kw)
        planner["home_ms"] += (time.perf_counter() - t0) * 1e3
        planner["home_calls"] += 1
        return out

    for n, fn in originals.items():
        setattr(CommContext, n, wrap(n, fn))
    objectives.plan_migration_with_objective = timed_plan
    mig.home_plan = timed_home
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one(1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for n, fn in originals.items():
            setattr(CommContext, n, fn)
        objectives.plan_migration_with_objective = plan_orig
        mig.home_plan = home_orig
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    ops = dict(KERNEL_OPS, pack_quant=("pack_quant_kernel",
                                       "pack_quant_scalar_kernel"),
               pack_cast=("pack_cast_kernel",),
               pack_quant_bwd=("pack_quant_bwd_kernel",))
    shares = {k: sum(d for d, key, _ in rows if any(n in key for n in o))
              / busy if busy else None for k, o in ops.items()}
    comm_us = 0.0
    for ev in prof.key_averages():
        if ev.key.startswith("comm::"):
            comm_us += getattr(ev, "device_time_total",
                               getattr(ev, "cuda_time_total", 0.0))
    info = dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
                device_busy_share=busy / wall_us if rows else None,
                kernel_share=shares,
                collectives_device_ms=comm_us / 1e3,
                collectives_share=comm_us / busy if busy else None,
                planner_host_ms=planner["ms"], planner_calls=planner["calls"],
                keep_home_host_ms=planner["home_ms"],
                keep_home_calls=planner["home_calls"],
                overrides=overrides or {},
                top=[{"op": k[:60], "ms": d / 1e3, "count": c}
                     for d, k, c in rows[:10]])
    info["step_syncs"] = _count_syncs(lambda: one(2))
    log(f"{label}: " + json.dumps(info))
    if not rows:
        log(f"{label}: the profiler saw no device time (not measured)")
    del model, params, state
    torch.cuda.empty_cache()
    return info


# ---------------------------------------------------------------------------
# phases 30-35: the pipelined executor (exec_mode="pipeline")
# ---------------------------------------------------------------------------

def _chunk_rows_bitwise(h_dtype):
    """K1 (after the RMS norm, as the dense wire calls it) on each chunk's
    rows against the same rows of one launch over the whole capacity, at
    the EP train path's [16, 4 x 512, 768] x 3072, for 4 and 3 chunks:
    (rms_bitwise, k1_bitwise, chunk sizes)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import moe_init
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.plan.exchange import _rms
    from repro_torch.sched import plan_chunks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    cfg = get_config("moe-gpt2")
    E, D = cfg.moe.num_experts, cfg.d_model
    M, C = 4, SCHED_CAPACITY
    ew = moe_init(gen, cfg, device="cuda")["experts"]
    w = (ew["w_up"], ew["w_gate"], ew["w_down"])
    x = torch.randn((E, M, C, D), generator=gen, device="cuda")
    scale = torch.rand((D,), generator=gen, device="cuda") + 0.5
    h_full = _rms(x, scale)
    full = kexp.expert_ffn(h_full.to(h_dtype).reshape(E, M * C, D), *w,
                           "gelu").reshape(E, M, C, D)
    rms_ok = k1_ok = True
    sizes = []
    for n in (SCHED_CHUNKS, 3):
        ch = plan_chunks(C, n)
        sizes.append(list(ch.sizes))
        for o, s in ch.slices():
            hk = _rms(x[:, :, o:o + s], scale)
            rms_ok &= torch.equal(hk, h_full[:, :, o:o + s])
            got = kexp.expert_ffn(hk.to(h_dtype).reshape(E, M * s, D), *w,
                                  "gelu").reshape(E, M, s, D)
            k1_ok &= torch.equal(got, full[:, :, o:o + s])
    return bool(rms_ok), bool(k1_ok), sizes


def phase_sched_kernels():
    """Phase 30: K1 at the pipelined dense wire's chunk shape, [16, 512,
    768] x 3072 (4 source ranks x a quarter of the capacity of 512),
    against its plain version and timed as phase 3 does; then each
    chunk's rows bit for bit the same rows of one [16, 2048, 768] launch,
    on both routes (bf16 h: tensor cores; f32 h: FMAs)."""
    import torch
    checks, timed = phase_kernels(shapes={"chunk": SCHED_K1_R})
    t = dict(timed["chunk"], checks=len(checks))
    t["max_abs_err"] = max(c["max_abs_err"] for c in checks)
    rows = {}
    for name in ("bfloat16", "float32"):
        rms_ok, k1_ok, sizes = _chunk_rows_bitwise(getattr(torch, name))
        rows[name] = dict(rms_bitwise=rms_ok, k1_bitwise=k1_ok,
                          chunk_sizes=sizes)
    t["rows_bitwise"] = rows
    log("sched K1 chunk rows vs one launch: " + json.dumps(rows))
    bad = [k for k, r in rows.items()
           if not (r["rms_bitwise"] and r["k1_bitwise"])]
    if bad:
        raise SystemExit(f"a chunk's rows are not one launch's bit for bit "
                         f"({bad}): {rows}")
    torch.cuda.empty_cache()
    return t


def _sched_expected(cfg, steps, wire):
    """Exact launches of an EP train run from its step records: on the
    dense wire (rows at the compute dtype, no K4) K1 and its backward
    once per chunk of each MoE sublayer (the recompute too); on the
    dedup wire as sync's (only the hop is chunked)."""
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    want = _ep_expected(cfg, len(steps), f8=wire == "f8e4m3")
    if wire == "dense":
        chunks = sum(st["chunks"] for st in steps)
        want.update(expert_ffn=n_moe * (2 if cfg.remat else 1) * chunks,
                    expert_ffn_bwd=n_moe * chunks, pack_quant=0,
                    pack_cast=0, pack_quant_bwd=0)
    return want


def _step0_diff(a, b):
    """The forward metrics of step 0 that differ between two runs."""
    return {k: (a[k], b[k]) for k in FWD_KEYS if a[k] != b[k]}


def phase_sched_ep_dense():
    """Phase 31: full-width moe-gpt2 EP train over 4 virtual ranks in 2
    nodes of 2 on the dense wire (condensation and migration on, bf16
    rows) with ``--exec-mode pipeline --pipeline-chunks 4``: step 0's
    loss and forward metrics bit for bit a sync run's step 0, exact
    launches (K1 and its backward once per chunk), one bf16 weight copy
    and one second term per expert weight a step, and a second run from
    the same seed bit for bit (losses, rates, buckets, perms)."""
    import numpy as np
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    sync, _, _, _ = _ep_run(DENSE_EP_ARGS + ["--steps", "1"])
    s0 = sync["steps"][0]
    del sync
    torch.cuda.empty_cache()
    kexp.weight_bf16.casts = kexp.weight_bf16.lo_casts = 0
    res, launches, plans, _ = _ep_run(DENSE_EP_ARGS + SCHED_FLAGS)
    casts, lo_casts = kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts
    cfg, steps = res["cfg"], res["steps"]
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    want = _sched_expected(cfg, steps, "dense")
    diff = _step0_diff(s0, steps[0])
    info = dict(exec_mode=res["luffy"].exec_mode,
                chunks=[st["chunks"] for st in steps],
                capacity=[st["capacity"] for st in steps],
                losses=[st["loss"] for st in steps],
                local_frac=[st["local_frac"] for st in steps],
                traffic=[(st["traffic_before"], st["traffic_after"])
                         for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                sync_step0_ms=s0["step_ms"],
                peak_mem_gib=max(st["peak_mem_bytes"] for st in steps)
                / 2 ** 30, launches=launches, launches_expected=want,
                weight_casts=casts, weight_lo_casts=lo_casts,
                weight_casts_expected=3 * n_moe * len(steps),
                step0_vs_sync_differ=diff)
    log("sched EP dense pipeline: " + json.dumps(info))
    if not all(math.isfinite(x) for x in info["losses"]):
        raise SystemExit(f"pipelined EP losses not finite: {info}")
    if diff:
        raise SystemExit(f"pipelined step 0 is not sync's bit for bit: "
                         f"{diff}")
    if launches != want:
        raise SystemExit(f"pipelined EP launches {launches} differ from what "
                         f"the path calls, {want}")
    if casts != info["weight_casts_expected"] \
            or lo_casts != info["weight_casts_expected"]:
        raise SystemExit(f"{casts} / {lo_casts} bf16 weight copies in the "
                         f"pipelined EP run")
    perms = [p for p, _ in plans]
    del res, steps
    torch.cuda.empty_cache()
    again, _, plans2, _ = _ep_run(DENSE_EP_ARGS + SCHED_FLAGS)
    perms2 = [p for p, _ in plans2]
    same = {k: [st[k] for st in again["steps"]] == info[key]
            for k, key in (("loss", "losses"), ("chunks", "chunks"),
                           ("local_frac", "local_frac"))}
    same["perms"] = len(perms) == len(perms2) and all(
        np.array_equal(a, b) for a, b in zip(perms, perms2))
    info["repeat_bitwise"] = same
    log(f"sched EP dense pipeline, repeat: bit-equal {same}")
    if not all(same.values()):
        raise SystemExit(f"the pipelined EP run does not repeat: {same}")
    del again
    torch.cuda.empty_cache()
    return info


def phase_sched_ep_dedup(ep_info=None):
    """Phase 32: phase 11's run (the f8 dedup wire) with ``--exec-mode
    pipeline``, 2 steps: step 0 bit for bit phase 11's step 0 (``ep_info``;
    None: a 1-step sync run made here), the shipped-bytes law, and K4
    and its backward (and K1) launched exactly as in a sync run: only
    the node hop is chunked."""
    import torch
    if ep_info is None:
        sync, _, _, _ = _ep_run(SCHED_DEDUP_ARGS + ["--steps", "1"])
        s0 = sync["steps"][0]
        del sync
    else:
        s0 = {k: v[0] for k, v in ep_info["per_step"].items()}
    res, launches, _, _ = _ep_run(SCHED_DEDUP_ARGS + SCHED_FLAGS)
    cfg, steps, luffy = res["cfg"], res["steps"], res["luffy"]
    want = _sched_expected(cfg, steps, luffy.wire_dtype)
    keys = [k for k in FWD_KEYS if k in s0]
    diff = {k: (s0[k], steps[0][k]) for k in keys if s0[k] != steps[0][k]}
    info = dict(exec_mode=luffy.exec_mode, wire=luffy.wire_dtype,
                chunks=[st["chunks"] for st in steps],
                losses=[st["loss"] for st in steps],
                shipped=[st["inter_bytes_shipped"] for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                launches=launches, launches_expected=want,
                step0_compared=keys, step0_vs_sync_differ=diff)
    log("sched EP dedup pipeline: " + json.dumps(info))
    if not all(math.isfinite(x) for x in info["losses"]):
        raise SystemExit(f"pipelined dedup losses not finite: {info}")
    if diff:
        raise SystemExit(f"pipelined dedup step 0 is not sync's bit for "
                         f"bit: {diff}")
    bad = _check_law(steps, luffy, cfg)
    if bad:
        raise SystemExit(f"shipped-bytes law broken under the pipeline: "
                         f"{bad}")
    if launches != want:
        raise SystemExit(f"pipelined dedup launches {launches} differ from "
                         f"sync's, {want}")
    del res, steps
    torch.cuda.empty_cache()
    return info


def phase_sched_serve(sync=None):
    """Phase 33: phase 19's EP serve run with ``--exec-mode pipeline``:
    the batched prefill's logits bit for bit the sync prefill's
    (``sync``: phase 19's result; None: a sync run made here), the same
    greedy tokens, K1 launched exactly 12 x (2 x chunks + 128 + 32) times
    (the decode has no all-to-all to chunk) and nothing else."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import serve
    if sync is None:
        res = serve.main(EP_SERVE_ARGS)
        sync = {"prefill_logits": res["prefill_logits"].cpu(),
                "tokens": res["tokens"]}
        del res
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    kexp.weight_bf16.casts = 0
    res = serve.main(EP_SERVE_ARGS + SCHED_FLAGS)
    launches = {k: fn.launches for k, fn in counters.items()}
    n_layers = get_config("moe-gpt2").num_layers
    want = dict.fromkeys(launches, 0)
    want["expert_ffn"] = n_layers * (
        serve.N_BATCHED_PREFILLS * res["chunks"] + res["prompt_len"]
        + res["gen"])
    # the batched prefills' attention on K5 (since slice 17)
    want["flash_attention"] = n_layers * serve.N_BATCHED_PREFILLS
    logits = res["prefill_logits"].cpu()
    info = dict(chunks=res["chunks"], prefill_tok_s=res["prefill_tok_s"],
                launches=launches, launches_expected=want,
                weight_casts=kexp.weight_bf16.casts,
                prefill_bitwise=torch.equal(logits, sync["prefill_logits"]),
                prefill_max_abs=(logits - sync["prefill_logits"]).abs()
                .max().item(),
                tokens_equal=torch.equal(res["tokens"], sync["tokens"]))
    log("sched EP serve pipeline: " + json.dumps(info))
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("pipelined EP prefill logits not finite")
    if not (info["prefill_bitwise"] and info["tokens_equal"]):
        raise SystemExit(f"pipelined EP prefill is not sync's bit for bit: "
                         f"{info}")
    if launches != want or info["chunks"] != SCHED_CHUNKS:
        raise SystemExit(f"pipelined EP serve launches {launches} differ "
                         f"from what the path calls, {want}")
    if info["weight_casts"] != 3 * n_layers:
        raise SystemExit(f"{info['weight_casts']} bf16 weight copies in the "
                         f"pipelined EP serve run")
    del res
    torch.cuda.empty_cache()
    return info


def phase_sched_parity():
    """Phase 34: one f32 step of a 2-layer full-width cut of the
    pipelined EP train (dense hier wire, 4 ranks in 2 nodes, condensation
    and migration on, 4 chunks): on the card, pipeline against sync bit
    for bit (loss, forward metrics); then card against CPU: loss within
    1e-4, migration perms, rep maps and the counters equal, every
    gradient leaf within 1e-5 by its relative norm error."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch import optim, train_lib
    from repro_torch.config import LuffyConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    P = SCHED_PARITY
    cfg = dataclasses.replace(get_config("moe-gpt2"), num_layers=P["layers"],
                              compute_dtype="float32")
    shape = ShapeConfig("t", P["S"], P["B"], "train")
    dist = make_dist(make_host_mesh(model=P["M"], nodes=P["nodes"]), "train",
                     P["B"], moe_arch=True)
    base = LuffyConfig(condense_group=128, combine_slack=2.0,
                       comm_mode="hier")
    pipe = dataclasses.replace(base, exec_mode="pipeline",
                               pipeline_chunks=SCHED_CHUNKS)
    cap = train_lib.capacity_for_bucket(cfg, shape, base, 0, dist)
    model = build_model(cfg, device="cuda", seed=0)
    batch = SyntheticLM(cfg, shape).batch(0)
    thr = torch.tensor(0.6)
    orig = tex.build_exchange_plan
    runs = {}
    for dev, luffy in (("cuda", base), ("cuda", pipe), ("cpu", pipe)):
        model.to(dev)
        plans = []

        def rec(*a, **kw):
            pl = orig(*a, **kw)
            plans.append((pl.perm.copy(), pl.condense_plan.rep_idx.cpu(),
                          pl.pipelined, pl.chunks.n_chunks))
            return pl

        tex.build_exchange_plan = rec
        try:
            model.zero_grad(set_to_none=True)
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, m = model.forward_train(tb, thr.to(dev), cap, luffy=luffy,
                                          dist=dist)
            loss.backward()
        finally:
            tex.build_exchange_plan = orig
        grads = {k: p.grad.double().cpu()
                 for k, p in optim.leaves_with_path(model.params)
                 if p.grad is not None}
        runs[(dev, luffy.exec_mode)] = (
            loss.item(), {k: v.item() for k, v in m.items()}, plans, grads)
    (ls, ms, _, _) = runs[("cuda", "sync")]
    (lg, mg, pg, gg) = runs[("cuda", "pipeline")]
    (lc, mc, pc, gc) = runs[("cpu", "pipeline")]
    card_diff = {k: (ms[k], mg[k]) for k in FWD_KEYS
                 if k in ms and ms[k] != mg[k]}
    counters = ("plans_built", "plans_reused", "condense_built",
                "condense_reused", "measured_pairs")
    leaf_rel = {k: (torch.linalg.vector_norm(gg[k] - g)
                    / torch.clamp(torch.linalg.vector_norm(g), min=1e-30))
                .item() for k, g in gc.items()}
    worst = max(leaf_rel, key=leaf_rel.get)
    info = dict(capacity=cap, pipelined=[p[2] for p in pg],
                chunks=[p[3] for p in pg], loss_cuda=lg, loss_cpu=lc,
                loss_rel=abs(lg - lc) / abs(lc),
                card_pipeline_vs_sync_differ=card_diff,
                perms_equal=len(pg) == len(pc) and all(
                    np.array_equal(a[0], b[0]) for a, b in zip(pg, pc)),
                rep_differ=sum(int((a[1] != b[1]).sum())
                               for a, b in zip(pg, pc)),
                counters_equal={k: mg[k] == mc[k] for k in counters},
                grad_leaves=len(gc), same_leaves=sorted(gg) == sorted(gc),
                grad_leaf_worst=worst, grad_leaf_worst_rel=leaf_rel[worst],
                grad_leaf_tol=SCHED_GRAD_TOL)
    log("sched parity, 2-layer f32 pipelined EP cut: " + json.dumps(info))
    if not all(info["pipelined"]) or card_diff:
        raise SystemExit(f"pipelined EP cut on the card is not sync's bit "
                         f"for bit: {info}")
    if not (info["perms_equal"] and info["rep_differ"] == 0
            and all(info["counters_equal"].values())):
        raise SystemExit(f"pipelined EP cut cuda vs cpu plans differ: {info}")
    if not (info["loss_rel"] <= 1e-4 and info["same_leaves"]
            and info["grad_leaf_worst_rel"] <= SCHED_GRAD_TOL):
        raise SystemExit(f"pipelined EP cut cuda vs cpu differ: {info}")
    del model
    torch.cuda.empty_cache()
    return info


def _merge(iv):
    """Union of [start, end) intervals, sorted and merged."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_ns(iv, union):
    """Total length of the intervals ``iv`` inside the merged ``union``."""
    tot, j = 0, 0
    for s, e in sorted(iv):
        while j < len(union) and union[j][1] <= s:
            j += 1
        k = j
        while k < len(union) and union[k][0] < e:
            tot += min(e, union[k][1]) - max(s, union[k][0])
            k += 1
    return tot


def _stream_table(prof, wall_us):
    """Per-stream device time of one profiled step from the profiler's raw
    events: each kernel, copy and memset with its stream, and the
    ``comm::`` range (a virtual-rank collective) the host op that
    launched it ran in, if any, by host thread (the main thread runs the
    forward, autograd's the recompute and the backward); K1's kernels
    (forward and backward) and how much of their time another stream was
    busy."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    ops, comm, dev = {}, [], []
    for e in evs:
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                dev.append((e.device_resource_id(), e.start_ns(),
                            e.start_ns() + e.duration_ns(), e.name(),
                            e.linked_correlation_id()))
            continue
        if e.name().startswith("comm::"):
            comm.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                         e.name()))
        elif e.linked_correlation_id() == 0:
            # a host op (a runtime call links to the op that made it)
            ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    main_thread = min(comm, key=lambda c: c[1])[0] if comm else None

    def in_comm(corr):
        op = ops.get(corr)
        if op is None:
            return None
        for t, s, e, name in comm:
            if t == op[0] and s <= op[1] < e:
                return f"{name}@{'main' if t == main_thread else 'autograd'}"
        return None

    k1_names = KERNEL_OPS["expert_ffn"] + KERNEL_OPS["expert_ffn_bwd"]
    streams = {}
    for sid, s, e, name, corr in dev:
        st = streams.setdefault(sid, dict(kernels=0, ms=0.0, comm_kernels=0,
                                          comm_ms=0.0, k1_ms=0.0, comm={},
                                          iv=[]))
        st["kernels"] += 1
        st["ms"] += (e - s) / 1e6
        st["iv"].append((s, e))
        where = in_comm(corr)
        if where:
            st["comm_kernels"] += 1
            st["comm_ms"] += (e - s) / 1e6
            c = st["comm"].setdefault(where, [0, 0.0])
            c[0] += 1
            c[1] += (e - s) / 1e6
        if any(n in name for n in k1_names):
            st["k1_ms"] += (e - s) / 1e6
    main = max(streams, key=lambda k: streams[k]["k1_ms"]) if streams \
        else None
    side = [k for k in streams if k != main]
    side_union = _merge([iv for k in side for iv in streams[k]["iv"]])
    k1_iv = [(s, e) for sid, s, e, name, _ in dev if sid == main
             and any(n in name for n in k1_names)]
    busy = _merge([(s, e) for _, s, e, _, _ in dev])
    busy_ms = sum(e - s for s, e in busy) / 1e6
    return dict(
        wall_ms=wall_us / 1e3,
        kernel_ms=sum(st["ms"] for st in streams.values()),
        busy_ms=busy_ms, busy_share=busy_ms * 1e3 / wall_us if dev else None,
        collectives_ms=sum(st["comm_ms"] for st in streams.values()),
        collectives_on_side_ms=sum(streams[k]["comm_ms"] for k in side),
        k1_ms=sum(st["k1_ms"] for st in streams.values()),
        k1_overlapped_ms=_overlap_ns(k1_iv, side_union) / 1e6,
        side_busy_ms=sum(e - s for s, e in side_union) / 1e6,
        main_stream=main,
        streams={str(k): {a: v for a, v in st.items() if a != "iv"}
                 for k, st in streams.items()})


def phase_sched_profile():
    """Phase 35: one full-width EP train step on the dense wire (phase
    31's configuration) under torch.profiler, sync and pipelined in the
    same call (each after a warm-up step of its own): wall and device ms,
    the device-busy share, the collectives' device ms, each stream's
    kernels and the share of K1's time another stream was busy. Gate:
    the pipelined step's collectives run on a second stream."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import optim, train_lib
    from repro_torch.comm.hierarchical import CommContext
    from repro_torch.config import LuffyConfig, OptimConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    cfg = get_config("moe-gpt2")
    shape = ShapeConfig("train", 1024, 8, "train")
    dist = make_dist(make_host_mesh(model=4, nodes=2), "train", 8,
                     moe_arch=True)
    ocfg = OptimConfig(lr=1e-3, total_steps=6, warmup_steps=2)
    data = SyntheticLM(cfg, shape)
    originals = {n: getattr(CommContext, n) for n in COMM_OPS}

    def wrap(name, fn):
        def inner(self, x):
            with record_function("comm::" + name):
                return fn(self, x)
        return inner

    out = {}
    for ex in ("sync", "pipeline"):
        model = build_model(cfg, device="cuda", seed=0)
        params = model.params
        luffy = LuffyConfig(condense_group=128, combine_slack=2.0,
                            comm_mode="hier", exec_mode=ex,
                            pipeline_chunks=SCHED_CHUNKS)
        cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
        step = train_lib.make_train_step(cfg, luffy, ocfg, cap, dist)
        state = [optim.init_opt_state(params, ocfg),
                 train_lib.init_luffy_state("cuda")]

        def one(i):
            b = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch(i).items()}
            _, state[0], state[1], _ = step(params, state[0], state[1], b)

        one(0)
        torch.cuda.synchronize()
        for n, fn in originals.items():
            setattr(CommContext, n, wrap(n, fn))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                one(1)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            for n, fn in originals.items():
                setattr(CommContext, n, fn)
        out[ex] = _stream_table(prof, wall_us)
        del model, params, state, step, prof
        torch.cuda.empty_cache()
    s, p = out["sync"], out["pipeline"]
    info = dict(sync=s, pipeline=p, chunks=SCHED_CHUNKS,
                device_ms_change=p["kernel_ms"] - s["kernel_ms"],
                wall_ms_change=p["wall_ms"] - s["wall_ms"],
                k1_ms_change=p["k1_ms"] - s["k1_ms"],
                k1_overlap_share=(p["k1_overlapped_ms"] / p["k1_ms"]
                                  if p["k1_ms"] else None))
    log("sched profile, EP dense step, sync vs pipeline: "
        + json.dumps(info))
    if not s["streams"] or not p["streams"]:
        raise SystemExit("sched profile: the profiler saw no device time, "
                         "so the side stream cannot be checked")
    if len(s["streams"]) != 1:
        log(f"sched profile: the sync step ran on {len(s['streams'])} "
            f"streams")
    if not (len(p["streams"]) >= 2 and p["collectives_on_side_ms"] > 0):
        raise SystemExit(f"the pipelined step's collectives did not run on "
                         f"a second stream: {p['streams']}")
    return info


def _band_pairs(S: int, causal: bool, window):
    """Live (q, k) pairs of one (b, h) under the mask by position."""
    import numpy as np
    q = np.arange(S)
    hi = q + 1 if causal else np.full(S, S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, int)
    return int((hi - lo).sum())


def _sdpa_band(q, k, v, causal, window, chunked: bool = False):
    """F.scaled_dot_product_attention with the same boolean mask (a band,
    or with ``chunked`` blocks of ``window`` positions), kv expanded: the
    yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F
    S, H = q.shape[1], q.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window and chunked:
        mask &= pos[:, None] // window == pos[None, :] // window
    elif window:
        mask &= (pos[:, None] - pos[None, :]) < window
    rep = H // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def phase_kernels_k56():
    """K5 and K6 against their plain versions on the card at hymba's
    prefill shapes and ragged ones, then timed. Returns {name: record}."""
    import torch
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import mamba_scan as kms
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(56)
    out = {}

    def qkv(B, S, H, KV, hd, dtype, q_scale=1.0):
        q, k, v = [torch.randn(s, generator=gen, device="cuda")
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
        return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)

    B, S, H, KV, hd = K5_SHAPE
    checks = []
    for name, shape, dt, causal, window, q_scale in K5_CASES:
        q, k, v = qkv(*shape, getattr(torch, dt), q_scale)
        got = kfa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        g = _k5_gate(got, want)
        ok = g["ok"]
        checks.append(dict(case=name, shape=shape, dtype=dt, causal=causal,
                           window=window, q_scale=q_scale, **g))
        log(f"  K5 {name:13s} {shape} {dt:8s} causal={causal} window="
            f"{window} q x{q_scale:g}: max|err|={g['max_abs_err']:.3e} "
            f"tol={K5_TOL[dt]:g}, row {g['max_row_rel_err']:.2e} tol "
            f"{K5_ROW_TOL[dt]:g} {'ok' if ok else 'FAIL'}")
        if name == "prefill":
            again = kfa.flash_attention(q, k, v, causal=True,
                                        window=K5_WINDOW)
            torch.cuda.synchronize()
            repeat_ok = torch.equal(got, again)
            checks.append(dict(case="prefill_repeat_bitwise", ok=repeat_ok))
            log(f"  K5 prefill, launched again: bitwise equal {repeat_ok}")
            # turns, kernel and yardstick, as in one call
            ms, lib_ms = [], []
            for _ in range(2):
                ms.append(time_ms(lambda: kfa.flash_attention(
                    q, k, v, causal=True, window=K5_WINDOW), 20, 3))
                lib_ms.append(time_ms(_sdpa_band(q, k, v, True, K5_WINDOW),
                                      20, 3))
            plain_ms = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=K5_WINDOW), 5, 1)
            pairs = B * H * _band_pairs(S, True, K5_WINDOW)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            # inputs are bf16: the bound at the bf16 tensor-core rate, the
            # f32 FMA bound (what the FMA kernel's arithmetic runs on)
            # beside
            rec = dict(ms=min(ms), plain_ms=plain_ms, library_ms=min(lib_ms),
                       ms_runs=ms, library_ms_runs=lib_ms,
                       live_pairs=pairs, max_abs_err=g["max_abs_err"],
                       max_row_rel_err=g["max_row_rel_err"],
                       **_bound(nbytes, pairs * 4.0 * hd, BF16_TC_FLOPS))
            rec["tflops_live"] = rec["flops"] / rec["ms"] / 1e9
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            out["flash_attention"] = rec
            del again
        del q, k, v, got, want
        torch.cuda.empty_cache()
    if not all(c["ok"] for c in checks):
        raise SystemExit(f"K5 disagrees with its plain version: {checks}")
    r5 = out["flash_attention"]
    r5["checks"] = checks
    log(f"  K5 [4,2048,25,64] bf16, 5 KV heads, window {K5_WINDOW}: kernel "
        f"{r5['ms']:.4f} ms (runs {r5['ms_runs']}), plain "
        f"{r5['plain_ms']:.4f} ms, SDPA (band mask) {r5['library_ms']:.4f} "
        f"ms (runs {r5['library_ms_runs']}); {r5['live_pairs']} live pairs, "
        f"{r5['flops'] / 1e9:.2f} GFLOP, {r5['bytes'] / 1e6:.1f} MB: "
        f"{r5['tflops_live']:.1f} TFLOP/s on live pairs; bound "
        f"{r5['bound_ms']:.4f} ms by {r5['bound_by']} at the bf16 "
        f"tensor-core rate ({100 * r5['bound_share']:.1f}% of it), "
        f"{r5['bound_f32_ms']:.4f} ms at f32 FMA; K5 "
        f"{'no slower than' if r5['ms'] <= r5['library_ms'] else 'SLOWER than'}"
        f" SDPA")

    checks = []
    for name, (b, s, di, n) in K6_CASES.items():
        dt = torch.rand((b, s, di), generator=gen, device="cuda") * 0.1
        x = torch.randn((b, s, di), generator=gen, device="cuda")
        bm = torch.randn((b, s, n), generator=gen, device="cuda")
        cm = torch.randn((b, s, n), generator=gen, device="cuda")
        a = -torch.exp(torch.randn((di, n), generator=gen, device="cuda"))
        y, h = kms.mamba_scan(dt, x, bm, cm, a)
        torch.cuda.synchronize()
        wy, wh = ref.mamba_scan_ref(dt, x, bm, cm, a)
        err_y = (y - wy).abs().max().item()
        err_h = (h - wh).abs().max().item()
        ok = (torch.allclose(y, wy, atol=K6_TOL, rtol=K6_TOL)
              and torch.allclose(h, wh, atol=K6_TOL, rtol=K6_TOL))
        checks.append(dict(entry="mamba_scan", case=name,
                           shape=(b, s, di, n), max_abs_err_y=err_y,
                           max_abs_err_h=err_h, ok=ok))
        log(f"  K6 {name:8s} [{b},{s},{di}]x{n}: max|err| y={err_y:.3e} "
            f"final state={err_h:.3e} tol={K6_TOL:g} "
            f"{'ok' if ok else 'FAIL'}")
        if name == "prefill":
            del wy, wh
            torch.cuda.empty_cache()
            args = (dt, x, bm, cm, a)
            ms = time_ms(lambda: kms.mamba_scan(*args), 10, 2)
            dev_ms = device_ms(lambda: kms.mamba_scan(*args), 10)
            plain_ms = time_ms(lambda: ref.mamba_scan_ref(*args), 2, 1)
            upd = b * s * di * n
            nbytes = 4 * (3 * dt.numel() + 2 * bm.numel() + a.numel()
                          + h.numel())
            # per state update on the FMA pipes: dt*a, *h, +, dt*x, *B, *C,
            # + (the sum over the state): 7 FLOPs; on the special-function
            # unit: one ex2
            rec = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=None, state_updates=upd,
                       max_abs_err=max(err_y, err_h),
                       **_bound_sfu(nbytes, 7.0 * upd, upd))
            rec["bound_share_device"] = rec["bound_ms"] / dev_ms
            out["mamba_scan"] = rec
        del dt, x, bm, cm, a, y, h
        torch.cuda.empty_cache()

    # the fused entry, with its operands as _mamba_inner passes them: z the
    # second half of one [B,S,2di] product, B and C column slices of one
    # projection (dt_rank 100, hymba's)
    for name, (b, s, di, n) in K6_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            def rn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            xb, z = torch.chunk(rn(b, s, 2 * di).to(dtype), 2, dim=-1)
            _, bm, cm = torch.split(rn(b, s, 100 + 2 * n), [100, n, n], -1)
            args = (rn(b, s, di) - 1.0, rn(di) * 0.5, xb.contiguous(), z,
                    rn(di), bm, cm, -torch.exp(rn(di, n)))
            y, h = kms.mamba_scan_fused(*args)
            torch.cuda.synchronize()
            wy, wh = ref.mamba_scan_fused_ref(*args)
            err_y = (y.float() - wy.float()).abs().max().item()
            err_h = (h - wh).abs().max().item()
            ok_h = torch.allclose(h, wh, atol=K6_TOL, rtol=K6_TOL)
            bf = {}
            if dtype == torch.float32:
                ok = ok_h and torch.allclose(y, wy, atol=K6_TOL, rtol=K6_TOL)
            else:
                # one bf16 ulp plus the f32 gate: the rounding of two values
                # within 2e-5; how far one ulp alone would reach, beside it
                ulps = _bf16_ulps(y, wy)
                bf = dict(max_bf16_ulps=ulps.max().item(),
                          n_over_1_ulp=int((ulps > 1).sum()),
                          max_over_ulp_plus_gate=_bf16_ulps(
                              y, wy, K6_TOL).max().item())
                ok = ok_h and bf["max_over_ulp_plus_gate"] <= 1.0
            dname = str(dtype)[6:]
            checks.append(dict(entry="mamba_scan_fused", case=name,
                               shape=(b, s, di, n), dtype=dname,
                               max_abs_err_y=err_y, max_abs_err_h=err_h,
                               **bf, ok=ok))
            log(f"  K6 fused {name:8s} [{b},{s},{di}]x{n} {dname:8s}: "
                f"max|err| y={err_y:.3e}"
                + (f" ({bf['max_bf16_ulps']:g} bf16 ulps at most, "
                   f"{bf['n_over_1_ulp']} elements over one; over one ulp "
                   f"+ the f32 gate {bf['max_over_ulp_plus_gate']:.3f}, "
                   f"tol 1)" if bf else f" (tol {K6_TOL:g})")
                + f" final state={err_h:.3e} {'ok' if ok else 'FAIL'}")
            if name == "prefill" and dtype == torch.bfloat16:
                del wy, wh
                torch.cuda.empty_cache()
                ms = time_ms(lambda: kms.mamba_scan_fused(*args), 10, 2)
                dev_ms = device_ms(lambda: kms.mamba_scan_fused(*args), 10)
                plain_ms = time_ms(lambda: ref.mamba_scan_fused_ref(*args),
                                   2, 1)
                el, upd = b * s * di, b * s * di * n
                # per element: dt_lin 4 B in, x and z 2 B each in, y 2 B
                # out; B and C rows, a, the bias and skip, the final state
                nbytes = (el * (4 + 2 + 2 + 2) + 4 * 2 * b * s * n
                          + 4 * (di * n + 2 * di + b * di * n))
                # FMA pipes: the scan's 7 FLOPs per update, per element the
                # bias add, max and add of softplus, dt*x, the skip's two,
                # silu's add and the gate; special-function unit: one ex2
                # per update, softplus's exp and log and silu's exp per
                # element
                rec = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           library_ms=None, state_updates=upd, elements=el,
                           **_bound_sfu(nbytes, 7.0 * upd + 8.0 * el,
                                        upd + 3.0 * el))
                rec["bound_share_device"] = rec["bound_ms"] / dev_ms
                out["mamba_scan_fused"] = rec
            del args, xb, z, bm, cm, y, h
            torch.cuda.empty_cache()
    if not all(c["ok"] for c in checks):
        raise SystemExit(f"K6 disagrees with its plain version: "
                         f"{[c for c in checks if not c['ok']]}")
    b, s, di, n = K6_SHAPE
    for key, what in (("mamba_scan", "[4,2048,3200]x16 f32"),
                      ("mamba_scan_fused", "[4,2048,3200]x16 bf16 x, z, y")):
        r6 = out[key]
        occ = kms.occupancy(key == "mamba_scan_fused", torch.bfloat16
                            if key == "mamba_scan_fused" else torch.float32)
        blocks = b * -(-di // (occ["threads_per_block"] * 4 // n))
        r6["occupancy"] = dict(occ, grid_blocks=blocks,
                               grid_blocks_per_sm=blocks / SMS,
                               achieved="not measured (no ncu here)")
        log(f"  K6 {key}: {occ['blocks_per_sm']} blocks of "
            f"{occ['threads_per_block']} threads ({occ['warps_per_sm']} "
            f"warps, {occ['smem_per_block']} B shared each) fit an SM; the "
            f"grid's {blocks} blocks give {blocks / SMS:.2f} per SM")
        r6["max_abs_err"] = max(c["max_abs_err_y"] for c in checks
                                if c["entry"] == key and
                                c.get("dtype", "float32") == "float32")
        r6["checks"] = [c for c in checks if c["entry"] == key]
        log(f"  K6 {key} {what}: kernel {r6['ms']:.4f} ms by CUDA events, "
            f"{r6['device_ms']:.4f} ms of device time, plain "
            f"{r6['plain_ms']:.4f} ms (no one PyTorch call computes it); "
            f"{r6['bytes'] / 1e6:.1f} MB, {r6['sfu_ops'] / 1e6:.1f} M "
            f"special-function ops; bound {r6['bound_ms']:.4f} ms by "
            f"{r6['bound_by']} (bytes {r6['bound_bytes_ms']:.4f}, FMA "
            f"{r6['bound_fma_ms']:.4f}, special-function "
            f"{r6['bound_sfu_ms']:.4f} at {r6['sm_clock_mhz']:.0f} MHz), "
            f"{100 * r6['bound_share_device']:.1f}% of it")
    return out


def _k5_gate(got, want):
    """K5 against its plain version: the elementwise gate (``K5_TOL``,
    absolute and relative) and the largest relative error of a query
    row's output (``K5_ROW_TOL``); ``ok`` when both hold."""
    import torch
    g, w = got.float(), want.float()
    dt = str(want.dtype)[6:]
    err = (g - w).abs().max().item()
    row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
    elem_ok = bool(torch.allclose(g, w, atol=K5_TOL[dt], rtol=K5_TOL[dt]))
    return dict(max_abs_err=err, tol=K5_TOL[dt], max_row_rel_err=row,
                row_tol=K5_ROW_TOL[dt], elementwise_ok=elem_ok,
                ok=elem_ok and row <= K5_ROW_TOL[dt])


def _bf16_ulps(got, want, tol=0.0):
    """|got - want| over one bf16 ulp of the larger magnitude of the two
    plus ``tol * (1 + |want|)``, elementwise."""
    import torch
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    return (g - w).abs() / (ulp + tol * (1.0 + w.abs()))


def phase_hymba_slice():
    """Phase 16: full-width hymba-1.5b (random weights from a seed). At
    full depth, the serving engine's batched prefill of [4, 2048] twice
    (a warm-up and a timed one) with every kernel counter set to 0 just
    before and read just after: K5 and K6 exactly 32 launches each a
    prefill, every K6 launch through its fused entry. Then a full-width
    cut of ``HYMBA_FEED["layers"]`` layers: its batched prefill against
    the step feed of the same prompt, longer than the 1024 window (the
    ring wraps), and 32 greedy tokens, neither of which launches K5 or
    K6; the last prompt token's logits of the two agree."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("hymba-1.5b")
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    P, F = HYMBA_PREFILL, HYMBA_FEED
    counters = _kernel_counters()
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (P["B"], P["S"])), dtype=torch.int32,
        device="cuda")
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    model.prefill(toks, P["S"], luffy=luffy)                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model.prefill(toks, P["S"], luffy=luffy)[0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: 0 for k in counters}
    want["flash_attention"] = want["mamba_scan"] = \
        want["mamba_scan_fused"] = 2 * cfg.num_layers
    finite = bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()

    ccfg = dataclasses.replace(cfg, num_layers=F["layers"])
    model = build_model(ccfg, device="cuda", seed=0)
    prompt = toks[:, :F["S"]]
    lg_batch = model.prefill(prompt, F["S"] + F["gen"], luffy=luffy)[0]
    for fn in counters.values():
        fn.launches = 0
    cache = model.new_cache(P["B"], F["S"] + F["gen"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(F["S"]):
        lg, cache = model.decode_step(cache, prompt[:, t:t + 1],
                                      luffy=luffy)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    feed_vs_batch = (lg.float() - lg_batch).abs().max().item()
    out = []
    t0 = time.perf_counter()
    for _ in range(F["gen"]):
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        out.append(nxt[:, 0])
        lg, cache = model.decode_step(cache, nxt, luffy=luffy)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    feed_launches = {k: fn.launches for k, fn in counters.items()}
    finite = finite and bool(torch.isfinite(lg).all())
    info = dict(arch=cfg.name, batch=P["B"], prompt_len=P["S"],
                prefill_s=prefill_s, prefill_tok_s=P["B"] * P["S"]
                / prefill_s, peak_mem_gib=peak / 2 ** 30,
                launches=launches, launches_expected=want,
                feed_layers=F["layers"], feed_prompt_len=F["S"],
                prompt_feed_s=feed_s,
                prompt_feed_ms_per_step=feed_s / F["S"] * 1e3,
                decode_ms_per_step=decode_s / F["gen"] * 1e3,
                feed_and_decode_launches=feed_launches,
                feed_vs_batch_max_abs=feed_vs_batch,
                logits_max_abs=lg_batch.abs().max().item(),
                sample_tokens=torch.stack(out, 1)[0, :10].tolist())
    log("hymba slice: " + json.dumps(info))
    if not finite:
        raise SystemExit("hymba logits are not finite")
    if launches != want:
        raise SystemExit(f"hymba kernel launches {launches} differ from what "
                         f"the prefill calls, {want}")
    if any(feed_launches.values()):
        raise SystemExit(f"the step feed or decode launched {feed_launches}")
    if not feed_vs_batch <= HYMBA_FEED_TOL:
        raise SystemExit(f"hymba step-fed and batched logits differ by "
                         f"{feed_vs_batch} (tol {HYMBA_FEED_TOL})")
    del model, cache
    torch.cuda.empty_cache()
    return info


def phase_hymba_paths():
    """A 4-layer full-width hymba cut at f32 compute: the batched prefill
    (K5 + K6) against the step feed (attn_decode + mamba_step, which
    launch neither) past the window; then reduced hymba at f32 with GQA
    kept (2 KV heads), card against CPU."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import mamba_scan as kms
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    P = HYMBA_PATHS
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              num_layers=P["layers"], compute_dtype="float32")
    model = build_model(cfg, device="cuda", seed=0)
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        1, cfg.vocab_size, (P["B"], P["S"])), device="cuda")
    before = (kfa.flash_attention.launches, kms.mamba_scan.launches)
    lg_batch = model.prefill(toks, P["S"], luffy=luffy)[0]
    mid = (kfa.flash_attention.launches, kms.mamba_scan.launches)
    cache = model.new_cache(P["B"], P["S"])
    for t in range(P["S"]):
        lg_feed, cache = model.decode_step(cache, toks[:, t:t + 1],
                                           luffy=luffy)
    after = (kfa.flash_attention.launches, kms.mamba_scan.launches)
    err = (lg_feed - lg_batch).abs().max().item()
    info = dict(layers=P["layers"], batch=P["B"], prompt_len=P["S"],
                feed_vs_batch_max_abs=err, tol=HYMBA_PATHS_TOL,
                logits_max_abs=lg_batch.abs().max().item(),
                prefill_launches=[m - b for m, b in zip(mid, before)],
                feed_launches=[a - m for a, m in zip(after, mid)])
    del model, cache
    torch.cuda.empty_cache()

    rcfg = reduced(get_config("hymba-1.5b"))
    rcfg = dataclasses.replace(rcfg, compute_dtype="float32",
                               attn=dataclasses.replace(rcfg.attn,
                                                        num_kv_heads=2))
    model = build_model(rcfg, device="cuda", seed=0)
    rt = torch.as_tensor(np.random.default_rng(10).integers(
        1, rcfg.vocab_size, (2, 128)))
    lg = model.prefill(rt.cuda(), 128, luffy=luffy)[0].cpu()
    model.to("cpu")               # the same parameters, moved
    lc = model.prefill(rt, 128, luffy=luffy)[0]
    info.update(reduced_cuda_vs_cpu_max_abs=(lg - lc).abs().max().item(),
                reduced_tol=HYMBA_PARITY_TOL,
                reduced_logits_max_abs=lc.abs().max().item())
    log("hymba paths: " + json.dumps(info))
    n = P["layers"]
    if info["prefill_launches"] != [n, n] or info["feed_launches"] != [0, 0]:
        raise SystemExit(f"hymba paths launched K5/K6 {info}")
    if not err <= HYMBA_PATHS_TOL:
        raise SystemExit(f"f32 batched prefill and step feed differ: {info}")
    if not info["reduced_cuda_vs_cpu_max_abs"] <= HYMBA_PARITY_TOL:
        raise SystemExit(f"reduced hymba cuda vs cpu differ: {info}")
    return info


def phase_hymba_profile():
    """Full-width hymba batched prefills (B=4, S=2048) after a warm-up:
    three on the host clock to a synchronise (tokens/s), then one under
    torch.profiler: device-busy share, the top-10 device ops, K5's and
    K6's shares of the device time."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("hymba-1.5b")
    model = build_model(cfg, device="cuda", seed=0)
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 2048)), dtype=torch.int32, device="cuda")
    model.prefill(toks, 2080, luffy=luffy)
    torch.cuda.synchronize()
    wall_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.prefill(toks, 2080, luffy=luffy)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(toks, 2080, luffy=luffy)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    ops = {"flash_attention": ("flash_kernel", "flash_wgmma_kernel"),
           "mamba_scan": ("mamba_scan_kernel",)}
    shares = {k: sum(d for d, key, _ in rows if any(n in key for n in o))
              / busy if busy else None for k, o in ops.items()}
    info = dict(prefill_wall_ms=wall_ms,
                tokens_per_s=[4 * 2048 / w * 1e3 for w in wall_ms],
                wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
                device_busy_share=busy / wall_us if rows else None,
                kernel_share=shares,
                top=[{"op": k[:60], "ms": d / 1e3, "count": c}
                     for d, k, c in rows[:10]])
    log("hymba profile: " + json.dumps(info))
    log(f"hymba prefill: {min(wall_ms):.1f} ms best of 3, "
        f"{max(info['tokens_per_s']):.0f} tokens/s")
    if shares["flash_attention"] is not None:
        log(f"hymba profile: K5 {100 * shares['flash_attention']:.1f}% of "
            f"the prefill's device time, K6 (fused) "
            f"{100 * shares['mamba_scan']:.1f}%")
    if not rows:
        log("hymba profile: the profiler saw no device time (not measured)")
    del model
    torch.cuda.empty_cache()
    return info


_K6_KEYS = ("device_ms", "bound_share_device", "bound_bytes_ms",
            "bound_fma_ms", "bound_sfu_ms", "sm_clock_mhz", "occupancy")


def phase_ep_serve(one):
    """Full-width moe-gpt2 served over 4 virtual ranks through the
    launcher (``--model-axis 4``: the batched prefill sequence-sharded,
    the decode the one-device one, which the reference's all-reduce
    decode equals on virtual ranks), with every kernel counter set to 0
    just before and read just after; its decode bit for bit the M = 1 run
    of phase 4 (``one``: same seed, same prompts); then where its time
    goes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import serve
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    kexp.weight_bf16.casts = 0
    res = serve.main(EP_SERVE_ARGS)
    launches = {k: fn.launches for k, fn in counters.items()}
    casts = kexp.weight_bf16.casts
    n_layers = get_config("moe-gpt2").num_layers
    B, S, G = res["batch"], res["prompt_len"], res["gen"]
    # one K1 launch per MoE sublayer in each of the 2 batched prefills
    # (every rank's rows in one [M * E/M, C, d] call), S step-fed and G
    # greedy decode steps ([E, C, d]): 12 x (2 + 128 + 32) = 1944
    want = dict.fromkeys(launches, 0)
    want["expert_ffn"] = n_layers * (serve.N_BATCHED_PREFILLS + S + G)
    # the batched prefills' attention on K5 (since slice 17)
    want["flash_attention"] = n_layers * serve.N_BATCHED_PREFILLS
    step = torch.stack(res["step_logits"]).cpu()
    gen = torch.stack(res["gen_logits"]).cpu()
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (step, gen, res["prefill_logits"]))
    same_tokens = torch.equal(res["tokens"], one["tokens"])
    bitwise = bool(same_tokens and torch.equal(step, one["step"])
                   and torch.equal(gen, one["gen"]))
    step_err = (step - one["step"]).abs().max().item()
    gen_err = (gen - one["gen"]).abs().max().item() if same_tokens else None
    info = dict(model_axis=res["model_axis"], batch=B, prompt_len=S, gen=G,
                prefill_s=res["prefill_s"],
                prefill_tok_s=res["prefill_tok_s"],
                prompt_feed_s=res["prompt_feed_s"],
                decode_ms_per_step=res["decode_ms_per_step"],
                peak_mem_gib=res["peak_mem_bytes"] / 2 ** 30,
                launches=launches, launches_expected=want,
                weight_casts=casts, weight_casts_expected=3 * n_layers,
                decode_vs_m1_bitwise=bitwise,
                step_fed_vs_m1_max_abs=step_err,
                greedy_tokens_equal_m1=same_tokens,
                greedy_vs_m1_max_abs=gen_err,
                # the prefill's per-rank capacity drops other tokens than
                # one rank's does, so it is not held to M = 1
                prefill_vs_m1_max_abs=(res["prefill_logits"].cpu()
                                       - one["prefill"]).abs().max().item())
    log("EP serve: " + json.dumps(info))
    if not finite:
        raise SystemExit("EP serve logits not finite")
    if launches != want:
        raise SystemExit(f"EP serve kernel launches {launches} differ from "
                         f"what the path calls, {want}")
    if casts != 3 * n_layers:
        raise SystemExit(f"{casts} bf16 weight casts in the EP serve run, "
                         f"not one per expert weight tensor")
    if not bitwise:
        raise SystemExit(f"EP decode is not the M = 1 decode bit for bit: "
                         f"{info}")
    # the sync prefill's logits and tokens, for phase 33 (not logged)
    sync = {"prefill_logits": res["prefill_logits"].cpu(),
            "tokens": res["tokens"]}
    del res, step, gen
    torch.cuda.empty_cache()
    info["profile"] = phase_profile(model_axis=4)
    info["sync"] = sync
    return info


def phase_ep_serve_parity():
    """A 2-layer full-width cut served over 4 virtual ranks on the card
    (kernels) and on the CPU (plain versions), same weights and tokens:
    the sequence-sharded prefill and 8 decode steps. The prompt is three
    token ids, which piles the routing onto a few experts and overflows a
    rank's capacity, so which tokens drop depends on a rank's token
    order; the run fails unless some rank dropped some."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    P = EP_SERVE_PARITY
    cfg = dataclasses.replace(get_config("moe-gpt2"), num_layers=P["layers"])
    model = build_model(cfg, device="cuda", seed=0)
    pdist = make_dist(make_host_mesh(model=P["M"]), "prefill", P["B"],
                      moe_arch=True)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        1, 4, (P["B"], P["S"])), dtype=torch.int32)
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    out, drops = {}, {}
    orig = tex.build_exchange_plan
    for dev in ("cuda", "cpu"):
        model.to(dev)
        t = toks.to(dev)
        rec = []

        def plan(*a, **kw):
            pl = orig(*a, **kw)
            rec.append(pl.dispatch_drop.float().cpu())
            return pl

        tex.build_exchange_plan = plan
        try:
            lg = [model.prefill(t, P["S"], luffy=luffy, dist=pdist)[0]]
        finally:
            tex.build_exchange_plan = orig
        drops[dev] = torch.stack(rec)                 # [layers, M]
        cache = model.new_cache(P["B"], P["S"])
        for i in range(P["steps"]):
            lg.append(model.decode_step(cache, t[:, i:i + 1],
                                        luffy=luffy)[0])
        out[dev] = torch.stack(lg).float().cpu()
    err = (out["cuda"] - out["cpu"]).abs().amax(dim=(1, 2)).tolist()
    info = dict(prefill_max_abs=err[0], decode_max_abs=max(err[1:]),
                tol=PARITY_TOL, logits_max=out["cpu"].abs().max().item(),
                dispatch_drop_cuda=drops["cuda"].tolist(),
                dispatch_drop_cpu=drops["cpu"].tolist())
    log("EP serve parity, 2-layer cut, cuda vs cpu: " + json.dumps(info))
    if not all(math.isfinite(e) and e <= PARITY_TOL for e in err):
        raise SystemExit(f"EP serve cuda vs cpu differ: {err}")
    if not (drops["cuda"].shape == (P["layers"], P["M"])
            and float(drops["cuda"].max()) > 0.0):
        raise SystemExit(f"the EP serve parity prompt dropped no token on "
                         f"any rank: {info}")
    del model
    torch.cuda.empty_cache()
    return info


def phase_seq_train():
    """Full-width moe-gpt2 trained sequence-sharded over 4 virtual ranks
    (6 sequences do not split over 4; condensation and migration off) with
    exact launch counts; then one f32 step of a 2-layer cut on the card
    against the CPU."""
    import torch
    from repro_torch import optim, train_lib
    from repro_torch.config import LuffyConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    kexp.weight_bf16.casts = kexp.weight_bf16.lo_casts = 0
    res, launches, _, _ = _ep_run(SEQ_TRAIN_ARGS)
    casts, lo_casts = kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts
    cfg, steps = res["cfg"], res["steps"]
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    # the vanilla exchange without condensation: K1 and its backward only
    want = dict.fromkeys(launches, 0)
    want["expert_ffn"] = n_moe * (2 if cfg.remat else 1) * len(steps)
    want["expert_ffn_bwd"] = n_moe * len(steps)
    info = dict(seq_sharded=res["dist"].seq_sharded,
                condensation=res["luffy"].enable_condensation,
                migration=res["luffy"].enable_migration,
                global_batch=res["global_batch"], seq_len=res["seq_len"],
                losses=[st["loss"] for st in steps],
                dispatch_drop=[st["dispatch_drop"] for st in steps],
                capacity=steps[0]["capacity"],
                step_ms=[st["step_ms"] for st in steps],
                peak_mem_gib=max(st["peak_mem_bytes"] for st in steps)
                / 2 ** 30, launches=launches, launches_expected=want,
                weight_casts=casts, weight_lo_casts=lo_casts,
                weight_casts_expected=3 * n_moe * len(steps))
    log("seq-sharded train: " + json.dumps(info))
    if not info["seq_sharded"] or info["condensation"] or info["migration"]:
        raise SystemExit(f"not the sequence-sharded train shape: {info}")
    if not all(math.isfinite(x) for x in info["losses"]):
        raise SystemExit(f"seq-sharded train losses not finite: {info}")
    if launches != want:
        raise SystemExit(f"seq-sharded train launches {launches} differ "
                         f"from what the path calls, {want}")
    if casts != info["weight_casts_expected"] \
            or lo_casts != info["weight_casts_expected"]:
        raise SystemExit(f"{casts} / {lo_casts} bf16 weight casts in the "
                         f"seq-sharded train run")
    del res, steps
    torch.cuda.empty_cache()

    P = SEQ_TRAIN_PARITY
    cfg = dataclasses.replace(get_config("moe-gpt2"), num_layers=P["layers"],
                              compute_dtype="float32")
    shape = ShapeConfig("t", P["S"], P["B"], "train")
    dist = make_dist(make_host_mesh(model=P["M"]), "train", P["B"],
                     moe_arch=True)
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
    model = build_model(cfg, device="cuda", seed=0)
    batch = SyntheticLM(cfg, shape).batch(0)
    runs = {}
    for dev in ("cuda", "cpu"):
        model.to(dev)
        model.zero_grad(set_to_none=True)
        loss, m = model.forward_train(
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            torch.tensor(0.6, device=dev), cap, luffy=luffy, dist=dist)
        loss.backward()
        grads = {k: p.grad.double().cpu()
                 for k, p in optim.leaves_with_path(model.params)
                 if p.grad is not None}
        runs[dev] = (loss.item(), grads, m["dispatch_drop"].item())
    (lg, gg, dg), (lc, gc, dc) = runs["cuda"], runs["cpu"]
    # every gradient leaf by its relative norm error, as
    # tests/test_torch_ep_serve.py holds the CPU's against jax.grad
    leaf_rel = {k: (torch.linalg.vector_norm(gg[k] - g)
                    / torch.clamp(torch.linalg.vector_norm(g), min=1e-30))
                .item() for k, g in gc.items()}
    worst = max(leaf_rel, key=leaf_rel.get)
    par = dict(loss_cuda=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
               grad_leaves=len(gc), same_leaves=sorted(gg) == sorted(gc),
               grad_leaf_worst=worst, grad_leaf_worst_rel=leaf_rel[worst],
               grad_leaf_tol=SEQ_TRAIN_GRAD_TOL, dispatch_drop_cuda=dg,
               dispatch_drop_cpu=dc, capacity=cap)
    log("seq-sharded train parity, 2-layer f32 cut, cuda vs cpu: "
        + json.dumps(par))
    if not (par["loss_rel"] <= 1e-4 and par["same_leaves"]
            and par["grad_leaf_worst_rel"] <= SEQ_TRAIN_GRAD_TOL):
        raise SystemExit(f"seq-sharded train cuda vs cpu differ: {par}")
    info["parity"] = par
    del model
    torch.cuda.empty_cache()
    return info


def phase_reuse_kernels():
    """Phase 22a: K2's fused entry restricted to LSH buckets (the CODES
    instances) against its plain version, then timed in turns with the
    exact entry."""
    import numpy as np
    import torch
    from repro_torch.condense.backends import lsh_codes
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import similarity as ksim
    # no spill in the CODES instances (both kernels, RULES and CODES true)
    reps = [r for r in _ptxas_report(_build.BUILD_LOG.get("similarity", ""),
                                     "sim_") if "Lb1ELb1E" in r["entry"]]
    for r in reps:
        log(f"  K2 CODES instance {r['entry']}: {r.get('registers')} "
            f"registers, spill stores / loads {r.get('spill_stores')} / "
            f"{r.get('spill_loads')} bytes")
    if any(r.get("spill_stores") or r.get("spill_loads") for r in reps):
        raise SystemExit(f"register spills in K2's CODES instances: {reps}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    r = np.random.default_rng(22)
    top2 = torch.as_tensor(r.integers(0, E, (K2_GROUPS * K2_G, 2)),
                           device="cuda")
    expert = top2[:, 0].reshape(K2_GROUPS, K2_G)   # the path's strided ids
    centres = torch.randn((E, D), generator=gen, device="cuda")
    cid = torch.as_tensor(r.integers(0, E, (K2_GROUPS, K2_G)), device="cuda")
    x0 = centres[cid] + 0.6 * torch.randn((K2_GROUPS, K2_G, D),
                                          generator=gen, device="cuda")
    first = torch.full((K2_GROUPS, K2_G, K2_G), 0.5, device="cuda")
    carried = ref.masked_similarity_fused_ref(x0, expert, first, K2_S1,
                                              K2_S2)[0].contiguous()
    same = expert[:, :, None] == expert[:, None, :]
    xs = {"bfloat16": x0.to(torch.bfloat16), "float32": x0}
    checks = []
    for bits in (8, 1):
        code = lsh_codes(xs["bfloat16"], bits=bits)
        bucket = code[:, :, None] == code[:, None, :]
        for sp_name, sp in (("carried", carried), ("none", None)):
            for x_name, x in xs.items():
                c = code if x_name == "bfloat16" else lsh_codes(x, bits=bits)
                sim, frac = ksim.masked_similarity_fused(
                    x, expert, sp, K2_S1, K2_S2, code=c)
                torch.cuda.synchronize()
                want, wfrac = ref.masked_similarity_fused_ref(
                    x, expert, sp, K2_S1, K2_S2, c)
                unc = same if sp is None else \
                    same & ~(sp > K2_S1) & ~(sp < K2_S2)
                cb = bucket if x_name == "bfloat16" else \
                    c[:, :, None] == c[:, None, :]
                measured = unc & cb
                exact = bool(torch.equal(sim[~measured], want[~measured]))
                err = (sim[measured] - want[measured]).abs().max().item()
                frac_eq = bool(torch.equal(frac, wfrac))
                again = ksim.masked_similarity_fused(x, expert, sp, K2_S1,
                                                     K2_S2, code=c)
                rep = bool(torch.equal(again[0], sim)
                           and torch.equal(again[1], frac))
                tiles = measured.reshape(K2_GROUPS, 2, 64, 2, 64) \
                    .any(dim=(2, 4))
                ok = exact and err <= K2_TOL and frac_eq and rep
                checks.append(dict(
                    bits=bits, s_prev=sp_name, x=x_name,
                    route=ksim.route(x.dtype, D),
                    uncertain_share=unc.float().mean().item(),
                    measured_share=measured.float().mean().item(),
                    live_64x64_tiles=int(tiles.sum()),
                    unmeasured_bitwise=exact, max_abs_err=err,
                    measured_frac_bitwise=frac_eq, repeat_bitwise=rep,
                    ok=ok))
                log(f"  K2 lsh bits={bits} s_prev={sp_name:7s} x={x_name:8s}"
                    f": uncertain {unc.float().mean().item():.4f}, measured "
                    f"{measured.float().mean().item():.4f} of the pairs, "
                    f"{int(tiles.sum())} of {tiles.numel()} 64 x 64 tiles "
                    f"live; the rest bitwise {exact}, measured max|err|="
                    f"{err:.3e} tol={K2_TOL:g}, measured_frac bitwise "
                    f"{frac_eq}, repeats {rep} {'ok' if ok else 'FAIL'}")
    if not all(c["ok"] for c in checks):
        raise SystemExit(f"K2's LSH instances disagree with their plain "
                         f"version: {[c for c in checks if not c['ok']]}")
    # timed at bf16 with the carried s_prev, in turns with the exact entry
    x = xs["bfloat16"]
    codes = {b: lsh_codes(x, bits=b) for b in (8, 1)}
    fns = {"exact": lambda: ksim.masked_similarity_fused(
        x, expert, carried, K2_S1, K2_S2)}
    for b, c in codes.items():
        fns[f"lsh{b}"] = (lambda c=c: ksim.masked_similarity_fused(
            x, expert, carried, K2_S1, K2_S2, code=c))
    turns = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            turns[k].append(device_ms(fn, 50))
    c8 = codes[8]
    meas = same & ~(carried > K2_S1) & ~(carried < K2_S2) \
        & (c8[:, :, None] == c8[:, None, :])
    f_tiles = int(meas.reshape(K2_GROUPS, 2, 64, 2, 64).any(dim=(2, 4))
                  .sum())
    f_groups = int(meas.any(dim=(1, 2)).sum())
    ms = time_ms(fns["lsh8"], 50)
    plain = time_ms(lambda: ref.masked_similarity_fused_ref(
        x, expert, carried, K2_S1, K2_S2, c8), 50)
    nbytes = (f_groups * K2_G * D * x.element_size() + expert.numel() * 8
              + 4 * carried.numel() + 4 * c8.numel() + 4 * carried.numel()
              + 4 * K2_GROUPS)
    rec = dict(ms=ms, device_ms=turns["lsh8"][-1], plain_ms=plain,
               library_ms=None, route=ksim.route(x.dtype, D),
               tile=ksim.TILES[ksim.route(x.dtype, D)],
               computed_tiles=f_tiles, live_groups=f_groups,
               measured_share=meas.float().mean().item(),
               **_bound(nbytes, f_tiles * 64 * 64 * D * 2.0, BF16_TC_FLOPS),
               device_ms_in_turns=turns,
               max_abs_err=max(c["max_abs_err"] for c in checks),
               checks=checks, ptxas=reps)
    rec["bound_share_device"] = rec["bound_ms"] / rec["device_ms"]
    log(f"  K2 lsh bits=8 (carried s_prev): {rec['device_ms']:.4f} ms of "
        f"device time ({100 * rec['bound_share_device']:.1f}% of the bound)"
        f", events {ms:.4f} ms, plain {plain:.4f} ms; {f_tiles} of "
        f"{K2_GROUPS * 4} 64 x 64 tiles and {f_groups} groups live; bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({nbytes / 1e6:.2f} "
        f"MB); device ms in turns {json.dumps(turns)}")
    del x0, xs, carried, first
    torch.cuda.empty_cache()
    return rec


def phase_reuse_ep(ep_info, ep_prof):
    """Phase 22b: phase 11's EP run with plan reuse, condense reuse and
    the lsh backend: launch counts from the step records, the
    shipped-bytes law, a bitwise repeat; then phase 14's profile with the
    same flags."""
    import statistics
    import numpy as np
    import torch
    res, launches, plans, greedy = _ep_run(EP_REUSE_ARGS)
    cfg, steps, luffy = res["cfg"], res["steps"], res["luffy"]
    n = len(steps)
    remat = 2 if cfg.remat else 1
    built = [st["condense_built"] for st in steps]
    k2 = int(round(sum(built))) * remat
    want = _ep_expected(cfg, n, f8=True)
    want.update(masked_similarity=k2, masked_similarity_fused=k2,
                masked_similarity_fused_lsh=k2)
    greedy_want = int(round(sum(st["plans_built"] for st in steps))) * remat
    for st in steps:
        log(f"  EP reuse step {st['step']}: loss {st['loss']:.5f} plans "
            f"{st['plans_built']:.0f}/{st['plans_reused']:.0f} condense "
            f"{st['condense_built']:.0f}/{st['condense_reused']:.0f} "
            f"measured_pairs {st['measured_pairs']:.0f} condense_rate "
            f"{st['condense_rate']:.5f} bucket {st['bucket']} (C="
            f"{st['capacity']}) {st['step_ms']:.1f} ms (phase 11: "
            f"{ep_info['per_step']['step_ms'][st['step']]:.1f} ms, rate "
            f"{ep_info['per_step']['condense_rate'][st['step']]:.5f}, "
            f"bucket {ep_info['per_step']['bucket'][st['step']]}, "
            f"measured_pairs "
            f"{ep_info['per_step']['measured_pairs'][st['step']]:.0f})")
    keys = ("loss", "plans_built", "plans_reused", "plan_reuse_mismatch",
            "condense_built", "condense_reused", "measured_pairs",
            "condense_rate", "bucket", "local_frac", "inter_bytes_shipped",
            "step_ms")
    med = statistics.median(st["step_ms"] for st in steps[1:])
    info = dict(flags=REUSE_FLAGS, per_step={k: [st[k] for st in steps]
                                             for k in keys},
                median_step_ms_after_0=med,
                median_step_ms_after_0_phase11=ep_info[
                    "median_step_ms_after_0"],
                peak_mem_gib=max(st["peak_mem_bytes"] for st in steps)
                / 2 ** 30, launches=launches, launches_expected=want,
                greedy_calls=greedy, greedy_calls_expected=greedy_want,
                plans=len(plans))
    log("EP reuse train: " + json.dumps(info))
    if not all(math.isfinite(x) for x in info["per_step"]["loss"]):
        raise SystemExit(f"EP reuse losses not finite: {info}")
    bad = _check_law(steps, luffy, cfg)
    if bad:
        raise SystemExit(f"shipped-bytes law broken under reuse: {bad}")
    if launches != want:
        raise SystemExit(f"EP reuse launches {launches} differ from what the "
                         f"step records call for, {want}")
    if greedy != greedy_want:
        raise SystemExit(f"{greedy} greedy calls, the step records say "
                         f"{greedy_want}")
    del res, steps
    torch.cuda.empty_cache()
    again, _, plans2, _ = _ep_run(EP_REUSE_ARGS)
    same = {k: [st[k] for st in again["steps"]] == info["per_step"][k]
            for k in ("loss", "condense_rate", "bucket", "measured_pairs")}
    same["perms"] = len(plans) == len(plans2) and all(
        (a[0] is None and b[0] is None) or np.array_equal(a[0], b[0])
        for a, b in zip(plans, plans2))
    same["rep_maps"] = len(plans) == len(plans2) and all(
        torch.equal(a[1], b[1]) for a, b in zip(plans, plans2))
    info["repeat_bitwise"] = same
    log(f"EP reuse repeat, same seed: bit-equal {same}")
    if not all(same.values()):
        raise SystemExit(f"the EP reuse run does not repeat: {same}")
    del again, plans, plans2
    torch.cuda.empty_cache()
    prof = phase_ep_profile(dict(plan_reuse="always",
                                 condense_reuse="always",
                                 similarity_backend="lsh"),
                            label="EP reuse profile")
    cmp = {k: [ep_prof[k], prof[k]] for k in (
        "wall_ms", "device_ms", "device_busy_share", "planner_host_ms",
        "planner_calls", "keep_home_host_ms", "keep_home_calls",
        "step_syncs")}
    log("EP profile, phase 14 vs reuse + lsh: " + json.dumps(cmp))
    info["profile"] = prof
    info["profile_vs_phase14"] = cmp
    return info


def phase_reuse_guarantee():
    """Phase 22c: at full width, condensation off, one forward with
    zeroed routers under plan_reuse "signature" bit for bit "off" with
    the greedy run once, then random routers bit for bit with every
    carried plan rebuilt."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch.config import LuffyConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import capacity_for
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    cfg = get_config("moe-gpt2")
    B, S, M = 8, 1024, 4
    dist = make_dist(make_host_mesh(model=M, nodes=2), "train", B,
                     moe_arch=True)
    # room for every routed copy, so no drop couples a sequence's counts
    # to the others' on its rank; distinct lengths, so the greedy's order
    # has no tie
    cap = capacity_for(cfg.moe, B // M * S, cfg.moe.num_experts,
                       slack=cfg.moe.num_experts / cfg.moe.top_k)
    model = build_model(cfg, device="cuda", seed=0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in SyntheticLM(
        cfg, ShapeConfig("t", S, B, "train")).batch(0).items()}
    batch["seq_len"] = torch.as_tensor(
        np.random.default_rng(0).permutation(np.arange(S - B, S)),
        device="cuda")
    counters = ("plans_built", "plans_reused", "plan_reuse_mismatch")
    orig = tex.build_exchange_plan
    out = {}
    routers = [layer["moe"]["router"]["w_gate"]
               for layer in model.params["layers"]]
    saved = [w.detach().clone() for w in routers]
    for zero in (True, False):
        with torch.no_grad():
            for w, w0 in zip(routers, saved):
                w.copy_(torch.zeros_like(w0) if zero else w0)
        for mode in ("off", "signature"):
            luffy = LuffyConfig(enable_condensation=False, combine_slack=2.0,
                                comm_mode="hier", hier_dedup="on",
                                wire_dtype="f8e4m3", plan_reuse=mode)
            perms = []

            def rec(*a, **kw):
                pl = orig(*a, **kw)
                perms.append(pl.perm.copy())
                return pl

            tex.build_exchange_plan = rec
            try:
                with torch.no_grad():
                    loss, m = model.forward_train(
                        batch, torch.tensor(0.6, device="cuda"), cap,
                        luffy=luffy, dist=dist)
            finally:
                tex.build_exchange_plan = orig
            out[(zero, mode)] = (loss.item(),
                                 {k: v.item() for k, v in m.items()}, perms)
    info = {}
    ok = True
    for zero in (True, False):
        (l0, m0, p0), (l1, m1, p1) = out[(zero, "off")],             out[(zero, "signature")]
        same = (l0 == l1 and all(m0[k] == m1[k] for k in m0
                                 if k not in counters)
                and len(p0) == len(p1)
                and all(np.array_equal(a, b) for a, b in zip(p0, p1)))
        name = "zeroed_routers" if zero else "random_routers"
        info[name] = dict(loss_off=l0, loss_signature=l1, bitwise=same,
                          off={k: m0[k] for k in counters},
                          signature={k: m1[k] for k in counters},
                          local_frac=m1["local_frac"],
                          dispatch_drop=m1["dispatch_drop"])
        n_moe = len(p1)
        if zero:
            want = (1.0, n_moe - 1.0, 0.0)
        else:
            want = (float(n_moe), 0.0, n_moe - 1.0)
        ok &= same and tuple(m1[k] for k in counters) == want             and m0["plans_built"] == n_moe
        info[name]["signature_expected"] = dict(zip(counters, want))
    log("reuse guarantee, full width: " + json.dumps(info))
    if not ok:
        raise SystemExit(f"plan_reuse 'signature' is not 'off' bit for bit "
                         f"with the expected counters: {info}")
    del model
    torch.cuda.empty_cache()
    return info


def phase_reuse_parity():
    """Phase 22d: reduced EP at f32 with plan and condense reuse "always"
    and the lsh backend, card against CPU: codes, rep maps, perms and
    counters equal, loss within 1e-4."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch.condense import backends as tbackends
    from repro_torch.config import LuffyConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch import train_lib
    P = REUSE_PARITY
    cfg = dataclasses.replace(reduced(get_config("moe-gpt2"),
                                      num_layers=P["layers"]),
                              compute_dtype="float32")
    shape = ShapeConfig("t", P["S"], P["B"], "train")
    dist = make_dist(make_host_mesh(model=P["M"], nodes=P["nodes"]), "train",
                     P["B"], moe_arch=True)
    luffy = LuffyConfig(condense_group=min(128, P["S"]), combine_slack=2.0,
                        comm_mode="hier", hier_dedup="on", wire_dtype="f32",
                        plan_reuse="always", condense_reuse="always",
                        condense_reuse_max_age=1, similarity_backend="lsh")
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
    model = build_model(cfg, device="cuda", seed=0)
    batch = SyntheticLM(cfg, shape).batch(0)
    orig_plan, orig_codes = tex.build_exchange_plan, tbackends.lsh_codes
    runs = {}
    for dev in ("cuda", "cpu"):
        model.to(dev)
        plans, codes = [], []

        def rec(*a, **kw):
            pl = orig_plan(*a, **kw)
            plans.append((pl.perm.copy(), pl.condense_plan.rep_idx.cpu()))
            return pl

        def rec_codes(*a, **kw):
            c = orig_codes(*a, **kw)
            codes.append(c.cpu())
            return c

        tex.build_exchange_plan = rec
        tbackends.lsh_codes = rec_codes
        try:
            with torch.no_grad():
                loss, m = model.forward_train(
                    {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()},
                    torch.tensor(0.6, device=dev), cap, luffy=luffy,
                    dist=dist)
        finally:
            tex.build_exchange_plan = orig_plan
            tbackends.lsh_codes = orig_codes
        runs[dev] = (loss.item(), {k: v.item() for k, v in m.items()},
                     plans, codes)
    (lg, mg, pg, cg), (lc, mc, pc, cc) = runs["cuda"], runs["cpu"]
    counters = ("plans_built", "plans_reused", "plan_reuse_mismatch",
                "condense_built", "condense_reused", "measured_pairs")
    info = dict(loss_cuda=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
                counters_cuda={k: mg[k] for k in counters},
                counters_cpu={k: mc[k] for k in counters},
                codes_calls=len(cg),
                codes_equal=len(cg) == len(cc) and all(
                    torch.equal(a, b) for a, b in zip(cg, cc)),
                perms_equal=len(pg) == len(pc) and all(
                    np.array_equal(a[0], b[0]) for a, b in zip(pg, pc)),
                rep_maps_equal=len(pg) == len(pc) and all(
                    torch.equal(a[1], b[1]) for a, b in zip(pg, pc)),
                condense_rate=[mg["condense_rate"], mc["condense_rate"]])
    log("reuse parity, reduced EP f32, cuda vs cpu: " + json.dumps(info))
    if not (info["codes_equal"] and info["perms_equal"]
            and info["rep_maps_equal"] and len(cg) > 0
            and info["counters_cuda"] == info["counters_cpu"]
            and mg["condense_reused"] > 0 and mg["plans_reused"] > 0
            and info["loss_rel"] <= 1e-4):
        raise SystemExit(f"reuse + lsh, cuda vs cpu differ: {info}")
    del model
    torch.cuda.empty_cache()
    return info


# ---------------------------------------------------------------------------
# the paper's other two models (phases 23-28)

def phase_paper_kernels():
    """Phase 23: K1 (forward and backward), K2 (both entries), K3 and its
    backward, and K4 (f8, cast, backward) against their plain versions
    at the paper models' width (d 1024, F 4096, 16 experts) and the
    shapes their paths give them, then timed beside the plain version,
    a library call where there is one, and the bound: phases 3 and 10's
    checks at those widths."""
    checks, timed = phase_kernels("moe-bert-large", PAPER_K1_R)
    out = phase_kernels_train("moe-bert-large", PAPER_K1_BWD_R, None,
                              PAPER_T)
    out.update(phase_kernels_k4(PAPER_D, PAPER_EP_T))
    out["expert_ffn"] = dict(timed["train"], checks=checks, max_abs_err=max(
        c["max_abs_err"] for c in checks if c["shape"] == "train"))
    return out


def phase_paper_train():
    """Phase 24: moe-transformerxl and moe-bert-large trained at full
    width and depth through the launcher: exact launch counts, one bf16
    copy and one second term per expert weight a step, the peak memory
    beside the card's, finite losses; each run repeated from the same
    seed bit for bit."""
    import gc
    import statistics
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    total = torch.cuda.mem_get_info()[1]
    info = {}
    for key, args in (("moe-transformerxl", TXL_TRAIN_ARGS),
                      ("moe-bert-large", BERT_TRAIN_ARGS)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold counts against the same card
        log(f"paper train {key}: {torch.cuda.memory_allocated()} B held "
            f"before the run")
        kexp.weight_bf16.casts = kexp.weight_bf16.lo_casts = 0
        res, launches, _, _ = _ep_run(args)
        casts, lo_casts = kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts
        cfg, steps = res["cfg"], res["steps"]
        want = dict(_ep_expected(cfg, len(steps), f8=False), pack_cast=0)
        n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
        med = statistics.median(st["step_ms"] for st in steps[1:])
        peak = max(st["peak_mem_bytes"] for st in steps)
        rec = dict(arch=res["arch"], optimizer=res["optimizer"],
                   layers=cfg.num_layers, causal=cfg.causal,
                   n_params=res["n_params"],
                   global_batch=res["global_batch"], seq_len=res["seq_len"],
                   losses=[st["loss"] for st in steps],
                   condense_rates=[st["condense_rate"] for st in steps],
                   buckets=[st["bucket"] for st in steps],
                   step_ms=[st["step_ms"] for st in steps],
                   median_step_ms_after_0=med,
                   tokens_per_s=res["global_batch"] * res["seq_len"] / med
                   * 1e3, peak_mem_bytes=peak, card_mem_bytes=total,
                   launches=launches, launches_expected=want,
                   weight_casts=casts, weight_lo_casts=lo_casts,
                   weight_casts_expected=3 * n_moe * len(steps))
        log(f"paper train {key}: " + json.dumps(rec))
        if not all(math.isfinite(x) for x in rec["losses"]):
            raise SystemExit(f"{key} losses not finite: {rec['losses']}")
        if launches != want:
            raise SystemExit(f"{key}: kernel launches {launches} differ from "
                             f"what the path calls, {want}")
        if casts != rec["weight_casts_expected"] \
                or lo_casts != rec["weight_casts_expected"]:
            raise SystemExit(f"{key}: {casts} bf16 casts, {lo_casts} second "
                             f"terms, not {rec['weight_casts_expected']}")
        if not peak < total:
            raise SystemExit(f"{key}: peak {peak} B over the card's {total}")
        del res, steps
        torch.cuda.empty_cache()
        again = _ep_run(args)[0]["steps"]
        same = {k: [st[k] for st in again] == rec[key_]
                for k, key_ in (("loss", "losses"),
                                ("condense_rate", "condense_rates"),
                                ("bucket", "buckets"))}
        rec["repeat_bitwise"] = same
        log(f"paper train {key} repeat: bit-equal {same}")
        if not all(same.values()):
            raise SystemExit(f"{key}: the train run does not repeat: {same}")
        del again
        torch.cuda.empty_cache()
        info[key] = rec
    return info


def phase_paper_serve():
    """Phase 25: full-width moe-transformerxl served through the launcher
    (B=8, prompt 256, 16 greedy tokens): K1 launched exactly as the path
    calls it, one bf16 copy per expert weight, finite logits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import serve
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    kexp.weight_bf16.casts = 0
    res = serve.main(TXL_SERVE_ARGS)
    launches = {k: fn.launches for k, fn in counters.items()}
    casts = kexp.weight_bf16.casts
    n_layers = get_config("moe-transformerxl").num_layers
    B, S, G = res["batch"], res["prompt_len"], res["gen"]
    want = dict.fromkeys(launches, 0)
    want["expert_ffn"] = n_layers * (serve.N_BATCHED_PREFILLS + S + G)
    # the batched prefills' attention on K5 (since slice 17)
    want["flash_attention"] = n_layers * serve.N_BATCHED_PREFILLS
    logits = ([res["prefill_logits"]] + res["step_logits"]
              + res["gen_logits"])
    finite = all(bool(torch.isfinite(t).all()) for t in logits)
    shapes_ok = all(tuple(t.shape) == (B, 32000) for t in logits)
    info = dict(arch=res["arch"], batch=B, prompt_len=S, gen=G,
                prefill_tok_s=res["prefill_tok_s"],
                decode_ms_per_step=res["decode_ms_per_step"],
                peak_mem_bytes=res["peak_mem_bytes"], launches=launches,
                launches_expected=want, weight_casts=casts,
                feed_vs_batch_max_abs=(res["step_logits"][-1]
                                       - res["prefill_logits"]).abs().max()
                .item(), sample_tokens=res["tokens"][0, :8].tolist())
    log("paper serve: " + json.dumps(info))
    if not (finite and shapes_ok):
        raise SystemExit(f"paper serve logits finite={finite} "
                         f"shapes={shapes_ok}")
    if launches != want or casts != 3 * n_layers:
        raise SystemExit(f"paper serve launches {launches} / casts {casts}, "
                         f"the path calls {want} / {3 * n_layers}")
    del res, logits
    torch.cuda.empty_cache()
    return info


def phase_paper_ep():
    """Phase 26: moe-bert-large at full width, 4 layers, expert-parallel
    over 4 virtual ranks on the f8 dedup wire with error feedback and
    Adafactor: exact launch counts, the shipped-bytes law, a nonzero
    residual buffer from step 0 on, and a second run bit for bit (losses,
    perms, rep maps and the residual buffer)."""
    import numpy as np
    import torch
    torch.cuda.empty_cache()
    res, launches, plans, _ = _ep_run(BERT_EP_ARGS)
    cfg, steps, luffy = res["cfg"], res["steps"], res["luffy"]
    want = _ep_expected(cfg, len(steps), f8=True)
    law = _check_law(steps, luffy, cfg)
    buf = res["lstate"].wire_ef.clone()
    info = dict(arch=res["arch"], layers=cfg.num_layers,
                optimizer=res["optimizer"],
                wire_error_feedback=luffy.wire_error_feedback,
                losses=[st["loss"] for st in steps],
                wire_ef_absmax=[st["wire_ef_absmax"] for st in steps],
                local_frac=[st["local_frac"] for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                peak_mem_bytes=max(st["peak_mem_bytes"] for st in steps),
                launches=launches, launches_expected=want, law_broken=law,
                buffer_shape=list(buf.shape))
    log("paper EP: " + json.dumps(info))
    if launches != want:
        raise SystemExit(f"paper EP launches {launches}, the path calls "
                         f"{want}")
    if law:
        raise SystemExit(f"paper EP shipped-bytes law broken: {law}")
    if not all(a > 0 for a in info["wire_ef_absmax"]):
        raise SystemExit(f"the residual buffer is zero: "
                         f"{info['wire_ef_absmax']}")
    del res
    torch.cuda.empty_cache()
    res2, _, plans2, _ = _ep_run(BERT_EP_ARGS)
    same = dict(
        losses=[st["loss"] for st in res2["steps"]] == info["losses"],
        perms=len(plans) == len(plans2) and all(
            np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(plans, plans2)),
        residual=bool(torch.equal(res2["lstate"].wire_ef, buf)))
    info["repeat_bitwise"] = same
    log(f"paper EP repeat: bit-equal {same}")
    if not all(same.values()):
        raise SystemExit(f"the paper EP run does not repeat: {same}")
    del res2, buf, plans, plans2
    torch.cuda.empty_cache()
    return info


def _grad_leaf_errs(ga, gb):
    """Each parameter's relative norm error, ga against gb."""
    return [((a.double().cpu() - b.double().cpu()).norm()
             / b.double().cpu().norm().clamp(min=1e-30)).item()
            for a, b in zip(ga, gb)]


def phase_paper_parity():
    """Phase 27: one f32 train step of 2-layer full-width cuts of both
    models on the card against the CPU (condensation on): rep maps
    equal, loss within 1e-4, every gradient leaf within 1e-5 by its
    relative norm error; then one Adafactor and one SGD update of the
    moe-bert-large cut's parameters on those gradients, card against
    CPU."""
    import torch
    from repro_torch import optim
    from repro_torch.config import LuffyConfig, OptimConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import capacity_for
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import build_model
    P = PAPER_PARITY
    info = {}
    for arch in ("moe-transformerxl", "moe-bert-large"):
        cfg = dataclasses.replace(get_config(arch), num_layers=P["layers"],
                                  compute_dtype="float32")
        model = build_model(cfg, device="cuda", seed=0)
        batch = SyntheticLM(cfg, ShapeConfig("t", P["S"], P["B"],
                                             "train")).batch(0)
        luffy = LuffyConfig(condense_group=128, combine_slack=2.0)
        cap = capacity_for(cfg.moe, P["B"] * P["S"], cfg.moe.num_experts)
        runs = {}
        for dev in ("cuda", "cpu"):
            model.to(dev)
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, _, reps, grads = _train_step_once(
                model, tb, cap, luffy, torch.tensor(0.6, device=dev))
            runs[dev] = (loss, reps, [g.detach().cpu() for g in grads])
            if dev == "cuda" and arch == "moe-bert-large":
                opt_in = ({k: v.detach().clone() for k, v in
                           model.named_parameters()},
                          {k: g.detach().clone() for (k, _), g in
                           zip(model.named_parameters(), grads)})
            del grads
        (lg, rg, gg), (lc, rc, gc) = runs["cuda"], runs["cpu"]
        reps_equal = len(rg) == len(rc) and all(
            torch.equal(a, b) for a, b in zip(rg, rc))
        errs = _grad_leaf_errs(gg, gc)
        rec = dict(loss_cuda=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
                   rep_maps=len(rc), reps_equal=reps_equal,
                   grad_leaf_max_rel=max(errs))
        log(f"paper parity {arch}: " + json.dumps(rec))
        if not reps_equal:
            raise SystemExit(f"{arch}: cuda vs cpu rep maps differ")
        if not rec["loss_rel"] <= 1e-4:
            raise SystemExit(f"{arch}: cuda vs cpu loss differ: {rec}")
        if not rec["grad_leaf_max_rel"] <= 1e-5:
            raise SystemExit(f"{arch}: a gradient leaf differs: {rec}")
        info[arch] = rec
        del model, runs
        torch.cuda.empty_cache()
    # one update of each ported optimizer on the cut's parameters and
    # gradients, card against CPU
    params, grads = opt_in
    for name in ("adafactor", "sgd"):
        ocfg = OptimConfig(name=name, lr=1e-3, warmup_steps=1, total_steps=10)
        outs = {}
        for dev in ("cuda", "cpu"):
            p = {k: v.to(dev).clone() for k, v in params.items()}
            g = {k: v.to(dev) for k, v in grads.items()}
            st = optim.init_opt_state(p, ocfg)
            p, st, m = optim.update(p, g, st, ocfg)
            outs[dev] = (p, st, float(m["grad_norm"]))
        (pg, sg, ng), (pc, sc, nc) = outs["cuda"], outs["cpu"]
        p_err = max(_grad_leaf_errs([pg[k] for k in pc], [pc[k] for k in pc]))
        mu_g = [t for _, t in optim.leaves_with_path(sg.mu)]
        mu_c = [t for _, t in optim.leaves_with_path(sc.mu)]
        # Adafactor's bf16 momentum: bf16 ulps of the larger of the two
        # (one update from zero: its f32 values differ by f32 rounding)
        mu_ulps = max(
            ((a.float().cpu() - b.float()).abs()
             / torch.exp2(torch.floor(torch.log2(torch.maximum(
                 a.float().cpu().abs(), b.float().abs()).clamp(
                     min=1e-30))) - 7)).max().item()
            for a, b in zip(mu_g, mu_c)) \
            if mu_c[0].dtype == torch.bfloat16 else 0.0
        mu_err = max(_grad_leaf_errs(mu_g, mu_c))
        nu_err = max(_grad_leaf_errs(
            [t for _, t in optim.leaves_with_path(sg.nu)],
            [t for _, t in optim.leaves_with_path(sc.nu)]))
        rec = dict(param_leaf_max_rel=p_err, mu_max_bf16_ulps=mu_ulps,
                   mu_leaf_max_rel=mu_err, nu_leaf_max_rel=nu_err,
                   grad_norm_rel=abs(ng - nc) / nc)
        log(f"paper {name} update, cuda vs cpu: " + json.dumps(rec))
        mu_ok = mu_ulps <= 1.0 if name == "adafactor" else mu_err <= 1e-5
        if not (p_err <= 1e-5 and nu_err <= 1e-5 and mu_ok
                and rec["grad_norm_rel"] <= 1e-5):
            raise SystemExit(f"the {name} update differs card vs CPU: {rec}")
        info[name] = rec
    del params, grads, opt_in, outs
    torch.cuda.empty_cache()
    return info


def phase_paper_ep_parity():
    """Phase 28: one f32 step of reduced moe-bert-large over 4 virtual
    ranks (2 nodes) on the f8 dedup wire with error feedback, a carried
    residual and condensation on, card against CPU: perms and rep maps
    equal, the loss within 1e-4, the refreshed residual within 1e-6 but
    where the payload crosses an e4m3 rounding boundary."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch import train_lib
    from repro_torch.config import LuffyConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model
    P = PAPER_EP_PARITY
    cfg = dataclasses.replace(reduced(get_config("moe-bert-large"),
                                      num_layers=P["layers"]),
                              compute_dtype="float32")
    shape = ShapeConfig("t", P["S"], P["B"], "train")
    dist = make_dist(make_host_mesh(model=P["M"], nodes=P["nodes"]),
                     "train", P["B"], moe_arch=True)
    luffy = LuffyConfig(combine_slack=4.0, comm_mode="hier", hier_dedup="on",
                        wire_dtype="f8e4m3", wire_error_feedback=True)
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
    model = build_model(cfg, device="cpu", seed=0)
    batch = SyntheticLM(cfg, shape).batch(0)
    ef = torch.randn(tf.wire_ef_shape(cfg, P["B"], P["S"]),
                     generator=torch.Generator().manual_seed(5)) * 1e-2
    orig = tex.build_exchange_plan
    runs = {}
    for dev in ("cuda", "cpu"):
        model.to(dev)
        plans = []

        def rec(*a, **kw):
            pl = orig(*a, **kw)
            plans.append((pl.perm.copy(), pl.condense_plan.rep_idx.cpu()))
            return pl

        tex.build_exchange_plan = rec
        try:
            model.zero_grad(set_to_none=True)
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, m = model.forward_train(tb, torch.tensor(0.6, device=dev),
                                          cap, luffy=luffy, dist=dist,
                                          wire_ef=ef.to(dev))
            loss.backward()
        finally:
            tex.build_exchange_plan = orig
        runs[dev] = (loss.item(), plans, m["_wire_ef"].cpu(),
                     [p.grad.detach().cpu() for p in model.parameters()])
    (lg, pg, eg, gg), (lc, pc, ec, gc) = runs["cuda"], runs["cpu"]
    perms = len(pg) == len(pc) and all(np.array_equal(a[0], b[0])
                                       for a, b in zip(pg, pc))
    reps = all(torch.equal(a[1], b[1]) for a, b in zip(pg, pc))
    # a residual is the e4m3 wire's rounding error: where the card's and
    # the CPU's payloads (equal to f32 rounding) straddle a rounding
    # boundary it jumps by a whole e4m3 step, so entries are counted
    # apart from 1e-6; later layers see the first one's crossings
    far = [((eg[i] - ec[i]).abs() > 1e-6).float().mean().item()
           for i in range(eg.shape[0])]
    ratio = [(eg[i].norm() / ec[i].norm()).item() for i in range(eg.shape[0])]
    info = dict(loss_cuda=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
                plans=len(pg), perms_equal=perms, reps_equal=reps,
                residual_share_over_1e6_by_layer=far,
                residual_norm_ratio_by_layer=ratio,
                residual_max_abs_err_by_layer=[
                    (eg[i] - ec[i]).abs().max().item()
                    for i in range(eg.shape[0])],
                residual_absmax=ec.abs().max().item(),
                grad_leaf_max_rel=max(_grad_leaf_errs(gg, gc)))
    log("paper EP parity: " + json.dumps(info))
    if not (perms and reps):
        raise SystemExit(f"paper EP parity: perms / rep maps differ: {info}")
    if not info["loss_rel"] <= 1e-4:
        raise SystemExit(f"paper EP parity: loss differs: {info}")
    if not (far[0] <= 1e-4 and max(far) <= 0.5
            and max(abs(r - 1) for r in ratio) <= 1e-3):
        raise SystemExit(f"paper EP parity: residual differs: {info}")
    del model
    torch.cuda.empty_cache()
    return info


def phase_paper_profile():
    """Phase 29: one full-width train step of each paper model at its
    phase-24 shape and optimizer under torch.profiler."""
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.configs import get_config
    info = {}
    for arch, args in (("moe-transformerxl", TXL_TRAIN_ARGS),
                       ("moe-bert-large", BERT_TRAIN_ARGS)):
        val = dict(zip(args[::2], args[1::2]))
        shape = ShapeConfig("train", int(val["--seq-len"]),
                            int(val["--global-batch"]), "train")
        info[arch] = _train_step_profile(
            get_config(arch), shape,
            OptimConfig(name=val["--optimizer"], lr=1e-3, total_steps=6,
                        warmup_steps=2))
        log(f"paper profile {arch}: " + json.dumps(info[arch]))
    return info


def run_paper_phases(kern=None):
    """Phases 23 (unless its result ``kern`` is given) to 29; returns
    what the kernels line needs."""
    log("paper models:")
    if kern is None:
        kern = phase_paper_kernels()
    train = phase_paper_train()
    serve_ = phase_paper_serve()
    ep = phase_paper_ep()
    parity = phase_paper_parity()
    ep_parity = phase_paper_ep_parity()
    prof = phase_paper_profile()
    return dict(kernels=kern, train=train, serve=serve_, ep=ep,
                parity=parity, ep_parity=ep_parity, profile=prof)


# ---------------------------------------------------------------------------
# slice 14: K1's group map (replica lanes), the "replicate" and "overlap"
# objectives, the plan cache with serving templates (phases 36-40)
# ---------------------------------------------------------------------------

# moe-gpt2's EP lanes over 4 ranks of 4 experts: rank r's rows are groups
# 5r .. 5r+4, its lane (5r+4) idle or an intra-node peer's expert
LANE_MAP = (0, 1, 2, 3, -1, 4, 5, 6, 7, 0, 8, 9, 10, 11, -1,
            12, 13, 14, 15, 9)


def _lane_counters():
    from repro_torch.kernels import expert_ffn as kexp
    return {"expert_ffn_lanes": kexp.lanes,
            "expert_ffn_bwd_lanes": kexp.lanes_bwd}


def _k1_lane_bound(live, R, D_, Fw, E_w, G, bwd=False):
    """The lane launch's bound: the products of the live groups only (an
    idle lane does none), the rows (h, out; and dy, dh) moved once, each
    weight read once in bf16 (and its f32 gradient written once)."""
    flops = (8 if bwd else 3) * 2.0 * live * R * D_ * Fw
    rows = G * R * D_ * 2 * (4 if bwd else 2)
    wbytes = E_w * 3 * D_ * Fw * (2 + (4 if bwd else 0))
    return _bound(rows + wbytes, flops, BF16_TC_FLOPS)


def phase_k1_lanes(arch: str = "moe-gpt2", R: int = 2048):
    """Phase 36: K1 and its backward with a group map at the replicate EP
    run's shape, [20, R, 768] x 3072 over the 16-expert stack (two live
    lanes, two idle), against the plain version (the mapped stack, and
    autograd through it for the backward); idle groups exactly zero; the
    f32 FMA routes and the bf16 ones at R = 160; a bitwise repeat; no
    cast beyond the stack's own; timed in turns with a [16, R, 768]
    launch without a map and with the concatenated stack the reference
    builds (its casts included). The bound counts the live groups'
    products."""
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(36)
    E, D_, F_ = _widths(arch)
    G = len(LANE_MAP)
    widx = torch.tensor(LANE_MAP, dtype=torch.int32, device="cuda")
    idle = widx < 0
    live = int((~idle).sum())
    checks = []

    def check(name, got, want, tol, zero):
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        ok = all(torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
                 for g, w in zip(got, want))
        ok = ok and bool(torch.all(zero[idle] == 0))
        checks.append(dict(check=name, max_abs_err=err, tol=tol, ok=ok))
        log(f"  K1 lanes {name}: max|err| {err:.3e} tol {tol:g}, idle rows "
            f"zero {'ok' if ok else 'FAIL'}")
        return err

    def inputs(rows, h_dtype):
        _, wu, wg, wd = _k1_inputs(8, torch.float32, gen, arch)
        h = torch.randn((G, rows, D_), generator=gen,
                        device="cuda").to(h_dtype)
        dy = torch.randn(h.shape, generator=gen, device="cuda").to(h_dtype)
        return h, wu, wg, wd, dy

    def plain_bwd(h, wu, wg, wd, dy):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (h, wu, wg, wd)]
            out = ref.expert_ffn_ref(*leaves, "gelu", widx)
            return torch.autograd.grad(out, leaves, dy)

    fwd_err = bwd_err = 0.0
    for rows, h_dtype in ((160, torch.float32), (160, torch.bfloat16),
                          (R, torch.bfloat16)):
        h, wu, wg, wd, dy = inputs(rows, h_dtype)
        tol = K1_TOL[str(h_dtype).split(".")[1]]
        rt = kexp.route(h.dtype, wu.dtype, D_, F_)
        got = kexp.expert_ffn(h, wu, wg, wd, "gelu", widx)
        torch.cuda.synchronize()
        fwd_err = max(fwd_err, check(
            f"forward [{G},{rows},{D_}] {h_dtype} ({rt})", [got],
            [ref.expert_ffn_ref(h, wu, wg, wd, "gelu", widx)], tol, got))
        gb = kexp.expert_ffn_bwd(h, wu, wg, wd, dy, "gelu", widx)
        torch.cuda.synchronize()
        bwd_err = max(bwd_err, check(
            f"backward [{G},{rows},{D_}] {h_dtype} "
            f"({kexp.bwd_route(h.dtype, wu.dtype, D_, F_)})", gb,
            plain_bwd(h, wu, wg, wd, dy), tol, gb[0]))
        again = kexp.expert_ffn_bwd(h, wu, wg, wd, dy, "gelu", widx)
        rep = all(torch.equal(a, b) for a, b in zip(again, gb))
        checks.append(dict(check=f"backward repeat {h_dtype} {rows}",
                           ok=rep))
        log(f"  K1 lanes backward repeat {h_dtype} R={rows}: bit-equal {rep}")
        del h, wu, wg, wd, dy, got, gb, again
        torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"K1 with a group map disagrees with its plain "
                         f"version: {bad}")

    # timing at the EP lane shape: the map launch, a 16-group launch of the
    # same stack without a map, and the reference's concatenated stack
    h, wu, wg, wd, dy = inputs(R, torch.bfloat16)
    ws = (wu, wg, wd)
    h16, dy16 = h[:E].contiguous(), dy[:E].contiguous()
    src = widx.clamp(min=0).long()
    livef = (~idle).float()[:, None, None]

    def concat():
        # the mapped stack as a new tensor each call, as the reference
        # concatenates it: every call casts three fresh [20, 768, 3072]
        # stacks to bf16
        return kexp.expert_ffn(h, *(w.index_select(0, src) * livef
                                    for w in ws), "gelu")

    kexp.expert_ffn(h16, *ws, "gelu")            # the stack's cached copy
    kexp.expert_ffn_bwd(h16, *ws, dy16, "gelu")
    c0 = (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts)
    kexp.expert_ffn(h, *ws, "gelu", widx)
    kexp.expert_ffn_bwd(h, *ws, dy, "gelu", widx)
    new_casts = (kexp.weight_bf16.casts - c0[0],
                 kexp.weight_bf16.lo_casts - c0[1])
    c1 = kexp.weight_bf16.casts
    concat()
    concat_casts = kexp.weight_bf16.casts - c1
    ms, ms16, msc, bms, bms16 = [], [], [], [], []
    for _ in range(2):                    # in turns, as in one call
        ms.append(time_ms(lambda: kexp.expert_ffn(h, *ws, "gelu", widx), 20))
        ms16.append(time_ms(lambda: kexp.expert_ffn(h16, *ws, "gelu"), 20))
        msc.append(time_ms(concat, 5, 1))
        bms.append(time_ms(lambda: kexp.expert_ffn_bwd(
            h, *ws, dy, "gelu", widx), 5, 1))
        bms16.append(time_ms(lambda: kexp.expert_ffn_bwd(
            h16, *ws, dy16, "gelu"), 5, 1))
    dev = device_ms(lambda: kexp.expert_ffn(h, *ws, "gelu", widx))
    dev16 = device_ms(lambda: kexp.expert_ffn(h16, *ws, "gelu"))
    bdev = device_ms(lambda: kexp.expert_ffn_bwd(h, *ws, dy, "gelu", widx),
                     5)
    plain_ms = time_ms(lambda: ref.expert_ffn_ref(h, *ws, "gelu", widx), 5,
                       1)
    bplain_ms = time_ms(lambda: plain_bwd(h, *ws, dy), 3, 1)
    # the library yardsticks: torch.bmm on bf16 operands, the mapped stack
    # gathered from the bf16 copies (not timed: the port never calls them)
    wm = [w.to(torch.bfloat16).index_select(0, src) * livef.to(torch.bfloat16)
          for w in ws]
    lib_ms = time_ms(lambda: _k1_library_bf16(h, *wm, "gelu"), 10)
    blib_ms = time_ms(lambda: _k1_bwd_products(h, *wm, dy, "gelu"), 5, 1)
    fb = _k1_lane_bound(live, R, D_, F_, E, G)
    bb = _k1_lane_bound(live, R, D_, F_, E, G, bwd=True)
    info = dict(shape=[G, R, D_, F_], map=list(LANE_MAP), live_groups=live,
                ms=min(ms), ms_runs=ms, device_ms=dev,
                no_map_16_ms=min(ms16), no_map_16_ms_runs=ms16,
                no_map_16_device_ms=dev16, concat_ms=min(msc),
                concat_ms_runs=msc, concat_casts_per_call=concat_casts,
                bwd_ms=min(bms), bwd_ms_runs=bms, bwd_device_ms=bdev,
                bwd_no_map_16_ms=min(bms16), bwd_no_map_16_ms_runs=bms16,
                plain_ms=plain_ms, bwd_plain_ms=bplain_ms, library_ms=lib_ms,
                bwd_library_ms=blib_ms, map_casts=list(new_casts),
                max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, checks=checks,
                **fb, bwd_bound_ms=bb["bound_ms"],
                bwd_bound_by=bb["bound_by"])
    info["bound_share"] = info["bound_ms"] / info["ms"]
    log(f"  K1 lanes [{G},{R},{D_}]x{F_} ({live} live groups) bf16 h, f32 "
        f"w, gelu: {info['ms']:.4f} ms (runs {ms}; device {dev:.4f} ms), "
        f"[16,{R},{D_}] without a map {info['no_map_16_ms']:.4f} ms "
        f"(device {dev16:.4f}), the concatenated stack with its "
        f"{concat_casts} casts {info['concat_ms']:.4f} ms; bound "
        f"{info['bound_ms']:.4f} ms by {info['bound_by']} "
        f"({100 * info['bound_share']:.1f}% of it); plain {plain_ms:.3f} ms, "
        f"bmm bf16 {lib_ms:.4f} ms; backward {info['bwd_ms']:.4f} ms "
        f"(device {bdev:.4f}), 16 groups without a map "
        f"{info['bwd_no_map_16_ms']:.4f} ms, bound "
        f"{info['bwd_bound_ms']:.4f} ms, plain {bplain_ms:.3f} ms, bmm bf16 "
        f"{blib_ms:.4f} ms; casts made by the map launches {new_casts}")
    if new_casts != (0, 0):
        raise SystemExit(f"K1's map launches cast the weights again: "
                         f"{new_casts}")
    del h, h16, wu, wg, wd, dy, dy16, wm
    torch.cuda.empty_cache()
    return info


# phases 37-39: the expert-parallel train path under the new objectives
# (dense hier wire, 4 ranks in 2 nodes, condensation and migration on)
OBJ_EP_ARGS = DENSE_EP_ARGS       # full-width moe-gpt2, 2 steps, B=8 S=1024
# every MoE router's column 0 pushed by this times the unit vector of
# batch 0's mean token embedding: at full width a replica pays only when
# the hot expert holds over 22.4% of the routed copies (3.6x the mean)
REPLICA_BIAS = 8.0
# the 2-layer cut's capacity is 40, where the modelled relief beats the
# replica-consistency cost only at a slower modelled speed (the CPU tests'
# 1e11 FLOP/s)
OBJ_PARITY = dict(B=4, S=256, layers=2, M=4, nodes=2, bias=8.0,
                  gpu_speed=1e11)
PLAN_CACHE_DIR = "build/plan_cache_smoke"
# phase 40's serve runs: the serve cell at a 64-token prompt and 8 new
# tokens (each run feeds the prompt step by step too; 4 runs)
CACHE_SERVE_B, CACHE_SERVE_S, CACHE_SERVE_G = 8, 64, 8
CACHE_SERVE_ARGS = ["--arch", "moe-gpt2", "--batch", str(CACHE_SERVE_B),
                    "--prompt-len", str(CACHE_SERVE_S), "--gen",
                    str(CACHE_SERVE_G), "--prefill", "batch", "--device",
                    "cuda", "--seed", "0"]
# phase 40's timing: rounds of one uncached and one cached run each, in
# alternating order, after one untimed round
CACHE_TIMING_ROUNDS = 6


def _bias_router(params, tokens, bias):
    """Push every MoE router's column 0 by ``bias`` times the unit vector
    of the mean embedding of ``tokens`` (in place, as the CPU tests
    do)."""
    import torch
    with torch.no_grad():
        table = params["embed"]["table"]
        emb = table[torch.as_tensor(tokens, device=table.device).long()] \
            .double().mean(dim=(0, 1))
        u = (emb / emb.norm()).float()
        for lay in params["layers"]:
            if "moe" in lay:
                lay["moe"]["router"]["w_gate"][:, 0] += bias * u


def _biased_models(args, bias):
    """Make the launcher's ``build_model`` bias its routers by ``bias``
    on batch 0 of the run's synthetic stream; returns the undo."""
    import repro_torch.models.model as mmod
    from repro_torch.config import ShapeConfig
    from repro_torch.data import SyntheticLM
    orig = mmod.build_model
    gb = int(args[args.index("--global-batch") + 1])
    S = int(args[args.index("--seq-len") + 1])

    def build(cfg, **kw):
        model = orig(cfg, **kw)
        tokens = SyntheticLM(cfg, ShapeConfig("train", S, gb, "train")) \
            .batch(0)["tokens"]
        _bias_router(model.params, tokens, bias)
        return model

    mmod.build_model = build
    return lambda: setattr(mmod, "build_model", orig)


def _obj_run(args, bias=REPLICA_BIAS):
    """One launcher run with a biased router and every kernel and lane
    counter set to 0 just before and read just after; returns (result,
    launches, plans as (perm, replica_src, live lanes))."""
    import repro_torch.plan.exchange as tex
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import train
    counters = {**_kernel_counters(), **_lane_counters()}
    for fn in counters.values():
        fn.launches = 0
    kexp.weight_bf16.casts = kexp.weight_bf16.lo_casts = 0
    plans = []
    orig = tex.build_exchange_plan

    def rec(*a, **kw):
        pl = orig(*a, **kw)
        rs = None if pl.replica_src is None else pl.replica_src.cpu()
        plans.append((pl.perm.copy(), rs,
                      0 if rs is None else int((rs >= 0).sum()),
                      pl.chunks.n_chunks))
        return pl

    undo = _biased_models(args, bias)
    tex.build_exchange_plan = rec
    try:
        res = train.main(args)
    finally:
        tex.build_exchange_plan = orig
        undo()
    launches = {k: fn.launches for k, fn in counters.items()}
    res["casts"] = (kexp.weight_bf16.casts, kexp.weight_bf16.lo_casts)
    return res, launches, plans


def _obj_step_profile(objective, bias=REPLICA_BIAS):
    """A warm-up step and one profiled step of the full-width EP train
    (phase 37's configuration, sync) under ``objective``: wall ms,
    device ms, the busy share and the top device ops."""
    import torch
    from repro_torch import optim, train_lib
    from repro_torch.config import LuffyConfig, OptimConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    cfg = get_config("moe-gpt2")
    shape = ShapeConfig("train", 1024, 8, "train")
    dist = make_dist(make_host_mesh(model=4, nodes=2), "train", 8,
                     moe_arch=True)
    data = SyntheticLM(cfg, shape)
    model = build_model(cfg, device="cuda", seed=0)
    params = model.params
    _bias_router(params, data.batch(0)["tokens"], bias)
    luffy = LuffyConfig(condense_group=128, combine_slack=2.0,
                        comm_mode="hier", plan_objective=objective)
    ocfg = OptimConfig(lr=1e-3, total_steps=6, warmup_steps=2)
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
    step = train_lib.make_train_step(cfg, luffy, ocfg, cap, dist)
    state = [optim.init_opt_state(params, ocfg),
             train_lib.init_luffy_state("cuda")]

    def one(i):
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch(i).items()}
        _, state[0], state[1], _ = step(params, state[0], state[1], b)

    one(0)
    torch.cuda.synchronize()
    prof = _profile(lambda: one(1), 1)
    del model, params, state, step
    torch.cuda.empty_cache()
    return prof


def phase_replicate_ep():
    """Phase 37: full-width moe-gpt2 EP train over 4 virtual ranks in 2
    nodes of 2 on the dense wire, condensation and migration on, 2 steps
    under ``--plan-objective replicate`` with every router biased toward
    expert 0 (``REPLICA_BIAS``): live lanes in step 0, K1's launches the
    path's (every one of them with the lane map), one bf16 copy and one
    second term per expert weight a step, a bit-equal repeat (losses,
    perms, replica placements), the pipelined run's step 0 bit for bit
    the sync run's. Against "traffic" on the same parameters and batch, a
    1-step pair with condensation off (with it on, condensation leaves
    the hot expert under its capacity at this init and neither objective
    drops): a lower dispatch drop and the same launches of every kernel;
    then one profiled step of each objective, condensation on."""
    import numpy as np
    import torch
    args = OBJ_EP_ARGS
    rep, r_launch, r_plans = _obj_run(args + ["--plan-objective",
                                              "replicate"])
    cfg, steps = rep["cfg"], rep["steps"]
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    per_step = n_moe * (2 if cfg.remat else 1)     # forward + recompute
    lanes0 = [p[2] for p in r_plans[:n_moe]]       # step 0's forward
    kernels = _kernel_counters()
    base = {k: r_launch[k] for k in kernels}
    want = {k: v for k, v in _sched_expected(cfg, steps, "dense").items()
            if k in kernels}
    info = dict(objective="replicate", bias=REPLICA_BIAS,
                live_lanes_step0_per_sublayer=lanes0,
                replica_src_step0=[p[1].tolist() for p in r_plans[:n_moe]],
                dispatch_drop=[st["dispatch_drop"] for st in steps],
                losses=[st["loss"] for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                launches=r_launch, launches_expected=want,
                weight_casts=list(rep["casts"]),
                weight_casts_expected=3 * n_moe * len(steps),
                plans=len(r_plans), plans_expected=per_step * len(steps))
    log("replicate EP: " + json.dumps(info))
    if sum(lanes0) == 0:
        raise SystemExit(f"no replica lane went live in step 0: {info}")
    if base != want:
        raise SystemExit(f"replicate EP launches {base} differ from the "
                         f"path's {want}")
    if (r_launch["expert_ffn_lanes"] != r_launch["expert_ffn"]
            or r_launch["expert_ffn_bwd_lanes"] != r_launch["expert_ffn_bwd"]):
        raise SystemExit(f"a replicate K1 launch went without its lane map: "
                         f"{r_launch}")
    if rep["casts"] != (info["weight_casts_expected"],) * 2:
        raise SystemExit(f"{rep['casts']} bf16 weight copies / second terms "
                         f"in the replicate EP run, not "
                         f"{info['weight_casts_expected']} each")
    del rep
    torch.cuda.empty_cache()
    pair = {}
    for o in ("traffic", "replicate"):
        r, la, pl = _obj_run(args + ["--steps", "1", "--no-condensation",
                                     "--plan-objective", o])
        pair[o] = dict(drop=r["steps"][0]["dispatch_drop"],
                       live_lanes=sum(p[2] for p in pl),
                       launches={k: la[k] for k in kernels})
        del r
    info["no_condensation_pair"] = pair
    log(f"replicate EP, condensation off, step 0: {json.dumps(pair)}")
    if not pair["replicate"]["drop"] < pair["traffic"]["drop"]:
        raise SystemExit(f"replicate dropped no fewer copies than traffic "
                         f"with condensation off: {pair}")
    if pair["replicate"]["launches"] != pair["traffic"]["launches"]:
        raise SystemExit(f"replicate and traffic launch the kernels a "
                         f"different number of times: {pair}")
    torch.cuda.empty_cache()
    again, _, a_plans = _obj_run(args + ["--plan-objective", "replicate"])
    same = dict(losses=[st["loss"] for st in again["steps"]]
                == info["losses"],
                perms=len(a_plans) == len(r_plans) and all(
                    np.array_equal(a[0], b[0])
                    for a, b in zip(a_plans, r_plans)),
                replica_src=all(torch.equal(a[1], b[1])
                                for a, b in zip(a_plans, r_plans)))
    info["repeat_bitwise"] = same
    del again
    torch.cuda.empty_cache()
    pipe, p_launch, p_plans = _obj_run(args + ["--plan-objective",
                                               "replicate"] + SCHED_FLAGS)
    diff = _step0_diff(steps[0], pipe["steps"][0])
    info.update(pipeline_step0_vs_sync_differ=diff,
                pipeline_chunks=[p[3] for p in p_plans[:n_moe]],
                pipeline_launches=p_launch,
                pipeline_step_ms=[st["step_ms"] for st in pipe["steps"]])
    log(f"replicate EP repeat bit-equal {same}; pipelined step 0 against "
        f"sync: differs in {diff}; pipelined K1 launches "
        f"{p_launch['expert_ffn']} (lanes {p_launch['expert_ffn_lanes']})")
    if not all(same.values()):
        raise SystemExit(f"the replicate EP run does not repeat: {same}")
    if diff:
        raise SystemExit(f"pipelined replicate step 0 is not sync's bit for "
                         f"bit: {diff}")
    if p_launch["expert_ffn_lanes"] != p_launch["expert_ffn"]:
        raise SystemExit(f"pipelined K1 launches without the map: {p_launch}")
    del pipe
    torch.cuda.empty_cache()
    prof = {o: _obj_step_profile(o) for o in ("traffic", "replicate")}
    info["profile"] = prof
    info["device_ms_change"] = (prof["replicate"]["device_ms_per_call"]
                                - prof["traffic"]["device_ms_per_call"])
    log("replicate EP profile, one step each: " + json.dumps(
        {o: {k: v for k, v in p.items()} for o, p in prof.items()})
        + f"; device ms replicate - traffic {info['device_ms_change']:.3f}")
    return info


def phase_replicate_parity():
    """Phase 38: one f32 step of a 2-layer full-width cut of phase 37's
    run (replicate; at this size a lane goes live only at a slower
    modelled speed, ``OBJ_PARITY``), card against CPU: loss within 1e-4, perms, replica placements and the
    counters equal, every gradient leaf within 1e-5 by its relative norm
    error; K1 with the map on the card's FMA route (f32 rows)."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch import optim, train_lib
    from repro_torch.config import LuffyConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    P = OBJ_PARITY
    cfg = dataclasses.replace(get_config("moe-gpt2"), num_layers=P["layers"],
                              compute_dtype="float32")
    shape = ShapeConfig("t", P["S"], P["B"], "train")
    dist = make_dist(make_host_mesh(model=P["M"], nodes=P["nodes"]), "train",
                     P["B"], moe_arch=True)
    luffy = LuffyConfig(condense_group=128, combine_slack=2.0,
                        comm_mode="hier", plan_objective="replicate",
                        gpu_speed=P["gpu_speed"])
    cap = train_lib.capacity_for_bucket(cfg, shape, luffy, 0, dist)
    model = build_model(cfg, device="cuda", seed=0)
    batch = SyntheticLM(cfg, shape).batch(0)
    _bias_router(model.params, batch["tokens"], P["bias"])
    thr = torch.tensor(0.6)
    orig = tex.build_exchange_plan
    runs = {}
    for dev in ("cuda", "cpu"):
        model.to(dev)
        plans = []

        def rec(*a, **kw):
            pl = orig(*a, **kw)
            plans.append((pl.perm.copy(), pl.replica_src.cpu(),
                          pl.replica_valid.cpu()))
            return pl

        tex.build_exchange_plan = rec
        lanes0 = kexp.lanes.launches
        try:
            model.zero_grad(set_to_none=True)
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, m = model.forward_train(tb, thr.to(dev), cap, luffy=luffy,
                                          dist=dist)
            loss.backward()
        finally:
            tex.build_exchange_plan = orig
        grads = {k: p.grad.double().cpu()
                 for k, p in optim.leaves_with_path(model.params)
                 if p.grad is not None}
        runs[dev] = (loss.item(), {k: v.item() for k, v in m.items()},
                     plans, grads, kexp.lanes.launches - lanes0)
    (lg, mg, pg, gg, lane_k1), (lc, mc, pc, gc, _) = runs["cuda"], runs["cpu"]
    counters = ("plans_built", "plans_reused", "condense_built",
                "condense_reused", "measured_pairs", "dispatch_drop",
                "combine_drop", "local_frac")
    leaf_rel = {k: (torch.linalg.vector_norm(gg[k] - g)
                    / torch.clamp(torch.linalg.vector_norm(g), min=1e-30))
                .item() for k, g in gc.items()}
    worst = max(leaf_rel, key=leaf_rel.get)
    info = dict(capacity=cap, bias=P["bias"],
                live_lanes=[int((p[1] >= 0).sum()) for p in pg],
                k1_lane_launches_cuda=lane_k1, loss_cuda=lg, loss_cpu=lc,
                loss_rel=abs(lg - lc) / abs(lc),
                perms_equal=len(pg) == len(pc) and all(
                    np.array_equal(a[0], b[0]) for a, b in zip(pg, pc)),
                replica_src_equal=all(torch.equal(a[1], b[1])
                                      for a, b in zip(pg, pc)),
                replica_valid_equal=all(torch.equal(a[2], b[2])
                                        for a, b in zip(pg, pc)),
                counters_equal={k: mg[k] == mc[k] for k in counters},
                grad_leaves=len(gc), same_leaves=sorted(gg) == sorted(gc),
                grad_leaf_worst=worst, grad_leaf_worst_rel=leaf_rel[worst],
                grad_leaf_tol=SCHED_GRAD_TOL)
    log("replicate parity, 2-layer f32 EP cut, card vs CPU: "
        + json.dumps(info))
    if not any(info["live_lanes"]) or lane_k1 == 0:
        raise SystemExit(f"no live lane in the replicate parity cut: {info}")
    if not (info["perms_equal"] and info["replica_src_equal"]
            and info["replica_valid_equal"]
            and all(info["counters_equal"].values())):
        raise SystemExit(f"replicate cut cuda vs cpu plans differ: {info}")
    if not (info["loss_rel"] <= 1e-4 and info["same_leaves"]
            and info["grad_leaf_worst_rel"] <= SCHED_GRAD_TOL):
        raise SystemExit(f"replicate cut cuda vs cpu differ: {info}")
    del model
    torch.cuda.empty_cache()
    return info


def phase_overlap_ep():
    """Phase 39: phase 37's EP train (no router bias) under
    ``--plan-objective overlap --exec-mode pipeline``, whose default chunk
    count is the exchange estimate's: 2 steps, the chunk count printed,
    exact launches (K1 and its backward once per chunk) and a bit-equal
    repeat (losses, perms)."""
    import numpy as np
    import torch
    args = OBJ_EP_ARGS + ["--plan-objective", "overlap", "--exec-mode",
                          "pipeline"]
    res, launches, plans = _obj_run(args, bias=0.0)
    cfg, steps = res["cfg"], res["steps"]
    kernels = _kernel_counters()
    want = {k: v for k, v in _sched_expected(cfg, steps, "dense").items()
            if k in kernels}
    base = {k: launches[k] for k in kernels}
    info = dict(objective="overlap",
                pipeline_chunks=res["luffy"].pipeline_chunks,
                chunks=[st["chunks"] for st in steps],
                losses=[st["loss"] for st in steps],
                traffic=[(st["traffic_before"], st["traffic_after"])
                         for st in steps],
                local_frac=[st["local_frac"] for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                launches=launches, launches_expected=want)
    log("overlap EP: " + json.dumps(info))
    if base != want or launches["expert_ffn_lanes"]:
        raise SystemExit(f"overlap EP launches {launches} differ from the "
                         f"path's {want}")
    if not all(math.isfinite(x) for x in info["losses"]):
        raise SystemExit(f"overlap EP losses not finite: {info}")
    del res
    torch.cuda.empty_cache()
    again, _, plans2 = _obj_run(args, bias=0.0)
    same = dict(losses=[st["loss"] for st in again["steps"]]
                == info["losses"],
                perms=len(plans) == len(plans2) and all(
                    np.array_equal(a[0], b[0]) for a, b in zip(plans, plans2)))
    info["repeat_bitwise"] = same
    log(f"overlap EP repeat: bit-equal {same}")
    if not all(same.values()):
        raise SystemExit(f"the overlap EP run does not repeat: {same}")
    del again
    torch.cuda.empty_cache()
    return info


def _cache_serve_timing(model_axis: int, rounds: int = CACHE_TIMING_ROUNDS):
    """One full-width moe-gpt2 model at phase 40's batch and prompt: the
    batched prefill and ``CACHE_SERVE_G`` greedy decode steps from an
    empty cache, without and with the warm plan cache, in alternating
    order (uncached, cached, cached, uncached, ...) after one untimed
    round: each run's prefill tokens/s and decode ms a step (host clock,
    synchronised), and the plans built by the cached runs (0)."""
    import shutil
    import statistics
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch.config import LuffyConfig, resolve_pipeline_chunks
    from repro_torch.configs import get_config
    from repro_torch.dist import make_dist, single_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.plan.cache import (PlanCache, precompute_decode_plans,
                                        precompute_prefill_plans)
    B, S, G = CACHE_SERVE_B, CACHE_SERVE_S, CACHE_SERVE_G
    cfg = get_config("moe-gpt2")
    model = build_model(cfg, device="cuda", seed=0)
    objective = LuffyConfig.plan_objective
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False,
                        exec_mode="sync", plan_objective=objective,
                        pipeline_chunks=resolve_pipeline_chunks(None,
                                                                objective))
    pdist = single_device() if model_axis == 1 else make_dist(
        make_host_mesh(model=model_axis), "prefill", B, moe_arch=True)
    cache_dir = PLAN_CACHE_DIR + "_timing"
    shutil.rmtree(cache_dir, ignore_errors=True)
    pc = PlanCache(cache_dir)
    precompute_prefill_plans(cfg, luffy, pdist, B, S, pc)
    precompute_decode_plans(cfg, luffy, B, pc)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), dtype=torch.int32,
                            device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))

    def run(cache_or_none):
        kv = model.new_cache(B, S + G)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(prompts, S + G, luffy=luffy, dist=pdist,
                      plan_cache=cache_or_none)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = prompts[:, :1]
        for _ in range(G):
            logits, kv = model.decode_step(kv, tok, luffy=luffy,
                                           plan_cache=cache_or_none)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return B * S / (t1 - t0), (t2 - t1) / G * 1e3

    run(None)
    run(pc)
    times = {False: [], True: []}
    n0 = tex.BUILD_CALLS
    built_cached = 0
    for r in range(rounds):
        for cached in ((False, True) if r % 2 == 0 else (True, False)):
            b0 = tex.BUILD_CALLS
            times[cached].append(run(pc if cached else None))
            if cached:
                built_cached += tex.BUILD_CALLS - b0
    out = {}
    for cached, label in ((False, "uncached"), (True, "cached")):
        tok_s = [t for t, _ in times[cached]]
        dec = [d for _, d in times[cached]]
        out[label] = dict(prefill_tok_s=tok_s, decode_ms_per_step=dec,
                          prefill_tok_s_median=statistics.median(tok_s),
                          decode_ms_median=statistics.median(dec))
    out.update(rounds=rounds, plans_built_uncached=tex.BUILD_CALLS - n0
               - built_cached, plans_built_cached=built_cached)
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(cache_dir, ignore_errors=True)
    return out


def phase_plan_cache_serve():
    """Phase 40: full-width moe-gpt2 served through the launcher with
    ``--plan-cache DIR --precompute-plans`` (``CACHE_SERVE_ARGS``), on
    one device and over 4 virtual ranks, each against the same run
    without the cache: no
    ``build_exchange_plan`` call after the warm-up, logits and tokens bit
    for bit, the same K1 launches; prefill tokens/s and decode ms a step
    beside the uncached run's (host clock, one run each)."""
    import shutil
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch.launch import serve
    out = {}
    for label, args in (("one device", CACHE_SERVE_ARGS),
                        ("4 ranks", CACHE_SERVE_ARGS
                         + ["--model-axis", "4"])):
        runs = {}
        for cached in (False, True):
            extra = []
            if cached:
                shutil.rmtree(PLAN_CACHE_DIR, ignore_errors=True)
                extra = ["--plan-cache", PLAN_CACHE_DIR,
                         "--precompute-plans"]
            counters = _kernel_counters()
            for fn in counters.values():
                fn.launches = 0
            n0 = tex.BUILD_CALLS
            res = serve.main(args + extra)
            runs[cached] = (res, {k: fn.launches
                                  for k, fn in counters.items()},
                            tex.BUILD_CALLS - n0)
        (cold, cl, cb), (warm, wl, wb) = runs[False], runs[True]
        same = dict(
            prefill=torch.equal(cold["prefill_logits"],
                                warm["prefill_logits"]),
            tokens=torch.equal(cold["tokens"], warm["tokens"]),
            logits=all(torch.equal(a, b) for a, b in zip(
                cold["step_logits"] + cold["gen_logits"],
                warm["step_logits"] + warm["gen_logits"])))
        info = dict(build_calls_uncached=cb, build_calls_cached=wb,
                    plan_cache=warm["plan_cache"], bitwise=same,
                    k1_launches=[cl["expert_ffn"], wl["expert_ffn"]],
                    launches_equal=cl == wl,
                    prefill_tok_s=[cold["prefill_tok_s"],
                                   warm["prefill_tok_s"]],
                    decode_ms_per_step=[cold["decode_ms_per_step"],
                                        warm["decode_ms_per_step"]])
        log(f"plan-cache serve, {label} [uncached, cached]: "
            + json.dumps(info))
        if wb != 0 or cb == 0:
            raise SystemExit(f"plan-cache serve ({label}): {wb} plans built "
                             f"with a warm cache ({cb} without)")
        if not all(same.values()) or not info["launches_equal"]:
            raise SystemExit(f"plan-cache serve ({label}) is not the "
                             f"uncached run bit for bit: {info}")
        del runs, cold, warm
        torch.cuda.empty_cache()
        info["alternating"] = alt = _cache_serve_timing(
            1 if label == "one device" else 4)
        log(f"plan-cache serve, {label}, {alt['rounds']} alternating rounds: "
            + json.dumps(alt))
        if alt["plans_built_cached"] != 0:
            raise SystemExit(f"plan-cache serve ({label}): the cached timing "
                             f"runs built {alt['plans_built_cached']} plans")
        out[label] = info
    shutil.rmtree(PLAN_CACHE_DIR, ignore_errors=True)
    return out


def run_objective_phases(lanes=None):
    """Phases 36-40 (``lanes``: phase 36's record, None to run it)."""
    log("objectives, K1's lane map, plan cache (phases 36-40):")
    lanes = phase_k1_lanes() if lanes is None else lanes
    rep = phase_replicate_ep()
    parity = phase_replicate_parity()
    overlap = phase_overlap_ep()
    cache = phase_plan_cache_serve()
    return dict(lanes=lanes, replicate=rep, parity=parity, overlap=overlap,
                cache=cache)


# ---------------------------------------------------------------------------
# slice 15: continuous batching, slot recycling, the traced EP train and
# checkpoints (phases 41-44)
# ---------------------------------------------------------------------------

CONT_ARGS = ["--arch", "moe-gpt2", "--continuous", "--batch", "8",
             "--prompt-len", "64", "--gen", "32", "--requests", "24",
             "--burst", "3", "--arrival-every", "4", "--device", "cuda",
             "--seed", "0"]
# the fixed batch of the same 8 slots, prompt and budget: its prompts are
# the stream's first 8 (one numpy draw from the same seed)
CONT_FIXED_ARGS = ["--arch", "moe-gpt2", "--batch", "8", "--prompt-len",
                   "64", "--gen", "32", "--device", "cuda", "--seed", "0"]
CONT_MIN_CHURN = 16
# the profiled window of the continuous loop: model calls skipped, then
# one warm-up call and this many recorded
CONT_PROFILE_SKIP, CONT_PROFILE_STEPS = 40, 32
# its own run: the stream's first 8 requests (the later flag wins), which
# keep every slot busy through the window (each feeds its prompt and
# decodes for 96 model calls)
CONT_PROFILE_ARGS = CONT_ARGS + ["--requests", "8"]
# phase 42: slot 0 recycled after WARM tokens, then SEQ tokens; the
# window of 48 wraps the ring during the warm-up
RECYCLE = dict(B=2, s_max=80, warm=60, seq=16, window=48, hymba_layers=4)
TRACE_PHASES = ("plan_build", "condense", "exchange", "dispatch",
                "expert_ffn", "combine")
CKPT_ARGS = ["--arch", "moe-gpt2", "--num-layers", "2", "--steps", "1",
             "--global-batch", "2", "--seq-len", "256", "--device", "cuda",
             "--seed", "0"]


def _out_dir(name: str) -> Path:
    """A fresh directory for a phase's files under ``build/``."""
    import shutil
    d = ROOT / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _continuous_profile(args):
    """The continuous serve run of ``args`` with torch.profiler recording
    ``CONT_PROFILE_STEPS`` model calls after ``CONT_PROFILE_SKIP`` (the
    loop steps the profiler after each call's observe): device ms a call
    and the device-busy share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.launch import serve
    from repro_torch.serve import scheduler as tsched
    orig = tsched.ContinuousScheduler.observe
    marks = []
    skip, n = CONT_PROFILE_SKIP, CONT_PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=skip, warmup=1, active=n,
                                   repeat=1)) as prof:
        def observe(self, logits, *, now):
            orig(self, logits, now=now)
            marks.append(time.perf_counter())
            prof.step()

        tsched.ContinuousScheduler.observe = observe
        try:
            serve.main(args)
        finally:
            tsched.ContinuousScheduler.observe = orig
    # the schedule's step annotations appear as device rows too
    rows = [r for r in _device_rows(prof)
            if not r[1].startswith("ProfilerStep")]
    busy = sum(r[0] for r in rows)
    wall_us = (marks[skip + n] - marks[skip]) * 1e6
    torch.cuda.empty_cache()
    return dict(calls=n, wall_ms_per_call=wall_us / n / 1e3,
                device_ms_per_call=busy / n / 1e3,
                device_busy_share=busy / wall_us if rows else None,
                top=[{"op": k[:60], "ms_per_call": d / n / 1e3}
                     for d, k, _ in rows[:6]])


def _decode_step_syncs():
    """The device syncs of one full-width moe-gpt2 decode step of 8
    slots (``model.decode_step``), after two warm-up steps."""
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    model = build_model(get_config("moe-gpt2"), device="cuda", seed=0)
    cache = model.new_cache(8, 96)
    toks = torch.ones((8, 1), dtype=torch.int32, device="cuda")
    for _ in range(2):
        model.decode_step(cache, toks, luffy=luffy)
    n = _count_syncs(lambda: model.decode_step(cache, toks, luffy=luffy))
    del model, cache
    torch.cuda.empty_cache()
    return n or 0


def phase_continuous_serve(slice_info=None):
    """Phase 41: full-width moe-gpt2 served continuously through
    ``repro_torch.launch.serve --continuous`` (``CONT_ARGS``: 8 slots,
    prompt 64, 32 tokens, 24 requests in bursts of 3 every 4 steps) with
    ``--metrics-json`` and ``--trace-out``, every kernel counter 0 just
    before and read just after: all 24 requests finish, slots recycle
    (``CONT_MIN_CHURN``), K1 launches exactly 12 x the model calls and
    nothing else launches, 36 bf16 weight casts, one ``serve/*`` record
    and one ``decode`` span a model call in a valid Chrome trace; the
    tokens of requests 0-7 bit for bit the fixed batch's
    (``CONT_FIXED_ARGS``). Then untraced, uncached and with ``--plan-cache
    --precompute-plans`` (0 plans built, tokens bit for bit): tokens/s,
    the SLO means and ms a model call of each, and the uncached run's
    device syncs (``_count_syncs``); then one profiled window of the loop
    on a short run of its own (``CONT_PROFILE_ARGS``; device-busy share).
    ``slice_info``: phase 4's, to print beside."""
    import numpy as np
    import torch
    import repro_torch.plan.exchange as tex
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.launch import serve
    from repro_torch.obs import metrics as obs_metrics
    n_layers = get_config("moe-gpt2").num_layers
    out = _out_dir("phase41")
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    kexp.weight_bf16.casts = 0
    res = serve.main(CONT_ARGS + ["--metrics-json", str(out / "m.jsonl"),
                                  "--trace-out", str(out / "trace.json")])
    launches = {k: fn.launches for k, fn in counters.items()}
    casts = kexp.weight_bf16.casts
    calls = res["model_calls"]
    want = {k: 0 for k in counters}
    want["expert_ffn"] = n_layers * calls
    records = obs_metrics.read_jsonl(out / "m.jsonl")
    serve_recs = sum("serve/active_slots" in r["metrics"] for r in records)
    doc = json.loads((out / "trace.json").read_text())
    events = doc["traceEvents"]
    valid = all({"name", "ph", "ts", "pid", "tid"} <= set(e)
                and (e["ph"] != "X" or e["dur"] >= 0.0) for e in events)
    decode_spans = sum(e["ph"] == "X" and e["name"] == "decode"
                       for e in events)
    finite = all(bool(np.isfinite(lg).all()) for lg in res["step_logits"])
    tokens, churn = res["requests"], res["slot_churn"]
    del res
    fixed = serve.main(CONT_FIXED_ARGS)
    fixed_tokens = fixed["tokens"].tolist()
    fixed_info = dict(decode_ms_per_step=fixed["decode_ms_per_step"])
    del fixed
    torch.cuda.empty_cache()
    same_as_fixed = [tokens.get(i) == fixed_tokens[i] for i in range(8)]

    cache_dir = out / "plans"
    held = []
    syncs = _count_syncs(lambda: held.append(serve.main(CONT_ARGS)))
    plain = held.pop()
    n0 = tex.BUILD_CALLS
    cached = serve.main(CONT_ARGS + ["--plan-cache", str(cache_dir),
                                     "--precompute-plans"])
    built = tex.BUILD_CALLS - n0
    runs = {name: dict(tok_s=r["tok_s"], slo=r["slo"],
                       ms_per_model_call=r["decode_ms_per_step"],
                       model_calls=r["model_calls"], steps=r["steps"])
            for name, r in (("uncached", plain), ("cached", cached))}
    cached_same = cached["requests"] == tokens == plain["requests"]
    del plain, cached
    torch.cuda.empty_cache()
    # the syncs of one decode step alone, to split the loop's count into
    # the step's own and the loop's (the logits' copy to the host)
    step_syncs = _decode_step_syncs()
    prof = _continuous_profile(CONT_PROFILE_ARGS)
    # the profiler slows the host: the device time a call over the
    # untraced run's wall time a call too
    prof["device_share_of_untraced_call"] = (
        prof["device_ms_per_call"] / runs["uncached"]["ms_per_model_call"])
    info = dict(requests=24, finished=len(tokens), model_calls=calls,
                slot_churn=churn, launches=launches, launches_expected=want,
                weight_casts=casts, weight_casts_expected=3 * n_layers,
                serve_records=serve_recs, decode_spans=decode_spans,
                trace_valid=valid, tokens_0_7_equal_fixed=same_as_fixed,
                plans_built_cached=built, cached_tokens_equal=cached_same,
                untraced_syncs=syncs,
                untraced_syncs_per_model_call=(syncs or 0) / calls,
                decode_step_syncs=step_syncs,
                runs=runs, fixed_batch=fixed_info, profile=prof,
                phase4=None if slice_info is None else {
                    k: slice_info[k] for k in ("decode_ms_per_step",
                                               "prefill_tok_s")})
    log("continuous serve: " + json.dumps(info))
    bad = []
    if len(tokens) != 24 or not all(len(t) == 32 for t in tokens.values()):
        bad.append("not every request finished with 32 tokens")
    if not finite:
        bad.append("logits not finite")
    if launches != want:
        bad.append(f"launches {launches} != {want}")
    if casts != 3 * n_layers:
        bad.append(f"{casts} bf16 weight casts")
    if serve_recs != calls or decode_spans != calls or not valid:
        bad.append(f"{serve_recs} serve records / {decode_spans} decode "
                   f"spans for {calls} model calls, trace valid {valid}")
    if not all(same_as_fixed):
        bad.append(f"requests 0-7 differ from the fixed batch: "
                   f"{same_as_fixed}")
    if built != 0 or not cached_same:
        bad.append(f"cached run: {built} plans built, tokens equal "
                   f"{cached_same}")
    if churn < CONT_MIN_CHURN:
        bad.append(f"slot churn {churn} < {CONT_MIN_CHURN}")
    if bad:
        raise SystemExit("continuous serve: " + "; ".join(bad))
    return info


def _recycled_vs_fresh(model, R=RECYCLE, seed: int = 0):
    """Slot 0 of ``model``'s decode cache, recycled after a warm-up of
    ``R["warm"]`` tokens (``admit_slot``), against a fresh cache, both
    fed the same sequence while slot 1 keeps decoding: slot 0's logits a
    step, both runs, and whether the admission zeroed the slot's
    recurrent state rows (Mamba or RWKV)."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.serve.engine import RECURRENT_KEYS
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    V = model.cfg.vocab_size
    r = np.random.default_rng(seed + 1)
    warm = torch.as_tensor(r.integers(1, V, (R["B"], R["warm"])),
                           dtype=torch.int32, device="cuda")
    seq = torch.as_tensor(r.integers(1, V, (R["seq"], 2)),
                          dtype=torch.int32, device="cuda")

    def feed(cache):
        out = []
        for t in range(R["seq"]):
            lg, cache = model.decode_step(cache, seq[t][:, None], luffy=luffy)
            out.append(lg[0].clone())
        return torch.stack(out)

    cache = model.new_cache(R["B"], R["s_max"])
    for t in range(R["warm"]):
        _, cache = model.decode_step(cache, warm[:, t:t + 1], luffy=luffy)
    model.admit_slot(cache, 0, cache["pos"])
    zeroed = all(not g[k][0].any() for g in cache["layers"]
                 for k in RECURRENT_KEYS if k in g)
    got = feed(cache)
    want = feed(model.new_cache(R["B"], R["s_max"]))
    del cache
    torch.cuda.empty_cache()
    return got, want, zeroed


def phase_recycled_slot():
    """Phase 42: a recycled decode slot on the card bit for bit a fresh
    one (``RECYCLE``): full-width moe-gpt2 with global attention and with
    every window set to 48, so the ring wraps during the warm-up (K1
    decodes both); a full-width hymba-1.5b cut of 4 layers, its Mamba
    state rows zeroed by the admission."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.models.model import build_model
    gpt = get_config("moe-gpt2")
    cases = {
        "moe-gpt2": gpt,
        "moe-gpt2_window48": dataclasses.replace(
            gpt, attn=dataclasses.replace(
                gpt.attn, window_pattern=(RECYCLE["window"],))),
        "hymba-1.5b_4_layers": dataclasses.replace(
            get_config("hymba-1.5b"), num_layers=RECYCLE["hymba_layers"]),
    }
    info, bad = {}, []
    for name, cfg in cases.items():
        before = kexp.expert_ffn.launches
        model = build_model(cfg, device="cuda", seed=0)
        got, want, zeroed = _recycled_vs_fresh(model)
        del model
        torch.cuda.empty_cache()
        same = bool(torch.equal(got, want))
        info[name] = dict(bitwise=same, mamba_rows_zeroed=zeroed,
                          max_abs=(got - want).abs().max().item(),
                          finite=bool(torch.isfinite(got).all()),
                          k1_launches=kexp.expert_ffn.launches - before)
        if not (same and zeroed and info[name]["finite"]):
            bad.append(name)
    log("recycled slot: " + json.dumps(info))
    if bad:
        raise SystemExit(f"a recycled slot is not bit for bit a fresh one: "
                         f"{bad} {info}")
    return info


def phase_traced_ep(ep_info=None, ep_prof=None):
    """Phase 43: phase 11's EP train run (``EP_ARGS``, 6 steps) with
    ``--trace-out --metrics-json --log-file``: losses, condensation rates,
    buckets and every migration perm bit for bit the untraced run's
    (``ep_info``, phase 11's, or one made here); each exchange phase
    (``TRACE_PHASES``) recorded once per MoE sublayer forward (12 x 6,
    none from the remat recompute) and nothing else but the ``data`` and
    ``step`` spans; ``exchange`` at least ``dispatch`` + ``expert_ffn`` +
    ``combine`` by inclusive time; ``residual/step/*`` from step 4 on.
    The run ends with ``--trace``'s probe (since slice 16): inside its
    ``probe`` span one ``probe_exchange`` span on device 0 around one
    exchange of its own (its plan after the run's, its residual record
    after the steps'), which the counts above leave out. Logs the
    untraced step's device syncs (phase 14's count, ``ep_prof``, made
    here when not given) and the traced step's time beside the untraced
    one's."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.obs import metrics as obs_metrics
    if ep_info is None:
        ep_info = phase_ep_train()
    if ep_prof is None:
        ep_prof = phase_ep_profile()
    out = _out_dir("phase43")
    res, launches, plans, _ = _ep_run(
        EP_ARGS + ["--trace-out", str(out / "trace.json"), "--metrics-json",
                   str(out / "m.jsonl"), "--log-file", str(out / "log.json")])
    cfg, steps = res["cfg"], res["steps"]
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    tracer = res["tracer"]
    summary = tracer.summary()
    (probe,) = tracer.spans("probe")

    def in_probe(e):
        return probe["ts"] <= e["ts"] \
            and e["ts"] + e["dur"] <= probe["ts"] + probe["dur"]

    counts, probe_counts = {}, {}
    for e in tracer.spans():
        if e is not probe:
            side = probe_counts if in_probe(e) else counts
            side[e["name"]] = side.get(e["name"], 0) + 1
    want_counts = {k: n_moe * len(steps) for k in TRACE_PHASES}
    want_counts.update(data=len(steps), step=len(steps))
    per_step = ep_info["per_step"]
    perms = [p for p, _ in plans]
    same = {k: [st[k] for st in steps] == per_step[k]
            for k in ("loss", "condense_rate", "bucket")}
    # the probe's own plan comes after the run's
    same["perms"] = len(perms) == len(ep_info["_perms"]) + 1 and all(
        (a is None and b is None) or np.array_equal(a, b)
        for a, b in zip(perms, ep_info["_perms"]))
    records = obs_metrics.read_jsonl(out / "m.jsonl")
    log_list = json.loads((out / "log.json").read_text())
    residual = [r["step"] for r in records
                if "residual/step/ratio" in r["metrics"]]
    inclusive = {k: summary[k]["total_us"] / 1e3 for k in summary}
    parts = sum(inclusive.get(k, 0.0)
                for k in ("dispatch", "expert_ffn", "combine"))
    probe_devices = [e["args"].get("device")
                     for e in tracer.spans("probe_exchange")]
    info = dict(span_counts=counts, span_counts_expected=want_counts,
                probe_span_counts=probe_counts, probe_devices=probe_devices,
                inclusive_ms=inclusive, bitwise_untraced=same,
                residual_steps=residual, records=len(records),
                log_file_records=len(log_list),
                traced_median_step_ms_after_0=statistics.median(
                    st["step_ms"] for st in steps[1:]),
                untraced_median_step_ms_after_0=ep_info[
                    "median_step_ms_after_0"],
                untraced_step_syncs=ep_prof.get("step_syncs"),
                launches=launches)
    log("traced EP train: " + json.dumps(info))
    del res, steps
    torch.cuda.empty_cache()
    bad = []
    if not all(same.values()):
        bad.append(f"traced run differs from the untraced one: {same}")
    if counts != want_counts:
        bad.append(f"span counts {counts} != {want_counts}")
    if probe_devices != [0] or probe_counts.get("expert_ffn") != 1:
        bad.append(f"probe spans {probe_counts} on devices {probe_devices}")
    if not inclusive.get("exchange", 0.0) >= parts:
        bad.append(f"exchange {inclusive.get('exchange')} ms < its phases "
                   f"{parts} ms")
    if residual != list(range(4, len(per_step["loss"]))):
        bad.append(f"residual records at steps {residual}")
    if len(log_list) != len(per_step["loss"]) \
            or len(records) != len(log_list) + 1 \
            or records[-1]["step"] != len(log_list) \
            or "residual/expert_ffn/ratio" not in records[-1]["metrics"]:
        bad.append(f"{len(records)} metrics records (the probe's last), "
                   f"{len(log_list)} in the log file")
    if bad:
        raise SystemExit("traced EP train: " + "; ".join(bad))
    return info


def phase_checkpoint():
    """Phase 44: one train step of a 2-layer full-width moe-gpt2 cut on
    the card with ``--ckpt`` (``CKPT_ARGS``); the checkpoint, in the
    reference's stacked layout, restored onto the card (``restore(...,
    device="cuda")`` and ``convert.from_reference``) bit for bit the
    parameters the launcher saved."""
    import numpy as np
    import torch
    from repro_torch import checkpoint, convert
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    out = _out_dir("phase44")
    saved = []
    orig = checkpoint.save

    def record(path, tree, **kw):
        saved.append([np.array(leaf) for _, leaf in
                      checkpoint._flatten(tree)])
        return orig(path, tree, **kw)

    checkpoint.save = record
    try:
        res = train.main(CKPT_ARGS + ["--ckpt", str(out)])
    finally:
        checkpoint.save = orig
    cfg = res["cfg"]
    like = convert.to_reference(build_model(cfg, device="cuda").params, cfg)
    on_card, step = checkpoint.restore(str(out), like, device="cuda")
    leaves = [t for _, t in checkpoint._flatten(on_card)]
    exact = len(leaves) == len(saved[-1]) and all(
        t.is_cuda and torch.equal(t.cpu(), torch.from_numpy(a))
        for t, a in zip(leaves, saved[-1]))
    params = convert.from_reference(checkpoint.restore(str(out), like)[0],
                                    cfg, device="cuda")
    again = convert.to_reference(params, cfg)
    exact_port = all(np.array_equal(a, b) for a, b in zip(
        [leaf for _, leaf in checkpoint._flatten(again)], saved[-1]))
    spec = json.loads((out / "spec.json").read_text())
    info = dict(step=step, leaves=len(leaves),
                bytes=sum(a.nbytes for a in saved[-1]),
                shards=len(list(out.glob("shard_*.npz"))),
                restored_bitwise=exact, from_reference_bitwise=exact_port,
                spec_fields=sorted(spec), loss=res["steps"][0]["loss"])
    log("checkpoint: " + json.dumps(info))
    del res, on_card, params
    torch.cuda.empty_cache()
    if step != 1 or not exact or not exact_port:
        raise SystemExit(f"checkpoint restore: {info}")
    return info


# ---------------------------------------------------------------------------
# slice 16: measured calibration (K1 and K2 as its probes), the autotuner,
# the traced probe and the modeled dry run (phases 45-48)
# ---------------------------------------------------------------------------

# the calibration's mesh: 4 virtual ranks, 2 nodes of 2
CALIB_MESH = dict(model=4, nodes=2)
# the calibrated, autotuned EP train run: full-width moe-gpt2, the knobs
# (wire, schedule, objective, similarity, wire dtype) left to the artifact
TUNED_ARGS = ["--arch", "moe-gpt2", "--steps", "3", "--global-batch", "8",
              "--seq-len", "1024", "--device", "cuda", "--seed", "0",
              "--model-axis", "4", "--nodes", "2"]
# serve with --autotune over 4 ranks, one knob given explicitly
TUNED_SERVE_ARGS = ["--arch", "moe-gpt2", "--batch", "8", "--prompt-len",
                    "64", "--gen", "8", "--prefill", "batch", "--model-axis",
                    "4", "--device", "cuda", "--seed", "0"]
TUNED_SERVE_EXPLICIT = ["--exec-mode", "pipeline"]
SERVE_KNOBS = ("exec_mode", "pipeline_chunks", "plan_objective",
               "hier_dedup", "similarity_backend", "lsh_bits", "wire_dtype")
# the reference's ledger schema (tests/test_ledger_schema.py), version 6
LEDGER_KEYS = {
    "": {"schema_version", "calibration", "topology", "dedup_factor",
         "buckets", "wire", "plan_reuse", "condensation", "decode",
         "autotune"},
    "topology": {"nodes", "devices_per_node", "bw_ratio"},
    "wire": {"dtype", "precision", "row_bytes", "row_bytes_f32",
             "scale_block", "shipped_vanilla_bytes", "shipped_migrate_bytes",
             "shipped_pipelined_bytes"},
    "plan_reuse": {"mode", "moe_sublayers", "n_slots",
                   "plans_built_per_step", "plans_reused_per_step",
                   "revalidation_mismatches", "planning_ms_per_plan",
                   "revalidate_ms_per_check", "planning_ms_saved_per_step"},
    "condensation": {"backend", "group_size", "lsh_bits",
                     "measured_pairs_per_step", "similarity_ms_per_build",
                     "dedup_wire", "condense_plan"},
    "decode": {"tokens", "combine_ms", "shared_ffn_ms", "sync_ms",
               "overlap_ms", "modeled_speedup"},
    "autotune": {"applied", "key", "knobs", "modeled_step_ms",
                 "default_step_ms", "modeled_savings_ms", "candidates"},
}
LEDGER_BUCKET_KEYS = {"flat", "hier", "overlap"}


def _probe_launches():
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import similarity as ksim
    return {"expert_ffn": kexp.expert_ffn.launches,
            "masked_similarity_fused": ksim.masked_similarity_fused.launches}


def _calibrate_counted(mesh, topo, out, force=False):
    """``run_calibration`` with K1's and K2's counters set to 0 just
    before and read just after; returns (fit, launches, seconds)."""
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import similarity as ksim
    from repro_torch.obs import calibrate as obs_cal
    kexp.expert_ffn.launches = 0
    ksim.masked_similarity_fused.launches = 0
    t = time.perf_counter()
    calib = obs_cal.run_calibration(mesh, topo, device="cuda", out_dir=out,
                                    force=force)
    return calib, _probe_launches(), time.perf_counter() - t


def phase_calibrate():
    """Phase 45: ``run_calibration`` on the card over 4 virtual ranks (2
    nodes of 2): every field finite and within the rails; K1 and K2 each
    launched by the probes (their counters, one warm-up and three timed
    launches each); a second call loads the artifact and launches
    neither; ``force=True`` measures again. Logs the fit beside the
    card's name and power limit. Returns the fit, its directory and the
    probes' launches."""
    from repro_torch.launch.mesh import make_host_mesh, topology_for_mesh
    from repro_torch.obs import calibrate as obs_cal
    out = _out_dir("phase45")
    mesh = make_host_mesh(**CALIB_MESH)
    topo = topology_for_mesh(mesh)
    calib, launches, secs = _calibrate_counted(mesh, topo, out)
    again, launches_load, secs_load = _calibrate_counted(mesh, topo, out)
    forced, launches_force, _ = _calibrate_counted(mesh, topo, out,
                                                   force=True)
    rails = {
        "intra_bw": (obs_cal._MIN_BW, obs_cal._MAX_BW),
        "inter_bw": (obs_cal._MIN_BW, obs_cal._MAX_BW),
        "intra_lat": (obs_cal._MIN_LAT, obs_cal._MAX_LAT),
        "inter_lat": (obs_cal._MIN_LAT, obs_cal._MAX_LAT),
        "chunk_overhead_ms": (1e-4, 1e3), "plan_step_us": (0.01, math.inf),
        "sim_speed": (obs_cal._MIN_SPEED, obs_cal._MAX_SPEED),
        "ffn_speed": (obs_cal._MIN_SPEED, obs_cal._MAX_SPEED)}
    bad = [k for k, (lo, hi) in rails.items()
           if not (math.isfinite(getattr(calib, k))
                   and lo <= getattr(calib, k) <= hi)]
    want_probe = {"expert_ffn": 4, "masked_similarity_fused": 4}
    # the probes' least times on the card: K1 at bf16 h and weights, its
    # three products; K2's measured pairs' dot products (a whole Gram)
    _, R, d, F = calib.samples["ffn_shape"]
    _, G, dg = calib.samples["similarity_shape"]
    k1_bound = _bound(2 * (2 * R * d + 3 * d * F), 3 * 2 * R * d * F,
                      BF16_TC_FLOPS)
    k2_bound = _bound(2 * G * dg + 4 * G * G, 2 * G * G * dg, BF16_TC_FLOPS)
    info = dict(
        card=CARD.get("smi"), key=calib.key, seconds=secs,
        load_seconds=secs_load,
        fit={k: getattr(calib, k) for k in rails},
        forced_fit={k: getattr(forced, k) for k in rails},
        k1_probe_ms=calib.samples["ffn_s"] * 1e3,
        k1_probe_shape=calib.samples["ffn_shape"],
        k2_probe_ms=calib.samples["similarity_s"] * 1e3,
        k2_probe_shape=calib.samples["similarity_shape"],
        k1_probe_bound=k1_bound, k2_probe_bound=k2_bound,
        probe_dtype=calib.samples["probe_dtype"],
        a2a_intra=calib.samples["a2a_intra"],
        a2a_inter=calib.samples["a2a_inter"],
        psum=calib.samples["psum"], planning=calib.samples["planning"],
        launches=launches, launches_load=launches_load,
        launches_force=launches_force)
    log("calibration (virtual ranks: the collectives are copies in device "
        "memory): " + json.dumps(info))
    if bad or launches != want_probe or launches_force != want_probe \
            or any(launches_load.values()) or again != calib \
            or not calib.key.endswith("__gpu") \
            or obs_cal.load_calibration(out, calib.key) != forced:
        raise SystemExit(f"calibration: rails {bad}, launches {launches} / "
                         f"{launches_load} / {launches_force}, key "
                         f"{calib.key}")
    return {"calib": forced, "dir": out, "launches": launches,
            "info": info}


def _tuned_expected(calib):
    """``autotune_config`` recomputed from the phase-45 artifact for the
    ``TUNED_ARGS`` run (the train launcher's workload arguments)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, topology_for_mesh
    from repro_torch.obs import autotune as obs_at
    cfg = get_config("moe-gpt2")
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    topo = calib.topology(topology_for_mesh(make_host_mesh(**CALIB_MESH)))
    return obs_at.autotune_config(
        topo=topo, tokens=8 * 1024, top_k=cfg.moe.top_k, d_model=cfg.d_model,
        d_ff=cfg.moe.d_ff, num_layers=n_moe, n_moe=n_moe, n_slots=8,
        num_experts=cfg.moe.num_experts, mesh_devices=4, group_size=128,
        calib=calib, backend="gpu")


def phase_tuned_train(cal=None):
    """Phase 46: full-width moe-gpt2 trained over 4 virtual ranks (2
    nodes of 2) with ``--calibrate`` and ``--autotune`` on phase 45's
    directory, 3 steps: the fit loaded (equal to phase 45's), finite
    losses, K1 launched, the knobs the artifact's, equal to
    ``autotune_config`` recomputed from phase 45's fit, the run_info
    flags set; logs the modeled step (the tuner's per-step exchange,
    planning and similarity time) beside the measured median step, and
    the modeled default beside the measured median of the same
    calibrated run at the default knobs."""
    import statistics
    from repro_torch.obs import autotune as obs_at
    if cal is None:
        cal = phase_calibrate()
    d = str(cal["dir"])
    res, launches, _, _ = _ep_run(TUNED_ARGS + ["--calibrate", d,
                                                "--autotune", d])
    want = _tuned_expected(cal["calib"])
    tuned, luffy, steps = res["tuned"], res["luffy"], res["steps"]
    applied = {k: getattr(luffy, k) for k in obs_at.TUNABLE_KNOBS}
    losses = [s["loss"] for s in steps]
    median = statistics.median(s["step_ms"] for s in steps[1:])
    # the same calibrated run at the default knobs, for the measured side
    # of the tuner's modeled saving
    base, _, _, _ = _ep_run(TUNED_ARGS + ["--calibrate", d])
    base_median = statistics.median(s["step_ms"] for s in base["steps"][1:])
    info = dict(knobs=applied, tuned_key=tuned.key,
                modeled_step_ms=tuned.modeled_step_ms,
                default_step_ms=tuned.default_step_ms,
                candidates=tuned.candidates,
                measured_median_step_ms=median,
                default_knobs_measured_median_step_ms=base_median,
                default_knobs_step_ms=[s["step_ms"] for s in base["steps"]],
                step_ms=[s["step_ms"] for s in steps], losses=losses,
                chunks=[s["chunks"] for s in steps],
                gpu_speed=luffy.gpu_speed,
                chunk_overhead_ms=luffy.chunk_overhead_ms,
                run=res["log"][0]["run"], launches=launches)
    log("calibrated autotuned EP train: " + json.dumps(info))
    ok = (all(math.isfinite(x) for x in losses)
          and res["calibration"] == cal["calib"]
          and tuned.to_json() == want.to_json()
          and applied == obs_at.resolve_knobs(
              {k: None for k in obs_at.TUNABLE_KNOBS}, want)
          and luffy.gpu_speed == cal["calib"].ffn_speed
          and res["log"][0]["run"]["calibrated"]
          and res["log"][0]["run"]["autotuned"]
          and launches["expert_ffn"] > 0)
    ok = ok and all(math.isfinite(st["loss"]) for st in base["steps"])
    del res, base
    import torch
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"calibrated autotuned EP train: {info}; want "
                         f"{want.knobs}")
    return info


def phase_traced_probe(cal=None):
    """Phase 47: phase 46's run, 1 step, with ``--trace-out`` and
    ``--metrics-json``: the run ends with exactly one ``probe_exchange``
    span, on device 0, and a residual record of the probe's expert FFN
    (K1 on the card) against the calibrated FFN speed, dispersion 1.0 on
    one card."""
    if cal is None:
        cal = phase_calibrate()
    d = str(cal["dir"])
    out = _out_dir("phase47")
    res, launches, _, _ = _ep_run(
        TUNED_ARGS[:3] + ["1"] + TUNED_ARGS[4:]
        + ["--calibrate", d, "--autotune", d, "--trace-out",
           str(out / "trace.json"), "--metrics-json", str(out / "m.jsonl")])
    spans = res["tracer"].spans("probe_exchange")
    last = json.loads((out / "m.jsonl").read_text().splitlines()[-1])
    met = last["metrics"]
    trace = json.loads((out / "trace.json").read_text())
    info = dict(spans=[s["args"] for s in spans],
                probe_ms=[s["dur"] / 1e3 for s in spans],
                residual={k: v for k, v in met.items()
                          if k.startswith("residual/")},
                record_step=last["step"],
                trace_events=len(trace["traceEvents"]))
    log("traced probe: " + json.dumps(info))
    del res
    ok = (len(spans) == 1 and spans[0]["args"].get("device") == 0
          and last["step"] == 1
          and met.get("residual/expert_ffn/ratio", 0) > 0
          and met.get("residual/device_dispersion") == 1.0
          and any(e["name"] == "probe_exchange"
                  for e in trace["traceEvents"]))
    if not ok:
        raise SystemExit(f"traced probe: {info}")
    return info


def phase_tuned_serve_dryrun(cal=None):
    """Phase 48: full-width moe-gpt2 served over 4 virtual ranks with
    ``--autotune`` and an explicit ``--exec-mode pipeline``: the flag
    kept, the rest the artifact's, tokens and prefill logits bit for bit
    the run given all those knobs explicitly. Then ``launch.dryrun`` on
    the 16 x 16 layout in 4 nodes priced on phase 45's artifact: its
    ``calibration`` key set and the reference's ledger key sets."""
    import torch
    from repro_torch.launch import dryrun, serve
    from repro_torch.obs.calibrate import save_calibration
    if cal is None:
        cal = phase_calibrate()
    out = _out_dir("phase48")
    res = serve.main(TUNED_SERVE_ARGS + TUNED_SERVE_EXPLICIT
                     + ["--autotune", str(out)])
    knobs = res["knobs"]
    flags = []
    for k in SERVE_KNOBS:
        flags += ["--" + k.replace("_", "-"), str(knobs[k])]
    explicit = serve.main(TUNED_SERVE_ARGS + flags)
    same = (explicit["knobs"] == knobs
            and torch.equal(res["tokens"], explicit["tokens"])
            and torch.equal(res["prefill_logits"],
                            explicit["prefill_logits"]))
    tuned = res["tuned"]
    path = save_calibration(out / "calib", cal["calib"])
    rec = dryrun.main(["--arch", "moe-gpt2", "--shape", "train_4k",
                       "--nodes", "4", "--calibration", str(path),
                       "--out", str(out / "dryrun.json")])
    led = rec["comm_ledger"]
    keys_ok = (set(led) == LEDGER_KEYS[""]
               and all(set(led[s]) == k for s, k in LEDGER_KEYS.items() if s)
               and all(set(b) == LEDGER_BUCKET_KEYS
                       for b in led["buckets"].values()))
    info = dict(knobs=knobs, tuned_knobs=tuned.knobs,
                tuned_modeled_ms=tuned.modeled_step_ms,
                tokens_bitwise=same, dryrun_status=rec["status"],
                ledger_calibration=led["calibration"],
                ledger_autotune=led["autotune"],
                ledger_overlap_0=led["buckets"]["0.0"]["overlap"],
                ledger_keys_ok=keys_ok)
    log("tuned serve and dry run: " + json.dumps(info))
    del res, explicit
    torch.cuda.empty_cache()
    if not (same and knobs["exec_mode"] == "pipeline"
            and all(knobs[k] == tuned.knobs[k] for k in SERVE_KNOBS
                    if k not in ("exec_mode", "hier_dedup"))
            and rec["status"] == "modeled"
            and led["calibration"] == cal["calib"].key and keys_ok):
        raise SystemExit(f"tuned serve and dry run: {info}")
    return info


def run_tuning_phases():
    """Phases 45-48 in order, phases 46-48 on phase 45's artifact."""
    cal = phase_calibrate()
    return {"calibrate": cal, "train": phase_tuned_train(cal),
            "probe": phase_traced_probe(cal),
            "serve": phase_tuned_serve_dryrun(cal)}


# slice 17: the attention decoders of ROADMAP item 8.1 at full width.
# Phase 50 serves each at the depth below (all full but yi-34b's, if it
# must be cut to fit 80 GB: listed in PERF.md), bf16 compute, random
# weights from seed 0; a prompt of S tokens in batches of B, then 32
# greedy tokens from the cache the prefill's K/V fill.
ARCH_SERVE = {
    "olmoe-1b-7b": dict(layers=16, B=4, S=2048),
    "yi-34b": dict(layers=60, B=2, S=2048),
    "stablelm-12b": dict(layers=40, B=4, S=2048),
    "starcoder2-15b": dict(layers=40, B=1, S=8192),
    "gemma3-12b": dict(layers=48, B=2, S=4096),
}
ARCH_GEN = 32
# phase 49: K5 at each arch's prefill shape (B, S, H, KV, hd, window);
# gemma3's local and global layers apart
K5_ARCH_SHAPES = {
    "olmoe-1b-7b": (4, 2048, 16, 16, 128, None),
    "yi-34b": (2, 2048, 56, 8, 128, None),
    "stablelm-12b": (4, 2048, 32, 8, 160, None),
    "starcoder2-15b": (1, 8192, 48, 4, 128, 4096),
    "gemma3-12b-local": (2, 4096, 16, 8, 256, 1024),
    "gemma3-12b-global": (2, 4096, 16, 8, 256, None),
}
# ... and K5 at the new head dims on short, ragged S (the kernel's edges)
K5_WIDE_EDGES = (
    ("hd160_bf16", (2, 300, 4, 2, 160), "bfloat16", True, None),
    ("hd160_bf16_w30", (2, 100, 4, 4, 160), "bfloat16", True, 30),
    ("hd256_bf16", (2, 300, 4, 2, 256), "bfloat16", True, None),
    ("hd256_bf16_noncausal", (1, 200, 6, 2, 256), "bfloat16", False, None),
    ("hd160_f32", (2, 300, 4, 2, 160), "float32", True, None),
    ("hd256_f32_w100", (2, 300, 4, 2, 256), "float32", True, 100))
# K1 at olmoe's prefill (B=4 x 2048 tokens, top-8 of 64: capacity 1280)
# and decode shapes
K1_OLMOE_SHAPES = {"prefill": 1280, "decode": 8}
# K1's calibration probe (phase 45, the reference's probe shape)
K1_PROBE = (1, 512, 256, 1024)
# phase 51: card against CPU on one full-width layer period a arch
ARCH_PARITY = dict(B=1, S=256, gen=8)
# its logits gate: the serve gate of 3e-2 sits under one bf16 ulp of a
# logit in [4, 8) (3.125e-2), and the logits are bf16 products rounded
# on each side, so the gate is set just over that ulp (flat: two ulps of
# a logit of 71.5 would be 0.5)
ARCH_PARITY_TOL = 3.2e-2
# ... and the decode cache phases 50 and 51 build from the prefill's K / V
# (``_cache_from_prefill``) against the one the launcher's step feed
# builds: gemma3 cut to a local layer whose ring (64) the prompt wraps
# and a global one, f32 compute, the same sums in another order
CACHE_CHECK = dict(B=2, S=200, window_pattern=(64, None))
CACHE_CHECK_TOL = 1e-4
# ... and gemma3's two layer kinds, one each, at a prompt over 2048 (the
# CPU's streaming path against K5)
ARCH_PARITY_LONG = dict(B=1, S=3072, window_pattern=(1024, None))
# phase 52: olmoe served expert-parallel over 4 virtual ranks, 4 layers
OLMOE_EP_SERVE_ARGS = ["--arch", "olmoe-1b-7b", "--num-layers", "4",
                       "--batch", "4", "--prompt-len", "128", "--gen", "16",
                       "--prefill", "batch", "--device", "cuda", "--seed",
                       "0"]
# phase 53: olmoe's LUFFY train step at full width, 4 layers
OLMOE_TRAIN_ARGS = ["--arch", "olmoe-1b-7b", "--num-layers", "4", "--steps",
                    "3", "--global-batch", "4", "--seq-len", "1024",
                    "--optimizer", "adamw", "--device", "cuda", "--seed",
                    "0"]


def _ref_by_kv_group(q, k, v, causal, window):
    """ref.flash_attention_ref one KV head group at a time: the plain
    version of each group's heads (its [B,H,S,S] logits at S 8192 would
    not fit at once)."""
    import torch
    from repro_torch.kernels import ref
    g = q.shape[2] // k.shape[2]
    return torch.cat([ref.flash_attention_ref(
        q[:, :, i * g:(i + 1) * g], k[:, :, i:i + 1], v[:, :, i:i + 1],
        causal=causal, window=window) for i in range(k.shape[2])], 2)


def _k5_check(q, k, v, causal, window):
    """K5 launched twice on q, k, v against its plain version one KV
    group at a time: ``_k5_gate``'s fields and ``repeat_bitwise``."""
    import torch
    from repro_torch.kernels import flash_attn as kfa
    got = kfa.flash_attention(q, k, v, causal=causal, window=window)
    again = kfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = _ref_by_kv_group(q, k, v, causal, window)
    return dict(**_k5_gate(got, want), repeat_bitwise=torch.equal(got, again))


def _sdpa_or_none(q, k, v, causal, window):
    """The SDPA yardstick's call, or None with the reason where SDPA takes
    no such call (it is a yardstick, not a gate)."""
    return _yardstick(lambda: _sdpa_band(q, k, v, causal, window))


def phase_arch_kernels():
    """Phase 49: K5 at the five archs' prefill shapes and at hd 160 / 256
    on short ragged S, against its plain version (2e-5 f32, 3e-2 bf16
    elementwise, and each query row within ``K5_ROW_TOL``),
    a second launch bit for bit; timed (CUDA events and profiler device
    time) beside the plain version, SDPA with the same band and the
    bound (4 x hd FLOPs a live (q, k) pair at the bf16 tensor-core rate,
    or the bytes). Then K1 at olmoe's shapes (phase 3's checks and
    timings, silu) and at the calibration probe's shape beside a bf16
    bmm. Returns {"k5": {name: record}, "k5_edges": [...], "k1": ...}."""
    import torch
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import flash_attn as kfa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(49)

    def qkv(B, S, H, KV, hd, dt):
        return [torch.randn(s, generator=gen, device="cuda").to(dt)
                for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]

    edges = []
    for name, shape, dt, causal, window in K5_WIDE_EDGES:
        B, S, H, KV, hd = shape
        q, k, v = qkv(B, S, H, KV, hd, getattr(torch, dt))
        c = dict(case=name, shape=shape, dtype=dt, causal=causal,
                 window=window, route=kfa.route(q.dtype, hd),
                 **_k5_check(q, k, v, causal, window))
        edges.append(c)
        log(f"  K5 {name:22s} {shape} ({c['route']}): max|err|="
            f"{c['max_abs_err']:.3e} tol={c['tol']:g}, row "
            f"{c['max_row_rel_err']:.2e} tol {c['row_tol']:g}; repeat bitwise "
            f"{c['repeat_bitwise']} {'ok' if c['ok'] else 'FAIL'}")
    out = {}
    for name, (B, S, H, KV, hd, window) in K5_ARCH_SHAPES.items():
        q, k, v = qkv(B, S, H, KV, hd, torch.bfloat16)
        c = _k5_check(q, k, v, True, window)

        def run():
            return kfa.flash_attention(q, k, v, causal=True, window=window)

        lib, lib_err = _sdpa_or_none(q, k, v, True, window)
        ms, lib_ms = [], []
        for _ in range(2):          # in turns, as in one call
            ms.append(time_ms(run, 20, 3))
            if lib is not None:
                lib_ms.append(time_ms(lib, 10, 2))
        dev_ms = device_ms(run, 10)
        plain_ms = time_ms(lambda: _ref_by_kv_group(q, k, v, True, window),
                           2, 1)
        pairs = B * H * _band_pairs(S, True, window)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        rec = dict(shape=(B, S, H, KV, hd), window=window, causal=True,
                   route=kfa.route(q.dtype, hd), ms=min(ms), ms_runs=ms,
                   device_ms=dev_ms, plain_ms=plain_ms,
                   plain="ref.flash_attention_ref, one KV head group at a "
                         "time",
                   library_ms=min(lib_ms) if lib_ms else None,
                   library_ms_runs=lib_ms, library_error=lib_err,
                   live_pairs=pairs, **c,
                   **_bound(nbytes, pairs * 4.0 * hd, BF16_TC_FLOPS))
        rec["tflops_live"] = rec["flops"] / rec["ms"] / 1e9
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        out[name] = rec
        log(f"  K5 {name:18s} [{B},{S},{H},{hd}] bf16, {KV} KV heads, "
            f"window {window} ({rec['route']}): max|err|="
            f"{c['max_abs_err']:.3e}, row {c['max_row_rel_err']:.2e} "
            f"{'ok' if c['ok'] else 'FAIL'}, repeat "
            f"bitwise {c['repeat_bitwise']}; kernel {rec['ms']:.4f} ms (runs "
            f"{ms}; device {dev_ms:.4f}), plain {plain_ms:.2f} ms, SDPA "
            + (f"{rec['library_ms']:.4f} ms" if lib_ms else
               f"none ({lib_err})")
            + f"; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({100 * rec['bound_share']:.1f}% of it, "
            f"{rec['tflops_live']:.1f} TFLOP/s on live pairs)")
        del q, k, v, lib
        torch.cuda.empty_cache()
    bad = [c for c in edges + list(out.values())
           if not (c["ok"] and c["repeat_bitwise"])]
    if bad:
        raise SystemExit(f"K5 disagrees with its plain version: {bad}")
    log("  K1 at olmoe-1b-7b's widths (64 experts, d 2048, F 1024):")
    k1_checks, k1_timed = phase_kernels("olmoe-1b-7b", K1_OLMOE_SHAPES,
                                        act="silu")
    E_, R, D_, Fw = K1_PROBE
    h = torch.randn((E_, R, D_), generator=gen,
                    device="cuda").to(torch.bfloat16)
    ws = [torch.randn(s, generator=gen, device="cuda") / math.sqrt(s[1])
          for s in ((E_, D_, Fw), (E_, D_, Fw), (E_, Fw, D_))]
    wb = [w.to(torch.bfloat16) for w in ws]
    kexp.expert_ffn(h, *ws, "silu")
    probe_ms, probe_lib_ms = [], []
    for _ in range(2):
        probe_ms.append(time_ms(lambda: kexp.expert_ffn(h, *ws, "silu"),
                                50))
        probe_lib_ms.append(time_ms(lambda: _k1_library_bf16(h, *wb, "silu"),
                                    50))
    probe = dict(shape=K1_PROBE, ms=min(probe_ms), ms_runs=probe_ms,
                 library_bf16_ms=min(probe_lib_ms),
                 library_bf16_ms_runs=probe_lib_ms)
    log(f"  K1 at the calibration probe's [1,512,256]x1024: kernel "
        f"{probe['ms']:.4f} ms (runs {probe_ms}), bf16 bmm "
        f"{probe['library_bf16_ms']:.4f} ms (runs {probe_lib_ms})")
    return {"k5": out, "k5_edges": edges, "k1_checks": k1_checks,
            "k1": k1_timed, "k1_probe": probe}


def _n_moe(cfg) -> int:
    return sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers)) \
        if cfg.uses_moe else 0


def _cache_from_prefill(model, kvs, B: int, S: int, s_max: int):
    """A decode cache holding the prompt: each layer's prefill K / V of
    the positions its buffer keeps (the last W of a window layer, at ring
    slot position % W), as the step feed would have left it."""
    import torch
    cache = model.new_cache(B, s_max)
    for g, (k, v) in zip(cache["layers"], kvs):
        W = g["k"].shape[1]
        lo = max(0, S - W)
        pos = torch.arange(lo, S, device=k.device)
        slot = pos % W
        g["k"][:, slot] = k[:, lo:S].to(g["k"].dtype)
        g["v"][:, slot] = v[:, lo:S].to(g["v"].dtype)
        g["cpos"][:, slot] = pos.to(g["cpos"].dtype)
    cache["pos"] = S
    return cache


def _check_cache_builder(device="cuda"):
    """``_cache_from_prefill`` against the cache the launcher builds, an
    empty ``new_cache`` fed the prompt one token a step: gemma3 at full
    width cut to ``CACHE_CHECK``'s two layers (a ring the prompt wraps
    three times, a full buffer), f32 compute. ``cpos``, ``offset`` and
    ``pos`` equal, each layer's ``k`` and ``v`` within
    ``CACHE_CHECK_TOL`` of the norm, and so the next step's logits
    from either cache. Raises where they differ; returns the errors."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    g = get_config("gemma3-12b")
    cfg = dataclasses.replace(g, num_layers=2, compute_dtype="float32",
                              attn=dataclasses.replace(
                                  g.attn, window_pattern=CACHE_CHECK[
                                      "window_pattern"]))
    B, S = CACHE_CHECK["B"], CACHE_CHECK["S"]
    s_max = S + 1
    model = build_model(cfg, device=device, seed=50)
    toks = torch.as_tensor(np.random.default_rng(50).integers(
        1, cfg.vocab_size, (B, S + 1)), dtype=torch.int32, device=device)
    _, kvs = model.prefill(toks[:, :S], s_max, luffy=luffy)
    built = _cache_from_prefill(model, kvs, B, S, s_max)
    fed = model.new_cache(B, s_max)
    for t in range(S):
        _, fed = model.decode_step(fed, toks[:, t:t + 1], luffy=luffy)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    layout = built["pos"] == fed["pos"] and torch.equal(
        built["offset"], fed["offset"]) and all(
        torch.equal(x["cpos"], y["cpos"]) for x, y in
        zip(built["layers"], fed["layers"]))
    errs = {f"layer{i}_{key}": rel(x[key], y[key]) for i, (x, y) in
            enumerate(zip(built["layers"], fed["layers"]))
            for key in ("k", "v")}
    nxt = toks[:, S:S + 1]
    errs["next_logits"] = rel(model.decode_step(built, nxt, luffy=luffy)[0],
                              model.decode_step(fed, nxt, luffy=luffy)[0])
    info = dict(layout_equal=layout, ring=[x["k"].shape[1] for x in
                                           built["layers"]], prompt=S,
                rel_err=errs, tol=CACHE_CHECK_TOL)
    log("cache from the prefill against the step feed: " + json.dumps(info))
    del model, built, fed, kvs
    if device == "cuda":
        _free_card()
    if not (layout and max(errs.values()) <= CACHE_CHECK_TOL):
        raise SystemExit(f"the prefill's cache differs from the step "
                         f"feed's: {info}")
    return info


def _greedy(model, cache, logits, n: int, luffy):
    """n greedy decode steps from ``logits``; returns (tokens [B, n],
    the logits of each step)."""
    import torch
    toks, lgs = [], []
    for _ in range(n):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks.append(nxt[:, 0])
        logits, cache = model.decode_step(cache, nxt, luffy=luffy)
        lgs.append(logits)
    return torch.stack(toks, 1), lgs


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def phase_arch_serve():
    """Phase 50: each of the five archs at full width (ARCH_SERVE's depth)
    on the card, random weights from seed 0, bf16 compute: the batched
    prefill of B x S twice (a warm-up and a timed one) with every kernel
    counter set to 0 just before and read just after (K5 once a layer a
    prefill, olmoe's K1 once a MoE sublayer, nothing else), then 32
    greedy tokens from the cache the prefill's K / V fill (K1 once a MoE
    sublayer a step, no K5): finite logits, prefill tokens/s, decode
    ms/step, peak memory. Then the launcher, ``repro_torch.launch.serve
    --num-layers``, on a one-period cut of each (prompt 64, 4 tokens),
    with exact launch counts. Each model is freed before the next."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pattern_period
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    counters = _kernel_counters()
    out = {}
    for arch, sh in ARCH_SERVE.items():
        B, S, L = sh["B"], sh["S"], sh["layers"]
        cfg = dataclasses.replace(get_config(arch), num_layers=L)
        held = _free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights = torch.cuda.memory_allocated() - held
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (B, S)), dtype=torch.int32, device="cuda")
        s_max = S + ARCH_GEN
        for fn in counters.values():
            fn.launches = 0
        model.prefill(toks, s_max, luffy=luffy)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kvs = model.prefill(toks, s_max, luffy=luffy)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        n_moe = _n_moe(cfg)
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = 2 * L
        want["expert_ffn"] = 2 * n_moe
        cache = _cache_from_prefill(model, kvs, B, S, s_max)
        del kvs
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, lgs = _greedy(model, cache, logits, ARCH_GEN, luffy)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec_launches = {k: fn.launches for k, fn in counters.items()}
        dec_want = dict.fromkeys(dec_launches, 0)
        dec_want["expert_ffn"] = n_moe * ARCH_GEN
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(t).all()) for t in lgs)
        info = dict(arch=arch, layers=L, full_depth=get_config(arch)
                    .num_layers, batch=B, prompt_len=S, gen=ARCH_GEN,
                    init_s=init_s, weight_bytes=weights,
                    prefill_s=prefill_s, prefill_tok_s=B * S / prefill_s,
                    decode_ms_per_step=decode_s / ARCH_GEN * 1e3,
                    peak_mem_bytes=torch.cuda.max_memory_allocated(),
                    launches=launches, launches_expected=want,
                    decode_launches=dec_launches,
                    decode_launches_expected=dec_want, finite=finite,
                    logits_max_abs=logits.abs().max().item(),
                    sample_tokens=tokens[0, :8].tolist())
        log("arch serve: " + json.dumps(info))
        del model, cache, logits, lgs, toks
        _free_card()
        if not finite:
            raise SystemExit(f"{arch}: logits not finite")
        if launches != want or dec_launches != dec_want:
            raise SystemExit(f"{arch}: launches {launches} / decode "
                             f"{dec_launches} differ from what the path "
                             f"calls, {want} / {dec_want}")
        out[arch] = info
    # the launcher at a cut of one layer period (two layers where the
    # period is one), prompt 64 and 4 greedy tokens
    for arch in ARCH_SERVE:
        cfg = get_config(arch)
        L = max(2, pattern_period(cfg))
        for fn in counters.values():
            fn.launches = 0
        res = serve.main(["--arch", arch, "--num-layers", str(L), "--batch",
                          "2", "--prompt-len", "64", "--gen", "4",
                          "--prefill", "batch", "--device", "cuda", "--seed",
                          "0"])
        launches = {k: fn.launches for k, fn in counters.items()}
        n_moe = _n_moe(dataclasses.replace(cfg, num_layers=L))
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = L * serve.N_BATCHED_PREFILLS
        want["expert_ffn"] = n_moe * (serve.N_BATCHED_PREFILLS + 64 + 4)
        finite = all(bool(torch.isfinite(t).all()) for t in
                     [res["prefill_logits"]] + res["gen_logits"])
        out[arch]["launcher"] = dict(layers=L, launches=launches,
                                     launches_expected=want, finite=finite,
                                     prefill_tok_s=res["prefill_tok_s"])
        log(f"arch serve launcher {arch} --num-layers {L}: "
            + json.dumps(out[arch]["launcher"]))
        del res
        _free_card()
        if launches != want or not finite:
            raise SystemExit(f"{arch} launcher: launches {launches} (want "
                             f"{want}), finite {finite}")
    return out


def _parity_one(cfg, B: int, S: int, gen_n: int, seed: int,
                prefix_len: int = 0):
    """One full-width cut on the card, then the same parameters on the
    CPU: prefill logits (after ``prefix_len`` random prefix slots when
    given), and ``gen_n`` greedy tokens from the cache the prefill fills,
    each side decoding its own tokens. Returns the comparison."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    r = np.random.default_rng(seed)
    toks = torch.as_tensor(r.integers(1, cfg.vocab_size, (B, S)),
                           dtype=torch.int32)
    prefix = None
    if prefix_len:
        prefix = torch.as_tensor(r.standard_normal(
            (B, prefix_len, cfg.prefix_dim or cfg.d_model)),
            dtype=torch.float32)
    model = build_model(cfg, device="cuda", seed=seed)
    n = prefix_len + S
    s_max = n + gen_n
    res = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            model.to("cpu")         # the same parameters, moved
        t0 = time.perf_counter()
        k5 = kfa.flash_attention.launches
        lg, kvs = model.prefill(toks.to(dev), s_max, luffy=luffy,
                                prefix=None if prefix is None
                                else prefix.to(dev))
        k5 = kfa.flash_attention.launches - k5
        cache = _cache_from_prefill(model, kvs, B, n, s_max)
        tokens, lgs = _greedy(model, cache, lg, gen_n, luffy)
        res[dev] = dict(prefill=lg.float().cpu(), tokens=tokens.cpu(),
                        gen=[t.float().cpu() for t in lgs], k5=k5,
                        s=time.perf_counter() - t0)
        del kvs, cache
    del model
    _free_card()
    a, b = res["cuda"], res["cpu"]
    same = torch.equal(a["tokens"], b["tokens"])
    d = (a["prefill"] - b["prefill"]).abs()
    return dict(prefill_max_abs=d.max().item(),
                prefill_over_3e2=int((d > PARITY_TOL).sum()),
                prefill_ok=bool((d <= ARCH_PARITY_TOL).all()),
                logits_max_abs=b["prefill"].abs().max().item(),
                tokens_equal=same,
                gen_max_abs=max((x - y).abs().max().item() for x, y in
                                zip(a["gen"], b["gen"])) if same else None,
                k5_launches_card=a["k5"], k5_launches_cpu=b["k5"],
                card_s=a["s"], cpu_s=b["s"])


def phase_arch_parity():
    """Phase 51: each arch's full-width cut of one layer period (gemma3:
    6 layers; the others 2), bf16 compute, prompt 256, 8 greedy tokens:
    the card (K5, K1) against the CPU (attend, the plain versions): the
    prefill's logits within ``ARCH_PARITY_TOL`` (one bf16 ulp of a logit
    in [4, 8) and a little more), the greedy tokens equal, K5 once a
    layer on the card and never on the CPU. Then gemma3's two layer
    kinds (a local and a global layer) at a prompt of 3072, where the
    CPU attends through its streaming path. First, the decode cache both
    sides build from the prefill against the launcher's step-fed one
    (``_check_cache_builder``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import pattern_period
    out = {"cache_builder": _check_cache_builder()}
    P = ARCH_PARITY
    cases = [(arch, dataclasses.replace(
        get_config(arch), num_layers=max(2, pattern_period(get_config(arch)))),
        P["S"]) for arch in ARCH_SERVE]
    g = get_config("gemma3-12b")
    cases.append(("gemma3-12b@3072", dataclasses.replace(
        g, num_layers=2, attn=dataclasses.replace(
            g.attn, window_pattern=ARCH_PARITY_LONG["window_pattern"])),
        ARCH_PARITY_LONG["S"]))
    for name, cfg, S in cases:
        r = _parity_one(cfg, P["B"], S, P["gen"], seed=51)
        r.update(layers=cfg.num_layers, prompt_len=S)
        out[name] = r
        log(f"arch parity {name}: " + json.dumps(r))
        if not (r["prefill_ok"] and r["tokens_equal"]
                and r["k5_launches_card"] == cfg.num_layers
                and r["k5_launches_cpu"] == 0):
            raise SystemExit(f"{name}: card against CPU {r} (tol "
                             f"{ARCH_PARITY_TOL})")
    return out


def phase_olmoe_ep_serve():
    """Phase 52: olmoe cut to 4 layers served through the launcher on one
    device and over 4 virtual ranks (``--model-axis 4``, 16 experts a
    rank, the prefill sequence-sharded): exact launches (K5 once a layer
    a prefill, K1 once a MoE sublayer a prefill and a step), and the
    decode's logits and tokens bit for bit M = 1's."""
    import torch
    from repro_torch.launch import serve
    counters = _kernel_counters()
    L = int(OLMOE_EP_SERVE_ARGS[OLMOE_EP_SERVE_ARGS.index("--num-layers")
                                + 1])
    runs = {}
    for m in (1, 4):
        for fn in counters.values():
            fn.launches = 0
        res = serve.main(OLMOE_EP_SERVE_ARGS + ["--model-axis", str(m)])
        launches = {k: fn.launches for k, fn in counters.items()}
        B, S, G = res["batch"], res["prompt_len"], res["gen"]
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = L * serve.N_BATCHED_PREFILLS
        want["expert_ffn"] = L * (serve.N_BATCHED_PREFILLS + S + G)
        runs[m] = dict(launches=launches, want=want,
                       step=torch.stack(res["step_logits"]).cpu(),
                       gen=torch.stack(res["gen_logits"]).cpu(),
                       tokens=res["tokens"], prefill_tok_s=res[
                           "prefill_tok_s"],
                       decode_ms_per_step=res["decode_ms_per_step"],
                       finite=bool(torch.isfinite(res["prefill_logits"])
                                   .all()))
        del res
        _free_card()
    one, ep = runs[1], runs[4]
    bitwise = bool(torch.equal(ep["tokens"], one["tokens"])
                   and torch.equal(ep["step"], one["step"])
                   and torch.equal(ep["gen"], one["gen"]))
    info = {f"m{m}": {k: r[k] for k in ("launches", "prefill_tok_s",
                                        "decode_ms_per_step", "finite")}
            for m, r in runs.items()}
    info["decode_bitwise_m1"] = bitwise
    log("olmoe EP serve: " + json.dumps(info))
    for m, r in runs.items():
        if r["launches"] != r["want"] or not r["finite"]:
            raise SystemExit(f"olmoe serve M={m}: launches {r['launches']} "
                             f"(want {r['want']}), finite {r['finite']}")
    if not bitwise:
        raise SystemExit("olmoe EP decode is not M = 1's bit for bit")
    return info


def phase_olmoe_train():
    """Phase 53: olmoe-1b-7b at full width cut to 4 layers, trained
    through ``repro_torch.launch.train`` (B=4, S=1024, condensation on,
    AdamW, 3 steps): finite losses, K1, K1's backward, K2 (every launch
    through its fused entry), K3 and K3's backward launched exactly as
    the path calls them, step ms and peak memory; a second run from the
    same seed bit for bit."""
    import statistics
    res, launches, _, _ = _ep_run(OLMOE_TRAIN_ARGS)
    cfg, steps = res["cfg"], res["steps"]
    n_moe = _n_moe(cfg)
    fwd = n_moe * (2 if cfg.remat else 1) * len(steps)     # + recompute
    want = dict.fromkeys(launches, 0)
    want.update(expert_ffn=fwd, expert_ffn_bwd=n_moe * len(steps),
                masked_similarity=fwd, masked_similarity_fused=fwd,
                gather_rows=fwd, gather_rows_bwd=n_moe * len(steps))
    info = dict(arch=res["arch"], layers=cfg.num_layers,
                global_batch=res["global_batch"], seq_len=res["seq_len"],
                losses=[st["loss"] for st in steps],
                condense_rates=[st["condense_rate"] for st in steps],
                capacity=[st["capacity"] for st in steps],
                step_ms=[st["step_ms"] for st in steps],
                median_step_ms_after_0=statistics.median(
                    st["step_ms"] for st in steps[1:]),
                peak_mem_bytes=max(st["peak_mem_bytes"] for st in steps),
                launches=launches, launches_expected=want)
    log("olmoe train: " + json.dumps(info))
    del res, steps
    _free_card()
    if not all(math.isfinite(x) for x in info["losses"]):
        raise SystemExit(f"olmoe losses not finite: {info['losses']}")
    if launches != want:
        raise SystemExit(f"olmoe train launches {launches} differ from what "
                         f"the path calls, {want}")
    again = _ep_run(OLMOE_TRAIN_ARGS)[0]["steps"]
    same = {k: [st[k] for st in again] == info[key]
            for k, key in (("loss", "losses"),
                           ("condense_rate", "condense_rates"))}
    info["repeat_bitwise"] = same
    log(f"olmoe train repeat, same seed: bit-equal {same}")
    _free_card()
    if not all(same.values()):
        raise SystemExit(f"the olmoe train run does not repeat: {same}")
    return info


def run_arch_phases():
    """Phases 49-53 in order."""
    return {"kernels": phase_arch_kernels(), "serve": phase_arch_serve(),
            "parity": phase_arch_parity(), "ep": phase_olmoe_ep_serve(),
            "train": phase_olmoe_train()}


# slice 18: llama4-maverick (item 8.2: the shared expert, chunked-local
# attention) and internvl2-2b (item 8.4's prefix arch) at full width.
# llama4's 48 layers of bf16 weights take 1.6e12 B, so phase 57 serves a
# chunked-local pair (2 layers, 69.3e9 B with the embedding and the
# untied head) at a prompt of 16384, where the chunk of 8192 bites;
# internvl2 at full depth, B=4 x (256 prefix slots + 1792 tokens).
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_SERVE = dict(layers=2, B=1, S=16384)
INTERNVL2 = "internvl2-2b"
INTERNVL2_SERVE = dict(B=4, P=256, S=1792)
# ... and internvl2's text path through the launcher (no prefix) at
# B=4 x 2048, cut to 2 layers: the launcher feeds the prompt a token a
# step, 2048 steps at 1.5-4.5 ms a layer each (item 8.1's decoders)
INTERNVL2_LAUNCHER_ARGS = ["--arch", INTERNVL2, "--num-layers", "2",
                           "--batch", "4", "--prompt-len", "2048", "--gen",
                           "4", "--prefill", "batch", "--device", "cuda",
                           "--seed", "0"]
# phase 56: K1 at llama4's prefill (B=1 x 16384 tokens, top-1 of 128 at
# capacity factor 1.5: 192 rows an expert) and decode (8) shapes, bf16 h
# and bf16 weights; K5 folded for a chunked layer (B, S, H, KV, hd,
# chunk) at 16384 and at one chunk plus a tail of 1000; K5 at
# internvl2's prefill (B, S, H, KV, hd)
K1_LLAMA4_SHAPES = {"prefill": 192, "decode": 8}
K5_CHUNKED_SHAPES = {
    "llama4-chunked-16384": (1, 16384, 40, 8, 128, 8192),
    "llama4-chunked-9192": (1, 9192, 40, 8, 128, 8192),
}
K5_INTERNVL2_SHAPE = (4, 2048, 16, 8, 128)
# phase 58: card against CPU: reduced llama4 over one period (chunk 64 at
# a sequence hint of 128) at prompts of 256 (four whole chunks) and 200
# (three and a tail), and internvl2 at full width cut to 2 layers with a
# 256-slot prefix before a prompt of 256. Reduced llama4 is held at f32
# compute (K5 and K1 on their f32 kernels) to the f32 serve tolerance:
# at bf16 two correct attention cores on the CPU alone (``attend`` and
# K5's plain version, folded) move its logits by up to 0.055, over the
# bf16 gate, so its bf16 run is recorded beside, not gated
LLAMA4_PARITY = dict(B=2, S=(256, 200), gen=8)
LLAMA4_PARITY_TOL = 1e-4
INTERNVL2_PARITY = dict(layers=2, B=1, P=256, S=256, gen=8)
# phase 59: llama4 at full width, 1 layer, served over 4 virtual ranks
# (32 experts a rank) through the launcher, whose prompt feed takes one
# ~17 ms step a token (every expert's weights read): a prompt of 256
# keeps its three runs within ~25 s of the script's limit
LLAMA4_EP_SERVE_ARGS = ["--arch", LLAMA4, "--num-layers", "1", "--batch",
                        "4", "--prompt-len", "256", "--gen", "4",
                        "--prefill", "batch", "--device", "cuda", "--seed",
                        "0"]


def _k5_launches(cfg, S: int) -> int:
    """K5 launches of one batched prefill of S positions: one a layer,
    two for a chunked-local layer whose chunks leave a ragged tail."""
    a = cfg.attn
    n = 0
    for i in range(cfg.num_layers):
        w = a.window_for_layer(i)
        n += 2 if a.chunked_local and w is not None and S > w and S % w \
            else 1
    return n


def _k1_plain_by_expert(h, wu, wg, wd, act):
    """K1's plain version one expert at a time (the whole stack cast to
    f32 at once would take 64e9 B)."""
    import torch
    from repro_torch.kernels import ref
    return torch.cat([ref.expert_ffn_ref(h[e:e + 1], wu[e:e + 1],
                                         wg[e:e + 1], wd[e:e + 1], act)
                      for e in range(h.shape[0])])


def _chunked_plain(q, k, v, W: int):
    """The chunked-local function's plain version: each block of W
    positions causal on its own (``q // W == k // W``), one KV head group
    at a time."""
    import torch
    return torch.cat([_ref_by_kv_group(q[:, c:c + W], k[:, c:c + W],
                                       v[:, c:c + W], True, None)
                      for c in range(0, q.shape[1], W)], 1)


def _yardstick(make):
    """A yardstick's call, or None with the reason where PyTorch takes no
    such call."""
    try:
        fn = make()
        fn()
        return fn, None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:120]


def _timed(run, lib, plain, iters: int):
    """Kernel and yardstick in turns (CUDA events, the least of two),
    the kernel's profiler device time, the plain version once."""
    ms, lib_ms = [], []
    for _ in range(2):
        ms.append(time_ms(run, iters, 2))
        if lib is not None:
            lib_ms.append(time_ms(lib, iters, 2))
    return dict(ms=min(ms), ms_runs=ms, device_ms=device_ms(run, iters),
                plain_ms=time_ms(plain, 1, 0),
                library_ms=min(lib_ms) if lib_ms else None,
                library_ms_runs=lib_ms)


def phase_llama4_kernels():
    """Phase 56: the kernels at slice 18's shapes. K1 on one llama4 MoE
    layer's bf16 expert stack as ``moe_init`` draws it (3 x 5.37e9
    elements) at the prefill's 192 rows an expert and a decode step's 8,
    bf16 h, silu: against its plain version one expert at a time (5e-2),
    a second launch bit for bit, no weight cast; timed beside a bf16 bmm
    on the same tensors and the bound (the bytes: every expert's weights
    are read, also at decode, where at most 4 hold a row). K5 folded for a
    chunked-local layer (``models/blocks.py::flash_chunked``) at S 16384
    (one launch) and 9192 (two: a tail of 1000), and unfolded at
    internvl2's prefill shape: against the plain version of the layer's
    function (3e-2 elementwise and 1e-2 of each query row's norm), a
    second call bit for bit; timed beside SDPA with the same mask and the
    bound (4 x hd FLOPs a live pair at the bf16 tensor-core rate). The
    kernels are unchanged, so phase 2's spill check covers them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import moe_init
    from repro_torch.kernels import expert_ffn as kexp
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.models import blocks as bk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(56)
    cfg = dataclasses.replace(get_config(LLAMA4),
                              num_layers=LLAMA4_SERVE["layers"])
    E, D, Fw = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    ew = moe_init(gen, cfg, device="cuda")["experts"]
    ws = (ew["w_up"], ew["w_gate"], ew["w_down"])
    del ew
    k1 = {}
    for shape, R in K1_LLAMA4_SHAPES.items():
        h = torch.randn((E, R, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        casts = kexp.weight_bf16.casts
        got = kexp.expert_ffn(h, *ws, "silu")
        again = kexp.expert_ffn(h, *ws, "silu")
        torch.cuda.synchronize()
        want = _k1_plain_by_expert(h, *ws, "silu")
        tol = K1_TOL["bfloat16"]
        rec = dict(shape=(E, R, D, Fw), dtypes="bf16 h, bf16 weights",
                   route=kexp.route(h.dtype, ws[0].dtype, D, Fw),
                   max_abs_err=(got.float() - want.float()).abs().max()
                   .item(), tol=tol,
                   ok=bool(torch.allclose(got.float(), want.float(),
                                          atol=tol, rtol=tol)),
                   repeat_bitwise=bool(torch.equal(got, again)),
                   weight_casts=kexp.weight_bf16.casts - casts,
                   weight_elements=ws[0].numel())
        del got, again, want
        lib, lib_err = _yardstick(lambda: (
            lambda: _k1_library_bf16(h, *ws, "silu")))
        rec.update(_timed(lambda: kexp.expert_ffn(h, *ws, "silu"), lib,
                          lambda: _k1_plain_by_expert(h, *ws, "silu"),
                          10), library_error=lib_err)
        flops = 2.0 * E * R * D * Fw * 3
        rec.update(_bound(2 * h.numel() * 2 + sum(w.numel() * 2
                                                  for w in ws), flops,
                          BF16_TC_FLOPS))
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        k1[shape] = rec
        log(f"  K1 llama4 {shape:7s} [{E},{R},{D}]x{Fw} bf16 h and weights "
            f"({rec['route']}): max|err|={rec['max_abs_err']:.3e} tol "
            f"{tol:g} {'ok' if rec['ok'] else 'FAIL'}, repeat bitwise "
            f"{rec['repeat_bitwise']}, casts {rec['weight_casts']}; kernel "
            f"{rec['ms']:.4f} ms (runs {rec['ms_runs']}; device "
            f"{rec['device_ms']:.4f}), plain {rec['plain_ms']:.2f} ms, bmm "
            f"bf16 " + (f"{rec['library_ms']:.4f} ms" if lib else
                        f"none ({lib_err})")
            + f"; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({100 * rec['bound_share']:.1f}% of it)")
        del h, lib
        torch.cuda.empty_cache()
    del ws
    _free_card()

    def qkv(B, S, H, KV, hd):
        return [torch.randn(s, generator=gen, device="cuda")
                .to(torch.bfloat16)
                for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]

    k5 = {}
    cases = [(name, sh, sh[5]) for name, sh in K5_CHUNKED_SHAPES.items()]
    cases.append((INTERNVL2, K5_INTERNVL2_SHAPE + (None,), None))
    for name, (B, S, H, KV, hd, _), W in cases:
        q, k, v = qkv(B, S, H, KV, hd)
        scale = hd ** -0.5
        if W is None:
            def run():
                return kfa.flash_attention(q, k, v, causal=True)
            lens = [S]
            lib, lib_err = _sdpa_or_none(q, k, v, True, None)
        else:
            def run():
                return bk.flash_chunked(q, k, v, W, causal=True,
                                        scale=scale)
            lens = [min(W, S - c) for c in range(0, S, W)]
            lib, lib_err = _yardstick(
                lambda: _sdpa_band(q, k, v, True, W, chunked=True))
        before = kfa.flash_attention.launches
        got = run()
        launches = kfa.flash_attention.launches - before
        again = run()
        torch.cuda.synchronize()
        want = (_ref_by_kv_group(q, k, v, True, None) if W is None
                else _chunked_plain(q, k, v, W))
        rec = dict(shape=(B, S, H, KV, hd), chunk=W, causal=True,
                   route=kfa.route(q.dtype, hd), launches_per_call=launches,
                   **_k5_gate(got, want),
                   repeat_bitwise=bool(torch.equal(got, again)))
        del got, again, want
        rec.update(_timed(run, lib, (lambda: _ref_by_kv_group(
            q, k, v, True, None)) if W is None else (
            lambda: _chunked_plain(q, k, v, W)), 10),
            library_error=lib_err,
            library="F.scaled_dot_product_attention, same mask",
            plain="ref.flash_attention_ref, one KV head group (and chunk) "
                  "at a time")
        pairs = B * H * sum(n * (n + 1) // 2 for n in lens)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        rec.update(live_pairs=pairs, **_bound(nbytes, pairs * 4.0 * hd,
                                              BF16_TC_FLOPS))
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        k5[name] = rec
        log(f"  K5 {name:22s} [{B},{S},{H},{hd}] bf16, {KV} KV heads, chunk "
            f"{W} ({rec['route']}, {launches} launches): max|err|="
            f"{rec['max_abs_err']:.3e}, row {rec['max_row_rel_err']:.2e} "
            f"{'ok' if rec['ok'] else 'FAIL'}, repeat bitwise "
            f"{rec['repeat_bitwise']}; kernel {rec['ms']:.4f} ms (runs "
            f"{rec['ms_runs']}; device {rec['device_ms']:.4f}), plain "
            f"{rec['plain_ms']:.2f} ms, SDPA "
            + (f"{rec['library_ms']:.4f} ms" if lib else
               f"none ({lib_err})")
            + f"; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({100 * rec['bound_share']:.1f}% of it)")
        del q, k, v, lib
        torch.cuda.empty_cache()
    want_launches = {n: 1 for n in k5}
    want_launches["llama4-chunked-9192"] = 2
    bad = [dict(case=n, **{x: c[x] for x in ("ok", "repeat_bitwise")})
           for n, c in list(k1.items()) + list(k5.items())
           if not (c["ok"] and c["repeat_bitwise"])]
    bad += [dict(case=n, weight_casts=c["weight_casts"])
            for n, c in k1.items() if c["weight_casts"]]
    bad += [dict(case=n, launches=c["launches_per_call"])
            for n, c in k5.items()
            if c["launches_per_call"] != want_launches[n]]
    if bad:
        raise SystemExit(f"slice 18's kernels disagree with their plain "
                         f"versions or launch otherwise: {bad}")
    return {"k1": k1, "k5": k5}


def _serve_full(cfg, B: int, S: int, P: int = 0):
    """``cfg`` on the card, random weights from seed 0: two batched
    prefills of B x S tokens (after P random prefix slots) with every
    counter set to 0 just before and read just after, then ARCH_GEN
    greedy tokens from the cache the prefill's K / V fill. Returns what
    was measured; the model is freed."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    counters = _kernel_counters()
    held = _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - held
    r = np.random.default_rng(0)
    toks = torch.as_tensor(r.integers(1, cfg.vocab_size, (B, S)),
                           dtype=torch.int32, device="cuda")
    prefix = None
    if P:
        prefix = torch.as_tensor(r.standard_normal(
            (B, P, cfg.prefix_dim or cfg.d_model)), dtype=torch.float32,
            device="cuda")
    n = P + S
    s_max = n + ARCH_GEN
    for fn in counters.values():
        fn.launches = 0
    model.prefill(toks, s_max, luffy=luffy, prefix=prefix)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kvs = model.prefill(toks, s_max, luffy=luffy, prefix=prefix)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_moe = _n_moe(cfg)
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = 2 * _k5_launches(cfg, n)
    want["expert_ffn"] = 2 * n_moe
    cache = _cache_from_prefill(model, kvs, B, n, s_max)
    kv_len = kvs[0][0].shape[1]
    del kvs
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, lgs = _greedy(model, cache, logits, ARCH_GEN, luffy)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_launches = {k: fn.launches for k, fn in counters.items()}
    dec_want = dict.fromkeys(dec_launches, 0)
    dec_want["expert_ffn"] = n_moe * ARCH_GEN
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in lgs)
    info = dict(arch=cfg.name, layers=cfg.num_layers, batch=B,
                prefix_slots=P, prompt_len=S, kv_len=kv_len, gen=ARCH_GEN,
                init_s=init_s, weight_bytes=weights, prefill_s=prefill_s,
                prefill_tok_s=B * n / prefill_s,
                decode_ms_per_step=decode_s / ARCH_GEN * 1e3,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, launches_expected=want,
                decode_launches=dec_launches,
                decode_launches_expected=dec_want, finite=finite,
                logits_max_abs=logits.abs().max().item(),
                sample_tokens=tokens[0, :8].tolist())
    del model, cache, logits, lgs, toks, prefix
    _free_card()
    return info


def phase_llama4_serve():
    """Phase 57: llama4-maverick at full width cut to a chunked-local
    pair (B=1 x 16384: K5 once a layer a prefill, on the two chunks
    folded into the batch; K1 and the shared expert once a MoE sublayer a
    prefill and a step) and internvl2-2b at full width and depth (B=4 x
    256 prefix slots + 1792 tokens through ``prefill(prefix=)``: K5 once
    a layer), each as phase 50 serves: finite logits, exact launches,
    prefill tokens/s, decode ms/step, peak memory (llama4's under
    80e9 B). Then internvl2 through the launcher's text path (B=4 x
    2048, no prefix, cut to 2 layers: the launcher feeds the prompt a
    token a step) with exact launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    out = {}
    sh, iv = LLAMA4_SERVE, INTERNVL2_SERVE
    for name, cfg, B, S, P in (
            (LLAMA4, dataclasses.replace(get_config(LLAMA4),
                                         num_layers=sh["layers"]),
             sh["B"], sh["S"], 0),
            (INTERNVL2, get_config(INTERNVL2), iv["B"], iv["S"], iv["P"])):
        info = _serve_full(cfg, B, S, P)
        info["full_depth"] = get_config(name).num_layers
        out[name] = info
        log("slice 18 serve: " + json.dumps(info))
        if not info["finite"]:
            raise SystemExit(f"{name}: logits not finite")
        if info["launches"] != info["launches_expected"] or \
                info["decode_launches"] != info["decode_launches_expected"]:
            raise SystemExit(f"{name}: launches {info['launches']} / decode "
                             f"{info['decode_launches']} differ from what "
                             f"the path calls")
    if out[LLAMA4]["peak_mem_bytes"] >= 80e9:
        raise SystemExit(f"llama4 peaked at {out[LLAMA4]['peak_mem_bytes']} "
                         f"B, over 80e9")
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    res = serve.main(INTERNVL2_LAUNCHER_ARGS)
    launches = {k: fn.launches for k, fn in counters.items()}
    L = int(INTERNVL2_LAUNCHER_ARGS[INTERNVL2_LAUNCHER_ARGS.index(
        "--num-layers") + 1])
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = L * serve.N_BATCHED_PREFILLS
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [res["prefill_logits"]] + res["gen_logits"])
    out["launcher"] = dict(launches=launches, launches_expected=want,
                           finite=finite,
                           prefill_tok_s=res["prefill_tok_s"],
                           decode_ms_per_step=res["decode_ms_per_step"])
    log(f"slice 18 launcher {INTERNVL2}: " + json.dumps(out["launcher"]))
    del res
    _free_card()
    if launches != want or not finite:
        raise SystemExit(f"{INTERNVL2} launcher: launches {launches} (want "
                         f"{want}), finite {finite}")
    return out


def phase_llama4_parity():
    """Phase 58: card against CPU. Reduced llama4 over one full period
    (three chunked-local layers of chunk 64 and the global one) at
    prompts of 256 (the chunks folded, one K5 launch a layer) and 200
    (a ragged tail: two in each chunked layer), f32 compute: prefill
    logits within ``LLAMA4_PARITY_TOL``; the same at bf16 recorded.
    internvl2 at full width cut to 2 layers with a 256-slot prefix
    before 256 tokens, bf16: logits within ``ARCH_PARITY_TOL``. Each
    gated case: 8 greedy tokens equal, K5 as counted on the card and
    never on the CPU. Every case runs before any failure is raised."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    out, bad = {}, []
    lp, ip = LLAMA4_PARITY, INTERNVL2_PARITY
    red = reduced(get_config(LLAMA4), seq_len_hint=128)
    cases = [(f"{LLAMA4}-smoke@{S}-{cdt}",
              dataclasses.replace(red, compute_dtype=cdt), lp["B"], S,
              lp["gen"], 0, LLAMA4_PARITY_TOL if cdt == "float32" else None)
             for S in lp["S"] for cdt in ("float32", "bfloat16")]
    cases.append((f"{INTERNVL2}@{ip['layers']}", dataclasses.replace(
        get_config(INTERNVL2), num_layers=ip["layers"]), ip["B"], ip["S"],
        ip["gen"], ip["P"], ARCH_PARITY_TOL))
    for name, cfg, B, S, gen_n, P, tol in cases:
        r = _parity_one(cfg, B, S, gen_n, seed=58, prefix_len=P)
        r.update(layers=cfg.num_layers, prompt_len=S, prefix_slots=P,
                 compute_dtype=cfg.compute_dtype, tol=tol,
                 k5_launches_expected=_k5_launches(cfg, P + S))
        out[name] = r
        log(f"slice 18 parity {name}: " + json.dumps(r))
        if tol is not None and not (
                r["prefill_max_abs"] <= tol and r["tokens_equal"]
                and r["k5_launches_card"] == r["k5_launches_expected"]
                and r["k5_launches_cpu"] == 0):
            bad.append(name)
    if bad:
        raise SystemExit(f"card against CPU fails in {bad}: "
                         + json.dumps({n: out[n] for n in bad}))
    return out


def phase_llama4_ep_serve():
    """Phase 59: llama4 at full width cut to 1 layer through the launcher
    at M = 1, over 4 virtual ranks (32 experts a rank, the prefill
    sequence-sharded) and over 4 ranks under ``--exec-mode
    decode_overlap``: exact launches (K5 once a prefill, K1 once a
    prefill and a step), the decode's logits and tokens bit for bit
    M = 1's, and the decode_overlap run's tokens and logits (the
    prefill's too) bit for bit sync's."""
    import torch
    from repro_torch.launch import serve
    counters = _kernel_counters()
    L = int(LLAMA4_EP_SERVE_ARGS[LLAMA4_EP_SERVE_ARGS.index("--num-layers")
                                 + 1])
    runs = {}
    for label, extra in (("m1", ["--model-axis", "1"]),
                         ("m4", ["--model-axis", "4"]),
                         ("m4_overlap", ["--model-axis", "4", "--exec-mode",
                                         "decode_overlap"])):
        for fn in counters.values():
            fn.launches = 0
        res = serve.main(LLAMA4_EP_SERVE_ARGS + extra)
        launches = {k: fn.launches for k, fn in counters.items()}
        S, G = res["prompt_len"], res["gen"]
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = L * serve.N_BATCHED_PREFILLS
        want["expert_ffn"] = L * (serve.N_BATCHED_PREFILLS + S + G)
        runs[label] = dict(
            launches=launches, want=want,
            prefill=res["prefill_logits"].cpu(),
            step=torch.stack(res["step_logits"]).cpu(),
            gen=torch.stack(res["gen_logits"]).cpu(), tokens=res["tokens"],
            prefill_tok_s=res["prefill_tok_s"],
            decode_ms_per_step=res["decode_ms_per_step"],
            finite=bool(torch.isfinite(res["prefill_logits"]).all()))
        del res
        _free_card()

    def same(a, b, keys):
        return all(torch.equal(runs[a][k], runs[b][k]) for k in keys)

    info = {m: {k: r[k] for k in ("launches", "prefill_tok_s",
                                  "decode_ms_per_step", "finite")}
            for m, r in runs.items()}
    info["decode_bitwise_m1"] = same("m4", "m1", ("tokens", "step", "gen"))
    info["overlap_bitwise_sync"] = same("m4_overlap", "m4", (
        "tokens", "prefill", "step", "gen"))
    log("llama4 EP serve: " + json.dumps(info))
    for m, r in runs.items():
        if r["launches"] != r["want"] or not r["finite"]:
            raise SystemExit(f"llama4 serve {m}: launches {r['launches']} "
                             f"(want {r['want']}), finite {r['finite']}")
    if not (info["decode_bitwise_m1"] and info["overlap_bitwise_sync"]):
        raise SystemExit(f"llama4 EP decode: M = 4 bit for bit M = 1 "
                         f"{info['decode_bitwise_m1']}, decode_overlap bit "
                         f"for bit sync {info['overlap_bitwise_sync']}")
    return info


def run_llama4_phases():
    """Phases 56-59 in order."""
    return {"kernels": phase_llama4_kernels(), "serve": phase_llama4_serve(),
            "parity": phase_llama4_parity(), "ep": phase_llama4_ep_serve()}


def _llama4_records(l4):
    """K1 at llama4's prefill and decode shapes with bf16 weights and K5
    folded for its chunked layers (phase 56), with the launches of
    llama4's serve run (phase 57: two batched prefills, 32 steps), and
    K5 at internvl2's prefill with the launches of its serve run."""
    k1, k5, sv = l4["kernels"]["k1"], l4["kernels"]["k5"], l4["serve"]
    lsv = sv[LLAMA4]
    recs = []
    for shape, t in k1.items():
        launches = (lsv["launches"] if shape == "prefill"
                    else lsv["decode_launches"])["expert_ffn"]
        recs.append(_record(
            f"expert_ffn@llama4-{shape}",
            "src/repro_torch/csrc/expert_ffn.cu",
            "src/repro/kernels/expert_ffn.py:52", launches, t,
            {"kernel": "expert_ffn",
             "timed_at": f"{list(t['shape'])} (E, R, d, F), bf16 h, bf16 "
                         f"weights (one MoE layer's stack, "
                         f"{t['weight_elements']} elements a tensor), silu",
             "launches_path": f"{LLAMA4} serve at 2 layers, "
                              + ("2 batched prefills of 1 x 16384" if
                                 shape == "prefill" else
                                 f"{ARCH_GEN} decode steps"),
             "launches_ep_serve": l4["ep"]["m4"]["launches"]["expert_ffn"],
             "dispatch": t["route"], "device_ms": t["device_ms"],
             "library": "torch.bmm bf16 on the same tensors",
             "library_error": t["library_error"],
             "bound_share": t["bound_share"],
             "repeat_bitwise": t["repeat_bitwise"]}))
    for name, t in k5.items():
        arch = INTERNVL2 if name == INTERNVL2 else LLAMA4
        recs.append(_record(
            f"flash_attention@{name}", "src/repro_torch/csrc/flash_attn.cu",
            "src/repro/kernels/flash_attn.py:87",
            sv[arch]["launches"]["flash_attention"], t,
            {"kernel": "flash_attention",
             "timed_at": f"{list(t['shape'])} (B, S, H, KV, hd) bf16, "
                         f"causal, chunk {t['chunk']} ("
                         f"{t['launches_per_call']} launch(es) a call)",
             "launches_path": f"{arch} serve, 2 batched prefills",
             "dispatch": t["route"], "device_ms": t["device_ms"],
             "library": t["library"], "library_error": t["library_error"],
             "bound_share": t["bound_share"],
             "repeat_bitwise": t["repeat_bitwise"], "plain": t["plain"]}))
    return recs


SEAMLESS = "seamless-m4t-large-v2"
# phase 60: K5 at seamless's attention shapes (16 heads of 64, no GQA):
# (B, Sq, Sk, causal); the encoder's layers and the cross layers at
# enc_len = prompt = 2048 are the same function, the decoder's causal,
# and two ragged cross shapes (keys past the last full tile)
K5_SEAMLESS_SHAPES = {
    "encoder": (4, 2048, 2048, False),
    "decoder": (4, 2048, 2048, True),
    "cross": (4, 2048, 2048, False),
    "cross-1000": (4, 2048, 1000, False),
    "cross-100x3000": (2, 100, 3000, False),
}
K5_SEAMLESS_HEADS = (16, 16, 64)          # H, KV, hd
# phase 61: full width and depth (24 + 24 layers), enc_len = prompt
SEAMLESS_SERVE = dict(B=4, S=2048, S_enc=2048)
# ... and the launcher's path at a short prompt: the launcher feeds the
# prompt a token a step, as for every arch
SEAMLESS_LAUNCHER_ARGS = ["--arch", SEAMLESS, "--batch", "4",
                          "--prompt-len", "64", "--gen", "8", "--prefill",
                          "batch", "--device", "cuda", "--seed", "0"]
# phase 62: reduced seamless (2 + 2 layers, d 256) card against CPU at a
# prompt of 256 against 300 encoder frames (the cross layers at Sq != Sk
# on K5), f32 compute at the f32 serve tolerance; bf16 recorded
SEAMLESS_PARITY = dict(B=2, S=256, S_enc=300, gen=8)
SEAMLESS_PARITY_TOL = 1e-4


def _sdpa_plain(q, k, v, causal):
    """F.scaled_dot_product_attention at Sq x Sk, kv expanded, no mask or
    the causal one: the yardstick, never called by the port."""
    import torch.nn.functional as F
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)


def phase_seamless_kernels():
    """Phase 60: K5 at seamless-m4t-large-v2's attention shapes (16 heads
    of 64): the encoder's [4,2048] non-causal, the decoder's causal, the
    cross layers' [4, 2048 q, 2048 k] and two ragged cross shapes
    ([4, 2048 q, 1000 k], [2, 100 q, 3000 k]), each at bf16 (the
    tensor-core kernel) and f32 (the FMA kernel): against its plain
    version one KV head at a time (3e-2 / 2e-5 elementwise and 1e-2 /
    1e-4 of each query row's norm), a second launch bit for bit; timed
    (CUDA events in turns with SDPA, profiler device time) beside the
    plain version and the bound (4 x hd FLOPs a live (q, k) pair at the
    bf16 tensor-core rate, or the f32 rate for f32; or the bytes)."""
    import torch
    from repro_torch.kernels import flash_attn as kfa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(60)
    H, KV, hd = K5_SEAMLESS_HEADS
    out = {}
    for name, (B, Sq, Sk, causal) in K5_SEAMLESS_SHAPES.items():
        for dt in ("bfloat16", "float32"):
            t = getattr(torch, dt)
            q, k, v = [torch.randn(s, generator=gen, device="cuda").to(t)
                       for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                 (B, Sk, KV, hd))]

            def run():
                return kfa.flash_attention(q, k, v, causal=causal)

            got, again = run(), run()
            torch.cuda.synchronize()
            want = _ref_by_kv_group(q, k, v, causal, None)
            rec = dict(shape=(B, Sq, Sk, H, KV, hd), dtype=dt, causal=causal,
                       route=kfa.route(q.dtype, hd), **_k5_gate(got, want),
                       repeat_bitwise=bool(torch.equal(got, again)))
            del got, again, want
            lib, lib_err = _yardstick(lambda: _sdpa_plain(q, k, v, causal))
            rec.update(_timed(run, lib, lambda: _ref_by_kv_group(
                q, k, v, causal, None), 10), library_error=lib_err,
                library="F.scaled_dot_product_attention, same mask",
                plain="ref.flash_attention_ref, one KV head at a time")
            pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
            size = q.element_size()
            nbytes = size * (2 * q.numel() + k.numel() + v.numel())
            rec.update(live_pairs=pairs, **_bound(
                nbytes, pairs * 4.0 * hd,
                BF16_TC_FLOPS if dt == "bfloat16" else F32_FLOPS))
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            out[f"{name}-{dt}"] = rec
            log(f"  K5 seamless {name:15s} {dt:8s} [{B},{Sq}q,{Sk}k,{H},"
                f"{hd}] {'causal' if causal else 'non-causal'} "
                f"({rec['route']}): max|err|={rec['max_abs_err']:.3e}, row "
                f"{rec['max_row_rel_err']:.2e} "
                f"{'ok' if rec['ok'] else 'FAIL'}, repeat bitwise "
                f"{rec['repeat_bitwise']}; kernel {rec['ms']:.4f} ms (runs "
                f"{rec['ms_runs']}; device {rec['device_ms']:.4f}), plain "
                f"{rec['plain_ms']:.2f} ms, SDPA "
                + (f"{rec['library_ms']:.4f} ms" if lib else
                   f"none ({lib_err})")
                + f"; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                f"({100 * rec['bound_share']:.1f}% of it)")
            del q, k, v, lib
            torch.cuda.empty_cache()
    bad = [dict(case=n, **{x: c[x] for x in ("ok", "repeat_bitwise",
                                              "max_abs_err",
                                              "max_row_rel_err")})
           for n, c in out.items() if not (c["ok"] and c["repeat_bitwise"])]
    if bad:
        raise SystemExit(f"K5 at seamless's shapes disagrees with its plain "
                         f"version: {bad}")
    return out


def _k5_tally():
    """Route ``ops.flash_attention``'s calls of the K5 wrapper through a
    function that also tallies each by its mask and shape (the wrapper
    and its own counter are left as they are); returns (tally, undo)."""
    import types
    from repro_torch.kernels import ops
    module = ops._flash_attn
    tally = {"causal": 0, "noncausal": 0, "noncausal_sq_ne_sk": 0}

    def counted(q, k, v, *, causal=True, window=None, scale=None):
        key = "causal" if causal else (
            "noncausal" if q.shape[1] == k.shape[1] else "noncausal_sq_ne_sk")
        tally[key] += 1
        return module.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)

    ops._flash_attn = types.SimpleNamespace(flash_attention=counted)

    def undo():
        ops._flash_attn = module
    return tally, undo


def _encdec_cache(model, kvs, B: int, S: int, s_max: int):
    """The decode cache of an encoder-decoder's prefill: each layer's self
    K/V at positions 0..S-1 (full buffers) and its cross K/V."""
    import torch
    from repro_torch.serve.engine import write_cross_kv
    enc_len = kvs[0][1][0].shape[1]
    cache = model.new_cache(B, s_max, enc_len=enc_len)
    for g, ((k, v), _) in zip(cache["layers"], kvs):
        g["k"][:, :S] = k
        g["v"][:, :S] = v
        g["cpos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                        device=k.device)
    cache["pos"] = S
    return write_cross_kv(cache, [ckv for _, ckv in kvs])


def phase_seamless_serve():
    """Phase 61: seamless-m4t-large-v2 at full width and depth (24
    encoder + 24 decoder layers, f32 parameters, bf16 compute), random
    weights from seed 0, through the engine: two batched prefills of B=4 x
    2048 tokens over 2048 encoder frames from the seed
    (``prefill(enc_input=)``) with every counter set to 0 just before and
    read just after (K5 72 times a prefill: 24 encoder layers and 24
    cross layers non-causal, 24 self-attention layers causal; nothing
    else), then 32 greedy tokens from the cache the prefill's self and
    cross K/V fill (no K5): finite logits, prefill tokens/s, decode
    ms/step, peak memory. Then the launcher (``--device cuda``, B=4,
    prompt 64 fed a token a step, 8 tokens) at full depth, with exact
    launches."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    cfg = get_config(SEAMLESS)
    sh = SEAMLESS_SERVE
    B, S, S_enc = sh["B"], sh["S"], sh["S_enc"]
    counters = _kernel_counters()
    held = _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - held
    r = np.random.default_rng(0)
    toks = torch.as_tensor(r.integers(1, cfg.vocab_size, (B, S)),
                           dtype=torch.int32, device="cuda")
    enc = torch.as_tensor(r.standard_normal((B, S_enc, cfg.prefix_dim)),
                          dtype=torch.float32, device="cuda")
    s_max = S + ARCH_GEN
    tally, undo = _k5_tally()
    try:
        for fn in counters.values():
            fn.launches = 0
        model.prefill(toks, s_max, luffy=luffy, enc_input=enc)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kvs = model.prefill(toks, s_max, luffy=luffy, enc_input=enc)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        undo()
    L, Le = cfg.num_layers, cfg.num_encoder_layers
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = 2 * (Le + 2 * L)
    want_tally = {"causal": 2 * L, "noncausal": 2 * (Le + L),
                  "noncausal_sq_ne_sk": 0}
    cache = _encdec_cache(model, kvs, B, S, s_max)
    shapes = dict(k=list(kvs[0][0][0].shape), ck=list(kvs[0][1][0].shape))
    del kvs
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, lgs = _greedy(model, cache, logits, ARCH_GEN, luffy)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_launches = {k: fn.launches for k, fn in counters.items()}
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in lgs)
    info = dict(arch=cfg.name, layers=L, encoder_layers=Le, batch=B,
                prompt_len=S, enc_len=S_enc, gen=ARCH_GEN, init_s=init_s,
                weight_bytes=weights, prefill_s=prefill_s,
                prefill_tok_s=B * S / prefill_s,
                decode_ms_per_step=decode_s / ARCH_GEN * 1e3,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, launches_expected=want,
                k5_by_mask=tally, k5_by_mask_expected=want_tally,
                k5_per_prefill=launches["flash_attention"] // 2,
                decode_launches=dec_launches, finite=finite,
                cache_shapes=shapes,
                logits_max_abs=logits.abs().max().item(),
                sample_tokens=tokens[0, :8].tolist())
    del model, cache, logits, lgs, toks, enc
    _free_card()
    log("seamless serve: " + json.dumps(info))
    if not finite:
        raise SystemExit("seamless: logits not finite")
    if launches != want or tally != want_tally or any(dec_launches.values()):
        raise SystemExit(f"seamless: launches {launches} ({tally}), decode "
                         f"{dec_launches}, differ from what the path calls "
                         f"({want}, {want_tally}, none)")
    for fn in counters.values():
        fn.launches = 0
    res = serve.main(SEAMLESS_LAUNCHER_ARGS)
    lau = {k: fn.launches for k, fn in counters.items()}
    lwant = dict.fromkeys(lau, 0)
    lwant["flash_attention"] = serve.N_BATCHED_PREFILLS * (Le + 2 * L)
    lfinite = all(bool(torch.isfinite(t).all()) for t in
                  [res["prefill_logits"]] + res["step_logits"]
                  + res["gen_logits"])
    info["launcher"] = dict(launches=lau, launches_expected=lwant,
                            finite=lfinite,
                            prefill_tok_s=res["prefill_tok_s"],
                            prompt_feed_s=res["prompt_feed_s"],
                            decode_ms_per_step=res["decode_ms_per_step"],
                            peak_mem_bytes=res.get("peak_mem_bytes"),
                            sample_tokens=res["tokens"][0].tolist())
    log("seamless launcher: " + json.dumps(info["launcher"]))
    del res
    _free_card()
    if lau != lwant or not lfinite:
        raise SystemExit(f"seamless launcher: launches {lau} (want "
                         f"{lwant}), finite {lfinite}")
    return info


def _parity_encdec(cfg, B: int, S: int, S_enc: int, gen_n: int, seed: int):
    """Reduced seamless on the card, then the same parameters on the
    CPU: prefill logits over ``S_enc`` encoder frames, and ``gen_n``
    greedy tokens from the cache the prefill fills, each side decoding
    its own tokens. Returns the comparison."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    r = np.random.default_rng(seed)
    toks = torch.as_tensor(r.integers(1, cfg.vocab_size, (B, S)),
                           dtype=torch.int32)
    enc = torch.as_tensor(r.standard_normal((B, S_enc, cfg.prefix_dim)),
                          dtype=torch.float32)
    model = build_model(cfg, device="cuda", seed=seed)
    s_max = S + gen_n
    res = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            model.to("cpu")         # the same parameters, moved
        k5 = kfa.flash_attention.launches
        lg, kvs = model.prefill(toks.to(dev), s_max, luffy=luffy,
                                enc_input=enc.to(dev))
        k5 = kfa.flash_attention.launches - k5
        cache = _encdec_cache(model, kvs, B, S, s_max)
        tokens, lgs = _greedy(model, cache, lg, gen_n, luffy)
        res[dev] = dict(prefill=lg.float().cpu(), tokens=tokens.cpu(),
                        gen=[t.float().cpu() for t in lgs], k5=k5)
        del kvs, cache
    del model
    _free_card()
    a, b = res["cuda"], res["cpu"]
    same = torch.equal(a["tokens"], b["tokens"])
    return dict(prefill_max_abs=(a["prefill"] - b["prefill"]).abs().max()
                .item(),
                gen_max_abs=max((x - y).abs().max().item() for x, y in
                                zip(a["gen"], b["gen"])) if same else None,
                logits_max_abs=b["prefill"].abs().max().item(),
                tokens_equal=same, k5_launches_card=a["k5"],
                k5_launches_cpu=b["k5"])


def phase_seamless_parity():
    """Phase 62: reduced seamless (2 encoder + 2 decoder layers, d 256)
    at a prompt of 256 over 300 encoder frames (the cross layers at
    Sq != Sk on K5), the card against the CPU: at f32 compute prefill
    and decode logits within ``SEAMLESS_PARITY_TOL`` and the 8 greedy
    tokens equal, K5 6 times a prefill on the card and never on the CPU;
    the same at bf16 recorded, not gated."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    p = SEAMLESS_PARITY
    red = reduced(get_config(SEAMLESS))
    out = {}
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(red, compute_dtype=cdt)
        rr = _parity_encdec(cfg, p["B"], p["S"], p["S_enc"], p["gen"],
                            seed=62)
        rr.update(compute_dtype=cdt, prompt_len=p["S"], enc_len=p["S_enc"],
                  k5_launches_expected=cfg.num_encoder_layers
                  + 2 * cfg.num_layers,
                  tol=SEAMLESS_PARITY_TOL if cdt == "float32" else None)
        out[cdt] = rr
        log(f"seamless parity {cdt}: " + json.dumps(rr))
    f = out["float32"]
    if not (f["prefill_max_abs"] <= SEAMLESS_PARITY_TOL and f["tokens_equal"]
            and f["gen_max_abs"] <= SEAMLESS_PARITY_TOL
            and f["k5_launches_card"] == f["k5_launches_expected"]
            and f["k5_launches_cpu"] == 0):
        raise SystemExit("reduced seamless, card against CPU at f32: "
                         + json.dumps(f))
    return out


def run_seamless_phases():
    """Phases 60-62 in order."""
    return {"kernels": phase_seamless_kernels(),
            "serve": phase_seamless_serve(),
            "parity": phase_seamless_parity()}


def _seamless_records(sm):
    """K5 at seamless's shapes (phase 60): each bf16 record with the K5
    launches of phase 61's serve run (2 batched prefills), by mask; each
    f32 one with those of phase 62's f32 card run (one prefill)."""
    sv, par = sm["serve"], sm["parity"]["float32"]
    by_mask = {"encoder": "noncausal", "decoder": "causal",
               "cross": "noncausal"}
    recs = []
    for name, t in sm["kernels"].items():
        case, dt = name.rsplit("-", 1)
        if dt == "bfloat16":
            launches = sv["launches"]["flash_attention"]
            path = (f"{SEAMLESS} serve at 24 + 24 layers, 2 batched prefills "
                    f"of 4 x 2048 over 2048 frames: {sv['k5_by_mask']}")
        else:
            launches = par["k5_launches_card"]
            path = (f"reduced {SEAMLESS} card run at f32 (2 + 2 layers, "
                    f"prompt {SEAMLESS_PARITY['S']} over "
                    f"{SEAMLESS_PARITY['S_enc']} frames, one prefill)")
        recs.append(_record(
            f"flash_attention@{SEAMLESS}-{name}",
            "src/repro_torch/csrc/flash_attn.cu",
            "src/repro/kernels/flash_attn.py:87", launches, t,
            {"kernel": "flash_attention",
             "timed_at": f"{list(t['shape'])} (B, Sq, Sk, H, KV, hd) {dt}, "
                         + ("causal" if t["causal"] else "non-causal"),
             "launches_path": path,
             "launches_kind": by_mask.get(case, "noncausal (a ragged cross "
                                                "shape: checks)"),
             "dispatch": t["route"], "device_ms": t["device_ms"],
             "library": t["library"], "library_error": t["library_error"],
             "bound_share": t["bound_share"],
             "max_row_rel_err": t["max_row_rel_err"],
             "repeat_bitwise": t["repeat_bitwise"], "plain": t["plain"]}))
    return recs


RWKV = "rwkv6-3b"
# phase 64: full width and depth; the batched prefill, then the decode
# cache built by the step feed of a short prompt (a 2048-step feed at 32
# layers would take minutes), greedy tokens, a recycled slot
RWKV_SERVE = dict(B=4, S=2048)
RWKV_FEED = dict(B=4, S=64, gen=32)
# phase 63: K7 at rwkv6-3b's shapes (40 heads of 64): (B, S, H, from a
# random state); the prefill's from the zero state, the same from a
# random one, the decode step's (phase 64's batch, and one sequence), a
# ragged S on few heads; then S at the edges of K7's staged chunk of
# K7_T steps (T - 1, T, T + 1, 2T + 3), and 167 heads, whose 668 blocks
# (four a head) leave the card's last wave of 660 (five an SM) partial
K7_T = 16
K7_CASES = {"prefill": (RWKV_SERVE["B"], RWKV_SERVE["S"], 40, False),
            "prefill-state": (RWKV_SERVE["B"], RWKV_SERVE["S"], 40, True),
            "decode": (RWKV_FEED["B"], 1, 40, True),
            "decode-1": (1, 1, 40, True),
            "ragged": (2, 1000, 4, True),
            **{f"chunk-{s}": (2, s, 40, True)
               for s in (K7_T - 1, K7_T, K7_T + 1, 2 * K7_T + 3)},
            "partial-wave": (1, 2 * K7_T + 3, 167, True)}
# S launches at S = 1 against one over S: longer than a ring of chunks,
# ending in a partial one
K7_CHAIN = (1, 4 * K7_T + 3, 40)
K7_DEVICE_TIMED = ("prefill", "decode")    # also by profiler device time
# y within K7_TOL of each row's norm over the head, the final state of
# each head's state norm: f32 sums in another order (partial sums of y
# across lanes) and fused multiply-adds against the plain version's
# separate roundings, over a state that remembers up to some three
# thousand steps; at the prefill from the zero state also y within K7_TOL
# of an f64 recurrence (the plain version's own error at a first step
# whose bonus cancels can come near K7_TOL)
K7_TOL = 2e-5
# the step-fed logits against the batched prefill's: at bf16 through 32
# layers the two paths round their products at other shapes (cuBLAS at
# M = 4 against M = 256) and differed by 6.25e-2 on an H100 (two bf16
# ulps of a logit in [4, 8)), so bf16 is held at four ulps and the
# algorithm at f32 on a 4-layer full-width cut, where the paths differ
# only by f32 sums in another order
RWKV_FEED_TOL = {"bfloat16": 0.125, "float32": 1e-4}
RWKV_FEED_F32_LAYERS = 4
RWKV_RECYCLE = dict(B=2, s_max=12, warm=6, seq=6)
RWKV_LAUNCHER_ARGS = ["--arch", RWKV, "--batch", "4", "--prompt-len", "64",
                      "--gen", "8", "--prefill", "batch", "--device", "cuda",
                      "--seed", "0"]
RWKV_CONT_ARGS = ["--arch", RWKV, "--continuous", "--batch", "2",
                  "--prompt-len", "6", "--gen", "4", "--requests", "4",
                  "--burst", "2", "--arrival-every", "2", "--device", "cuda",
                  "--seed", "0"]
# phase 65: reduced rwkv6 (2 layers, d 256), card against CPU; bf16 at
# phase 51's flat gate (one bf16 ulp of a logit in [4, 8), 3.125e-2, is
# over the serve gate of 3e-2)
RWKV_PARITY = dict(B=2, S=64, gen=8)
RWKV_PARITY_TOL = {"float32": 1e-4, "bfloat16": ARCH_PARITY_TOL}


def _k7_inputs(B, S, H, seed, state):
    """K7's operands as the time-mix gives them, on the card: r, k, v ~
    N(0, 1), decays w = exp(-exp(z)) with z uniform in [-8, 1] (memories
    of one step to some three thousand), a bonus of 0.1 N(0, 1), a random
    state (or None: zeros)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = rn(B, S, H, 64), rn(B, S, H, 64), rn(B, S, H, 64)
    z = torch.rand((B, S, H, 64), generator=gen, device="cuda") * 9.0 - 8.0
    return (r, k, v, torch.exp(-torch.exp(z)), rn(H, 64) * 0.1,
            rn(B, H, 64, 64) if state else None)


def _rel_norm_err(got, want, dims):
    """The largest ||got - want|| / ||want|| over ``dims``."""
    import torch
    d = torch.linalg.vector_norm(got - want, dim=dims)
    n = torch.linalg.vector_norm(want, dim=dims).clamp_min(1e-30)
    return (d / n).max().item()


def _k7_scan64(r, k, v, w, u, state=None):
    """The WKV6 recurrence in f64, step by step (the plain version's
    order): the yardstick of K7's and the plain version's own errors."""
    import torch
    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    B, S, H, hd = r.shape
    st = (torch.zeros((B, H, hd, hd), dtype=torch.float64, device=r.device)
          if state is None else state.double())
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               st + u[..., None] * kv))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, 1)


def phase_rwkv_kernels():
    """Phase 63: K7 (``csrc/wkv6.cu``) against its plain version
    (``ref.wkv6_scan_ref``, the reference's step order) on the card at
    ``K7_CASES``: y within ``K7_TOL`` of each row's norm and the final
    state of each head's, a second launch bit for bit; at the prefill
    from the zero state also y within ``K7_TOL`` of an f64 recurrence,
    with the plain version's own error against it recorded; then
    ``K7_CHAIN``'s S launches at S = 1, each from the state the last
    returned as the decode step carries it, bit for bit one launch over S
    (y and state); grad mode with an operand that requires grad going
    through K7's autograd function (its backward is phase 66's). Each
    case timed (CUDA events; the prefill's and the decode
    step's also by profiler device time) beside the plain version and the
    bound: the operations the function needs at 67 TFLOP/s (5 f32 a state
    element and step: y += r S, then w S + k v; and the rank-one bonus
    v_j a_t with a_t = sum_i r_i u_i k_i, 3 a row and 2 a column, so 5 a
    head element and step), or the bytes (r, k, v, w and u read and y
    written once, the state read where given and written), the larger.
    Records the kernel's design (``kwkv.occupancy``). No PyTorch call
    computes WKV6: no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as kwkv
    out = {"design": kwkv.occupancy()}
    log(f"  K7 design: {json.dumps(out['design'])}")
    for i, (name, (B, S, H, state)) in enumerate(K7_CASES.items()):
        t_case = time.perf_counter()
        args = _k7_inputs(B, S, H, 630 + i, state)

        def run(args=args):
            return kwkv.wkv6_scan(*args)

        (y, st), (y2, st2) = run(), run()
        torch.cuda.synchronize()
        wy, wst = ref.wkv6_scan_ref(*args)
        rec = dict(shape=(B, S, H, 64), from_state=state,
                   y_row_rel_err=_rel_norm_err(y, wy, (-1,)),
                   state_rel_err=_rel_norm_err(st, wst, (-2, -1)),
                   max_abs_err=max((y - wy).abs().max().item(),
                                   (st - wst).abs().max().item()),
                   repeat_bitwise=bool(torch.equal(y, y2)
                                       and torch.equal(st, st2)))
        rec["ok"] = (rec["y_row_rel_err"] <= K7_TOL
                     and rec["state_rel_err"] <= K7_TOL)
        if name == "prefill":
            t64 = time.perf_counter()
            y64 = _k7_scan64(*args)
            rec["f64_s"] = time.perf_counter() - t64
            rec.update(y_row_rel_err_f64=_rel_norm_err(y.double(), y64,
                                                       (-1,)),
                       plain_y_row_rel_err_f64=_rel_norm_err(
                           wy.double(), y64, (-1,)))
            rec["ok"] = rec["ok"] and rec["y_row_rel_err_f64"] <= K7_TOL
            del y64
        del y, st, y2, st2, wy, wst
        nbytes = 4 * (5 * B * S * H * 64 + H * 64
                      + (2 if state else 1) * B * H * 64 * 64)
        rec.update(_bound(nbytes, (5.0 * 64 + 5.0) * B * S * H * 64))
        iters = 20 if S > 1 else 200
        if name in K7_DEVICE_TIMED:
            rec.update(_timed(run, None, lambda a=args: ref.wkv6_scan_ref(*a),
                              iters))
        else:
            ms = [time_ms(run, iters, 2) for _ in range(2)]
            rec.update(ms=min(ms), ms_runs=ms, device_ms=None,
                       plain_ms=time_ms(lambda a=args: ref.wkv6_scan_ref(*a),
                                        1, 0), library_ms=None)
        rec.update(plain="ref.wkv6_scan_ref, one step a loop iteration",
                   library=None, bound_share=rec["bound_ms"] / rec["ms"],
                   case_s=time.perf_counter() - t_case)
        out[name] = rec
        log(f"  K7 {name:13s} [{B},{S},{H},64] "
            f"{'random' if state else 'zero'} state: y row "
            f"{rec['y_row_rel_err']:.2e}, state {rec['state_rel_err']:.2e},"
            f" max|err| {rec['max_abs_err']:.2e} "
            f"{'ok' if rec['ok'] else 'FAIL'}, repeat bitwise "
            f"{rec['repeat_bitwise']}; kernel {rec['ms']:.4f} ms (runs "
            f"{rec['ms_runs']}; device {rec['device_ms']}), plain "
            f"{rec['plain_ms']:.2f} ms; bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} ({100 * rec['bound_share']:.1f}% of it)"
            + (f"; y row against f64 {rec['y_row_rel_err_f64']:.2e} (the "
               f"plain version's {rec['plain_y_row_rel_err_f64']:.2e}; "
               f"{rec['f64_s']:.1f} s)" if "y_row_rel_err_f64" in rec else "")
            + f"; {rec['case_s']:.1f} s")
        del args
        torch.cuda.empty_cache()
    r, k, v, w, u, s0 = _k7_inputs(*K7_CHAIN, 639, True)
    y, st = kwkv.wkv6_scan(r, k, v, w, u, s0)
    state, ys = s0, []
    for t in range(r.shape[1]):
        yt, state = kwkv.wkv6_scan(r[:, t:t + 1], k[:, t:t + 1],
                                   v[:, t:t + 1], w[:, t:t + 1], u, state)
        ys.append(yt)
    torch.cuda.synchronize()
    chained = bool(torch.equal(torch.cat(ys, 1), y)
                   and torch.equal(state, st))
    yg, _ = kwkv.wkv6_scan(r.clone().requires_grad_(), k, v, w, u, s0)
    grad_fn = type(yg.grad_fn).__name__
    through = grad_fn == "WKV6ScanBackward"
    del yg
    out["chain"] = dict(shape=K7_CHAIN, chained_bitwise=chained,
                        grad_function=grad_fn)
    log(f"  K7 {r.shape[1]} chained launches at S = 1 bit for bit one "
        f"launch over S: {chained}; grad mode through {grad_fn}")
    bad = [dict(case=n, **{x: c[x] for x in ("ok", "repeat_bitwise",
                                              "y_row_rel_err",
                                              "state_rel_err")})
           for n, c in out.items() if n not in ("chain", "design")
           and not (c["ok"] and c["repeat_bitwise"])]
    if bad or not chained or not through:
        raise SystemExit(f"K7 disagrees with its plain version or its "
                         f"contract: {bad}, chained bitwise {chained}, "
                         f"grad mode through {grad_fn}")
    return out


def _ties_ok(a, b, tol):
    """Greedy tokens of logits ``a`` and ``b`` [B, V] agree up to ties: a
    row's argmaxes may differ only where, in each run, the two tokens'
    logits are within ``tol`` of each other. Returns (equal, ok)."""
    ta, tb = a.argmax(-1), b.argmax(-1)
    rows = (ta != tb).nonzero().flatten().tolist()
    ok = all(abs(x[i, ta[i]] - x[i, tb[i]]).item() <= tol
             for x in (a, b) for i in rows)
    return not rows, ok


def _rwkv_profile(model, toks, luffy):
    """One batched prefill of ``toks`` and one decode step (B=4, from a
    fresh cache) under torch.profiler: device ms against wall ms (the
    busy share), the top device ops and K7's share of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    cache = model.new_cache(toks.shape[0], 2)
    for name, fn in (("prefill", lambda: model.prefill(toks, toks.shape[1],
                                                       luffy=luffy)),
                     ("decode_step", lambda: model.decode_step(
                         cache, toks[:, :1], luffy=luffy))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = _device_rows(prof)
        busy = sum(r[0] for r in rows)
        k7 = sum(d for d, key, _ in rows if "wkv6_kernel" in key)
        out[name] = dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
                         device_busy_share=busy / wall_us if rows else None,
                         k7_ms=k7 / 1e3,
                         k7_share=k7 / busy if busy else None,
                         top=[{"op": k[:60], "ms": d / 1e3, "count": c}
                              for d, k, c in rows[:8]])
    return out


def _rwkv_feed_f32(cfg, luffy):
    """The step feed against the batched prefill at f32 compute on a
    full-width cut of ``RWKV_FEED_F32_LAYERS`` layers, ``RWKV_FEED``'s
    prompt: the last logits' largest difference and the greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    cut = dataclasses.replace(cfg, num_layers=RWKV_FEED_F32_LAYERS,
                              compute_dtype="float32")
    B, S = RWKV_FEED["B"], RWKV_FEED["S"]
    model = build_model(cut, device="cuda", seed=0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cut.vocab_size, (B, S)), dtype=torch.int32, device="cuda")
    lg_batch, _ = model.prefill(toks, S, luffy=luffy)
    cache = model.new_cache(B, S)
    for t in range(S):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], luffy=luffy)
    a, b = lg.float().cpu(), lg_batch.float().cpu()
    del model, cache
    _free_card()
    return dict(layers=RWKV_FEED_F32_LAYERS, prompt_len=S,
                max_abs=(a - b).abs().max().item(),
                logits_max_abs=b.abs().max().item(),
                tokens_equal=bool(torch.equal(a.argmax(-1),
                                              b.argmax(-1))))


def phase_rwkv_serve():
    """Phase 64: rwkv6-3b at full width and depth (32 layers, d 2560, 40
    heads of 64, f32 parameters, bf16 compute), random weights from seed
    0: two batched prefills of B=4 x 2048 through the engine with every
    counter set to 0 just before and read just after (K7 exactly 32
    launches a prefill, nothing else: no K5), prefill tokens/s and peak
    memory; the decode cache built by the step feed of a 64-token prompt
    (B=4) and 32 greedy tokens (K7 exactly 32 launches a step), ms a
    step; the step-fed last logits against the batched prefill of the
    same 64 tokens within ``RWKV_FEED_TOL["bfloat16"]`` and their greedy
    tokens equal up to ties within it, and on a 4-layer full-width cut
    at f32 within ``RWKV_FEED_TOL["float32"]`` with the same tokens; a
    slot recycled by ``admit_slot`` (its WKV6 state and both token
    shifts zeroed) decoding bit for bit as a fresh cache's; a profiled
    prefill and decode step (busy share, top ops, K7's share). Then the
    launcher (``RWKV_LAUNCHER_ARGS``) and a short ``--continuous`` run
    (``RWKV_CONT_ARGS``), each with exact launches."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    cfg = get_config(RWKV)
    L = cfg.num_layers
    counters = dict(_kernel_counters(), wkv6_scan=kwkv.wkv6_scan)

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    def only_k7(n):
        return dict(dict.fromkeys(counters, 0), wkv6_scan=n)

    held = _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = t_phase = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - held
    B, S = RWKV_SERVE["B"], RWKV_SERVE["S"]
    r = np.random.default_rng(0)
    toks = torch.as_tensor(r.integers(1, cfg.vocab_size, (B, S)),
                           dtype=torch.int32, device="cuda")
    zero()
    model.prefill(toks, S, luffy=luffy)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kvs = model.prefill(toks, S, luffy=luffy)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = read()
    prefill_peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all()) and kvs == [None] * L
    part("init_and_prefills")

    fb, fs, gen = RWKV_FEED["B"], RWKV_FEED["S"], RWKV_FEED["gen"]
    short = toks[:fb, :fs]
    lg_batch, _ = model.prefill(short, fs + gen, luffy=luffy)
    cache = model.new_cache(fb, fs + gen)
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(fs):
        lg_feed, cache = model.decode_step(cache, short[:, t:t + 1],
                                           luffy=luffy)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    feed_launches = read()
    zero()
    t0 = time.perf_counter()
    tokens, lgs = _greedy(model, cache, lg_feed, gen, luffy)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_launches = read()
    finite &= all(bool(torch.isfinite(t).all()) for t in lgs)
    a, b = lg_feed.float().cpu(), lg_batch.float().cpu()
    tok_equal, tok_ok = _ties_ok(a, b, RWKV_FEED_TOL["bfloat16"])
    del cache, lgs
    part("feed_and_decode")
    got, want, zeroed = _recycled_vs_fresh(model, RWKV_RECYCLE, seed=63)
    recycled = bool(torch.equal(got, want))
    part("recycled")
    prof = _rwkv_profile(model, toks, luffy)
    part("profile")
    info = dict(arch=cfg.name, layers=L, batch=B, prompt_len=S,
                init_s=init_s, weight_bytes=weights, prefill_s=prefill_s,
                prefill_tok_s=B * S / prefill_s,
                prefill_peak_mem_bytes=prefill_peak, launches=launches,
                launches_expected=only_k7(2 * L),
                feed=dict(batch=fb, prompt_len=fs, gen=gen, feed_s=feed_s,
                          feed_ms_per_step=feed_s / fs * 1e3,
                          decode_ms_per_step=decode_s / gen * 1e3,
                          feed_launches=feed_launches,
                          decode_launches=dec_launches,
                          feed_vs_batched_max_abs=(a - b).abs().max().item(),
                          logits_max_abs=b.abs().max().item(),
                          tokens_equal=tok_equal, tokens_equal_up_to_ties=
                          tok_ok, sample_tokens=tokens[0, :8].tolist()),
                recycled=dict(bitwise=recycled, rows_zeroed=zeroed,
                              max_abs=(got - want).abs().max().item()),
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                finite=finite, profile=prof)
    del model, logits, kvs, lg_batch, lg_feed, toks, short, got, want
    _free_card()
    info["feed_f32_cut"] = _rwkv_feed_f32(cfg, luffy)
    part("feed_f32_cut")
    log("rwkv6 serve: " + json.dumps(info))
    f, f32 = info["feed"], info["feed_f32_cut"]
    if not (finite and launches == only_k7(2 * L)
            and feed_launches == only_k7(L * fs)
            and dec_launches == only_k7(L * gen)
            and f["feed_vs_batched_max_abs"] <= RWKV_FEED_TOL["bfloat16"]
            and tok_ok and f32["max_abs"] <= RWKV_FEED_TOL["float32"]
            and f32["tokens_equal"] and recycled and zeroed):
        raise SystemExit("rwkv6 serve failed its gates: " + json.dumps(info))

    zero()
    res = serve.main(RWKV_LAUNCHER_ARGS)
    lau = read()
    lwant = only_k7(L * (serve.N_BATCHED_PREFILLS + 64 + 8))
    lfinite = all(bool(torch.isfinite(t).all()) for t in
                  [res["prefill_logits"]] + res["step_logits"]
                  + res["gen_logits"])
    info["launcher"] = dict(launches=lau, launches_expected=lwant,
                            finite=lfinite,
                            prefill_tok_s=res["prefill_tok_s"],
                            prompt_feed_s=res["prompt_feed_s"],
                            decode_ms_per_step=res["decode_ms_per_step"],
                            peak_mem_bytes=res.get("peak_mem_bytes"),
                            sample_tokens=res["tokens"][0].tolist())
    del res
    _free_card()
    part("launcher")
    zero()
    cont = serve.main(RWKV_CONT_ARGS)
    clau = read()
    calls = cont["model_calls"]
    info["continuous"] = dict(
        launches=clau, launches_expected=only_k7(L * calls),
        finished=cont["finished"], slot_churn=cont["slot_churn"],
        model_calls=calls, tok_s=cont["tok_s"],
        decode_ms_per_step=cont["decode_ms_per_step"], slo=cont["slo"])
    del cont
    _free_card()
    part("continuous")
    info["parts_s"] = parts
    log("rwkv6 launcher and continuous: " + json.dumps(
        {k: info[k] for k in ("launcher", "continuous", "parts_s")}))
    c = info["continuous"]
    if not (lau == lwant and lfinite and clau == c["launches_expected"]
            and c["finished"] == 4 and c["slot_churn"] > 0):
        raise SystemExit("rwkv6 launcher or continuous run failed: "
                         + json.dumps({k: info[k] for k in
                                       ("launcher", "continuous")}))
    return info


def phase_rwkv_parity():
    """Phase 65: reduced rwkv6 (2 layers, d 256, 4 heads of 64) on the
    card (K7) against the same parameters on the CPU (K7's plain
    version): the batched prefill's logits at a prompt of
    ``RWKV_PARITY["S"]``, the prompt fed a token a step (the last
    logits) and ``gen`` greedy tokens from that cache, each side decoding
    its own tokens. f32 compute: logits within 1e-4, tokens equal, K7
    once a layer a prefill and a step on the card and never on the CPU;
    bf16 compute: logits within ``ARCH_PARITY_TOL``, tokens recorded."""
    import numpy as np
    import torch
    from repro_torch.config import LuffyConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    p = RWKV_PARITY
    B, S, gen = p["B"], p["S"], p["gen"]
    red = reduced(get_config(RWKV))
    out = {}
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(red, compute_dtype=cdt)
        toks = torch.as_tensor(np.random.default_rng(65).integers(
            1, cfg.vocab_size, (B, S)), dtype=torch.int32)
        model = build_model(cfg, device="cuda", seed=65)
        res = {}
        for dev in ("cuda", "cpu"):
            if dev == "cpu":
                model.to("cpu")     # the same parameters, moved
            k7 = kwkv.wkv6_scan.launches
            tk = toks.to(dev)
            pf, _ = model.prefill(tk, S + gen, luffy=luffy)
            cache = model.new_cache(B, S + gen)
            for t in range(S):
                lg, cache = model.decode_step(cache, tk[:, t:t + 1],
                                              luffy=luffy)
            tokens, lgs = _greedy(model, cache, lg, gen, luffy)
            res[dev] = dict(prefill=pf.float().cpu(), feed=lg.float().cpu(),
                            tokens=tokens.cpu(),
                            gen=[x.float().cpu() for x in lgs],
                            k7=kwkv.wkv6_scan.launches - k7)
        del model
        _free_card()
        a, b = res["cuda"], res["cpu"]
        same = bool(torch.equal(a["tokens"], b["tokens"]))
        rr = dict(compute_dtype=cdt, prompt_len=S, gen=gen,
                  prefill_max_abs=(a["prefill"] - b["prefill"]).abs().max()
                  .item(),
                  feed_max_abs=(a["feed"] - b["feed"]).abs().max().item(),
                  gen_max_abs=max((x - y).abs().max().item() for x, y in
                                  zip(a["gen"], b["gen"])) if same else None,
                  logits_max_abs=b["prefill"].abs().max().item(),
                  tokens_equal=same, k7_launches_card=a["k7"],
                  k7_launches_cpu=b["k7"],
                  k7_launches_expected=cfg.num_layers * (1 + S + gen),
                  tol=RWKV_PARITY_TOL[cdt])
        out[cdt] = rr
        log(f"rwkv6 parity {cdt}: " + json.dumps(rr))
    bad = []
    for cdt, rr in out.items():
        tol = rr["tol"]
        ok = (rr["prefill_max_abs"] <= tol and rr["feed_max_abs"] <= tol
              and rr["k7_launches_card"] == rr["k7_launches_expected"]
              and rr["k7_launches_cpu"] == 0)
        if cdt == "float32":
            ok &= rr["tokens_equal"] and rr["gen_max_abs"] <= tol
        if not ok:
            bad.append(rr)
    if bad:
        raise SystemExit("reduced rwkv6, card against CPU: "
                         + json.dumps(bad))
    return out


def run_rwkv_phases():
    """Phases 63-65 in order."""
    return {"kernels": phase_rwkv_kernels(), "serve": phase_rwkv_serve(),
            "parity": phase_rwkv_parity()}


def _rwkv_records(rw):
    """K7's record: timed at the prefill's shape from the zero state (the
    prefill's call), with the launches of phase 64's two batched
    prefills; the other shapes, the decode path's launches and the
    chained check beside it."""
    k, sv = rw["kernels"], rw["serve"]
    t = k["prefill"]
    return [_record(
        "wkv6_scan", "src/repro_torch/csrc/wkv6.cu",
        "src/repro/models/ssm.py:177 (_rwkv6_core's lax.scan; no Pallas "
        "kernel)", sv["launches"]["wkv6_scan"],
        dict(t, max_abs_err=max(c["max_abs_err"] for n, c in k.items()
                                if n not in ("chain", "design"))),
        {"timed_at": "[4,2048,40,64] f32 from the zero state (rwkv6-3b's "
                     "prefill)",
         "launches_path": f"{RWKV} serve at 32 layers, 2 batched prefills "
                          f"of 4 x 2048",
         "launches_feed_and_decode": {
             "feed": sv["feed"]["feed_launches"]["wkv6_scan"],
             "decode": sv["feed"]["decode_launches"]["wkv6_scan"],
             "launcher": sv["launcher"]["launches"]["wkv6_scan"],
             "continuous": sv["continuous"]["launches"]["wkv6_scan"]},
         "device_ms": t["device_ms"], "bound_share": t["bound_share"],
         "plain": t["plain"], "library": "none (no PyTorch call computes "
                                         "WKV6)",
         "chained_bitwise": k["chain"]["chained_bitwise"],
         "design": k["design"],
         "y_row_rel_err_f64": t["y_row_rel_err_f64"],
         "plain_y_row_rel_err_f64": t["plain_y_row_rel_err_f64"],
         "cases": {n: {x: c[x] for x in ("shape", "ms", "device_ms",
                                         "plain_ms", "bound_ms",
                                         "y_row_rel_err", "state_rel_err")}
                   for n, c in k.items() if n not in ("chain", "design")}})]


# phase 66: K7's backward at rwkv6-3b's train shapes (B, S, H, from a
# random state with a cotangent on the final state): the train step's
# [4,2048,40] from the zero state (y's cotangent alone, as the time-mix
# gives it), [1,2048,40] from a random state (dS0), a ragged [2,1000,4]
# whose last chunk is partial, 87 heads at B = 2 (696 blocks: the grid's
# last round partial at 5 blocks an SM, and at 4), and one (batch, head),
# a single cluster; ``_k7b_cases`` adds the design's edges
K7B_CASES = {"train": (4, 2048, 40, False), "state": (1, 2048, 40, True),
             "ragged": (2, 1000, 4, True), "heads87": (2, 37, 87, True),
             "one_cluster": (1, 100, 1, True)}
# each gradient within K7B_TOL of its norm: of the plain backward, and at
# K7B_F64 of an f64 autograd through the plain forward
K7B_TOL = 1e-4
K7B_F64 = "state"
K7B_GRADS = ("dr", "dk", "dv", "dw", "du", "dS0")
# the backward's launches by name (csrc/wkv6_bwd.cu)
K7B_KERNELS = ("ckpt_kernel", "bwd_kernel", "du_kernel")
# phase 67: the dense f32 archs trained at full width and depth, B=4 x
# 2048 as in their serve cells (internvl2: 256 prefix slots + 1792
# tokens; seamless over 2048 frames)
DENSE_ARCHS = (RWKV, "internvl2-2b", SEAMLESS)
DENSE_TRAIN_ARGS = ["--steps", "3", "--global-batch", "4", "--seq-len",
                    "2048", "--optimizer", "adamw", "--seed", "0",
                    "--mesh", "none", "--device", "cuda"]
# phase 68: reduced rwkv6 (2 layers, d 256), one f32 train step, card
# against CPU
DENSE_PARITY = dict(B=2, S=64)
DENSE_PARITY_TOL = {"loss": 1e-5, "grad": 1e-4}


def _norm_rel(got, want):
    """||got - want|| / ||want|| over the whole tensor."""
    return ((got.double() - want.double()).norm()
            / want.double().norm().clamp_min(1e-300)).item()


def _k7b_cases(design):
    """``K7B_CASES`` and the built design's edges: S = D - 1, D, D + 1,
    C + 1 and 2 C + 3 (D steps a sub-chunk, C between checkpoints) at
    [2, S, 4] from a random state."""
    D, C = design["D"], design["C"]
    edges = {f"S{S}": (2, S, 4, True)
             for S in (D - 1, D, D + 1, C + 1, 2 * C + 3)}
    return {**K7B_CASES, **edges}


def _k7b_split(rows, n: int):
    """Device ms a call of each of the backward's kernels (``K7B_KERNELS``)
    in profiler rows of ``n`` calls, and their sum: each kernel's mean
    duration times its launches a call (``_per_call_ms``: the profiler can
    record fewer launches than were made)."""
    out = {x: sum(d / c * max(1, round(c / n)) for d, k, c in rows
                  if f"::{x}(" in k) / 1e3
           for x in K7B_KERNELS}
    out["sum"] = sum(out.values())
    return out


def _k7b_split_ms(fn, n: int):
    """``_k7b_split`` of ``n`` calls of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return _k7b_split(_device_rows(prof), n)


def phase_k7_bwd():
    """Phase 66: K7's backward (``csrc/wkv6_bwd.cu``: the checkpoint
    pass, the reverse walk in clusters, du's sum) against its plain
    version (``ref.wkv6_scan_bwd_ref``) at ``_k7b_cases`` (the built
    design's checkpoint interval must be ``kwkv.BWD_CHUNK``), with a
    random cotangent on y and, from a random state, on the final state:
    each of dr, dk, dv, dw, du and dS0 within ``K7B_TOL`` of its norm; a
    second call bit for bit; each checkpoint K7's state over the same
    prefix bit for bit (K7 launched over ``BWD_CHUNK`` steps at a time,
    chained through the state); at ``K7B_F64`` also each gradient against
    an f64 autograd through the plain forward, the f32 plain version's
    own error beside it. Each case timed (CUDA events; the train shape
    also by profiler device time, each kernel's and their sum) beside the
    plain version and the bound: the bytes (r, k, v, w, dy and
    u read, the states where given; dr, dk, dv, dw, du and dS0 written)
    or 14 f32 operations a state element and step (the state recomputed,
    k v then w S + k v; dS's update, r dy then w dS + r dy; the four sums
    of dr, dk, dw and dv, one multiply-add each) and 15 a head element
    and step (a_t, vdy_t and the bonus's terms), at 67 TFLOP/s, the
    larger. No PyTorch call computes it: no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as kwkv
    out = {"design": kwkv.bwd_occupancy()}
    log(f"  K7 backward design: {json.dumps(out['design'])}")
    if out["design"]["C"] != kwkv.BWD_CHUNK:
        raise SystemExit(f"csrc/wkv6_bwd.cu checkpoints every "
                         f"{out['design']['C']} steps, kernels/wkv6.py's "
                         f"BWD_CHUNK is {kwkv.BWD_CHUNK}")
    for i, (name, (B, S, H, state)) in enumerate(
            _k7b_cases(out["design"]).items()):
        t_case = time.perf_counter()
        r, k, v, w, u, s0 = _k7_inputs(B, S, H, 660 + i, state)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(670 + i)
        dy = torch.randn((B, S, H, 64), generator=gen, device="cuda")
        ds = (torch.randn((B, H, 64, 64), generator=gen, device="cuda")
              if state else None)
        args = (r, k, v, w, u, s0, dy, ds)

        def run(args=args):
            return kwkv.wkv6_scan_bwd(*args)

        got = kwkv.wkv6_scan_bwd(*args, checkpoints=True)
        again = kwkv.wkv6_scan_bwd(*args, checkpoints=True)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        ckpt, st = got[6], s0
        ck_ok = bool(torch.equal(ckpt[:, :, 0], torch.zeros_like(
            ckpt[:, :, 0]) if s0 is None else s0))
        with torch.no_grad():
            for c in range(1, ckpt.shape[2]):
                sl = slice(kwkv.BWD_CHUNK * (c - 1), kwkv.BWD_CHUNK * c)
                _, st = kwkv.wkv6_scan(r[:, sl], k[:, sl], v[:, sl],
                                       w[:, sl], u, st)
                ck_ok = ck_ok and bool(torch.equal(st, ckpt[:, :, c]))
        want = ref.wkv6_scan_bwd_ref(*args)
        rec = dict(shape=(B, S, H, 64), from_state=state,
                   checkpoints=ckpt.shape[2], checkpoints_bitwise=ck_ok,
                   repeat_bitwise=bitwise,
                   rel_err={n: _norm_rel(a, b)
                            for n, a, b in zip(K7B_GRADS, got, want)},
                   max_abs_err=max((a - b).abs().max().item()
                                   for a, b in zip(got, want)))
        rec["ok"] = (max(rec["rel_err"].values()) <= K7B_TOL and bitwise
                     and ck_ok)
        if name == K7B_F64:
            t64 = time.perf_counter()
            ins = [t.double().requires_grad_() for t in (r, k, v, w, u, s0)]
            y64, st64 = ref.wkv6_scan_ref(*ins)
            ((y64 * dy.double()).sum() + (st64 * ds.double()).sum()
             ).backward()
            rec["rel_err_f64"] = {n: _norm_rel(a, t.grad) for n, a, t in
                                  zip(K7B_GRADS, got, ins)}
            rec["plain_rel_err_f64"] = {n: _norm_rel(a, t.grad) for n, a, t
                                        in zip(K7B_GRADS, want, ins)}
            rec["f64_s"] = time.perf_counter() - t64
            rec["ok"] = rec["ok"] and max(rec["rel_err_f64"].values()) \
                <= K7B_TOL
            del ins, y64, st64
        del got, want, ckpt, st
        torch.cuda.empty_cache()
        n = B * S * H * 64
        nbytes = 4 * (9 * n + 2 * H * 64 + B * H * 64 * 64
                      * (1 + (2 if state else 0)))
        rec.update(_bound(nbytes, (14.0 * 64 + 15.0) * n))
        if name == "train":
            rec.update(_timed(run, None, lambda a=args:
                              ref.wkv6_scan_bwd_ref(*a), 10))
            rec["device_ms_by_kernel"] = _k7b_split_ms(run, 10)
            log(f"  K7 backward train, device ms a call by kernel: "
                + json.dumps(rec["device_ms_by_kernel"]))
        else:
            ms = [time_ms(run, 10, 2) for _ in range(2)]
            rec.update(ms=min(ms), ms_runs=ms, device_ms=None,
                       plain_ms=time_ms(lambda a=args:
                                        ref.wkv6_scan_bwd_ref(*a), 1, 0),
                       library_ms=None)
        rec.update(plain="ref.wkv6_scan_bwd_ref, one step a loop iteration",
                   library=None, bound_share=rec["bound_ms"] / rec["ms"],
                   case_s=time.perf_counter() - t_case)
        out[name] = rec
        log(f"  K7 backward {name:6s} [{B},{S},{H},64] "
            f"{'random' if state else 'zero'} state: rel err "
            + ", ".join(f"{g} {e:.2e}" for g, e in rec["rel_err"].items())
            + f" {'ok' if rec['ok'] else 'FAIL'}; repeat bitwise "
            f"{bitwise}, {rec['checkpoints']} checkpoints bitwise {ck_ok}; "
            f"kernel {rec['ms']:.3f} ms (device {rec['device_ms']}), plain "
            f"{rec['plain_ms']:.1f} ms; bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} ({100 * rec['bound_share']:.1f}% of it)"
            + (f"; against f64: " + ", ".join(
                f"{g} {e:.2e} (plain {rec['plain_rel_err_f64'][g]:.2e})"
                for g, e in rec["rel_err_f64"].items())
               + f" ({rec['f64_s']:.1f} s)" if "rel_err_f64" in rec else "")
            + f"; {rec['case_s']:.1f} s")
        del args, r, k, v, w, u, s0, dy, ds
        torch.cuda.empty_cache()
    bad = {n: c["rel_err"] for n, c in out.items()
           if n != "design" and not c["ok"]}
    if bad:
        raise SystemExit(f"K7's backward disagrees with its plain version "
                         f"or its contract: {bad}")
    return out


def _k7_device_share(prof, n: int):
    """K7's forward and backward device ms a step in a profile of ``n``
    steps (each kernel's mean duration times its launches a step), and
    every kernel's device us: (k7_fwd_ms, the backward's ms by kernel and
    their sum, total_us)."""
    rows = _device_rows(prof)
    fwd = sum(d / c * max(1, round(c / n)) for d, k, c in rows
              if "wkv6_kernel" in k) / 1e3
    return fwd, _k7b_split(rows, n), sum(d for d, _, _ in rows)


def _dense_run(arch, profiled=False):
    """``repro_torch.launch.train`` on ``arch`` with ``DENSE_TRAIN_ARGS``,
    every kernel counter (K7's forward and backward too) set to 0 just
    before and read just after; with ``profiled`` under torch.profiler.
    Returns (result, launches, K7's device share or None)."""
    import torch
    from repro_torch.kernels import wkv6 as kwkv
    from torch.profiler import ProfilerActivity, profile
    kwkv.wkv6_scan.launches = kwkv.wkv6_scan_bwd.launches = 0
    share = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res, launches, _, _ = _ep_run(["--arch", arch,
                                           *DENSE_TRAIN_ARGS])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        n = len(res["steps"])
        fwd, bwd, total = _k7_device_share(prof, n)
        share = dict(k7_fwd_ms_per_step=fwd,
                     k7_bwd_ms_per_step=bwd["sum"],
                     k7_bwd_ms_per_step_by_kernel=bwd,
                     device_ms_per_step=total / n / 1e3,
                     wall_ms_per_step=wall_us / n / 1e3,
                     k7_share_of_device=(fwd + bwd["sum"]) * n * 1e3 / total
                     if total else None,
                     device_busy_share=total / wall_us)
        del prof
    else:
        res, launches, _, _ = _ep_run(["--arch", arch, *DENSE_TRAIN_ARGS])
    launches.update(wkv6_scan=kwkv.wkv6_scan.launches,
                    wkv6_scan_bwd=kwkv.wkv6_scan_bwd.launches)
    return res, launches, share


def phase_dense_train():
    """Phase 67: rwkv6-3b, internvl2-2b and seamless-m4t-large-v2 at full
    width and depth (random f32 weights from seed 0, bf16 compute, remat
    on) trained through ``repro_torch.launch.train`` with
    ``DENSE_TRAIN_ARGS`` (AdamW, 3 steps, B=4 x 2048: internvl2's batch a
    prefix of 256 slots and 1792 tokens, seamless's over 2048 encoder
    frames): finite losses, step ms, tokens/s and peak memory; rwkv6's K7
    forward launched exactly 2 x 32 a step (each layer's forward and its
    remat recompute), its backward 32 a step (one call a layer, three
    kernels a call), K1-K6 never, and K7 never in the other two; rwkv6
    again from the same seed under torch.profiler, its losses bit for bit
    and K7's share of the step's device time."""
    import statistics
    out = {}
    for arch in DENSE_ARCHS:
        res, launches, _ = _dense_run(arch)
        cfg, steps = res["cfg"], res["steps"]
        n = len(steps)
        want = dict.fromkeys(launches, 0)
        if cfg.ssm is not None:
            want.update(wkv6_scan=cfg.num_layers * (2 if cfg.remat else 1)
                        * n, wkv6_scan_bwd=cfg.num_layers * n)
        info = dict(arch=arch, layers=cfg.num_layers,
                    global_batch=res["global_batch"],
                    seq_len=res["seq_len"], n_params=res["n_params"],
                    losses=[st["loss"] for st in steps],
                    step_ms=[st["step_ms"] for st in steps],
                    tokens_per_s=[st["tokens_per_s"] for st in steps],
                    median_step_ms_after_0=statistics.median(
                        st["step_ms"] for st in steps[1:]),
                    peak_mem_bytes=max(st["peak_mem_bytes"] for st in steps),
                    launches={k: v for k, v in launches.items() if v},
                    launches_ok=launches == want)
        del res, steps
        _free_card()
        log(f"dense train {arch}: " + json.dumps(info))
        if not all(math.isfinite(x) for x in info["losses"]):
            raise SystemExit(f"{arch} losses not finite: {info['losses']}")
        if not info["launches_ok"]:
            raise SystemExit(f"{arch} train launches {launches} differ from "
                             f"what the path calls, {want}")
        out[arch] = info
    res, launches, share = _dense_run(RWKV, profiled=True)
    again = [st["loss"] for st in res["steps"]]
    del res
    _free_card()
    rw = out[RWKV]
    rw.update(repeat_bitwise=again == rw["losses"], profile=share)
    log(f"dense train {RWKV} repeat, same seed, profiled: bit-equal "
        f"{rw['repeat_bitwise']}; " + json.dumps(share))
    if not rw["repeat_bitwise"]:
        raise SystemExit(f"the {RWKV} train run does not repeat: "
                         f"{rw['losses']} then {again}")
    return out


def phase_dense_parity():
    """Phase 68: reduced rwkv6-3b (2 layers, d 256, 4 heads of 64) at f32
    compute, one train step's loss and gradients on the card (K7 and its
    backward, each launched once a layer: the reduced config has no
    remat) against the same parameters on the CPU (the plain versions,
    differentiated by autograd): loss within 1e-5, every gradient leaf
    within 1e-4 of its norm."""
    import torch
    from repro_torch.config import LuffyConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    B, S = DENSE_PARITY["B"], DENSE_PARITY["S"]
    cfg = dataclasses.replace(reduced(get_config(RWKV)),
                              compute_dtype="float32")
    batch = SyntheticLM(cfg, ShapeConfig("train", S, B, "train")).batch(0)
    model = build_model(cfg, device="cuda", seed=68)
    res = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            model.to("cpu")     # the same parameters, moved
        k7 = (kwkv.wkv6_scan.launches, kwkv.wkv6_scan_bwd.launches)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, _, _, grads = _train_step_once(
            model, tb, 8, luffy, torch.tensor(0.5, device=dev))
        res[dev] = dict(loss=loss, grads=[g.cpu() for g in grads],
                        k7=(kwkv.wkv6_scan.launches - k7[0],
                            kwkv.wkv6_scan_bwd.launches - k7[1]))
    del model
    _free_card()
    a, b = res["cuda"], res["cpu"]
    errs = [_norm_rel(x, y) for x, y in zip(a["grads"], b["grads"])]
    info = dict(B=B, S=S, loss_card=a["loss"], loss_cpu=b["loss"],
                loss_abs_err=abs(a["loss"] - b["loss"]),
                grad_leaves=len(errs), grad_max_rel_err=max(errs),
                k7_launches_card=a["k7"], k7_launches_cpu=b["k7"],
                k7_launches_expected=(cfg.num_layers, cfg.num_layers))
    log("reduced rwkv6 train step, card against CPU: " + json.dumps(info))
    if not (info["loss_abs_err"] <= DENSE_PARITY_TOL["loss"]
            and info["grad_max_rel_err"] <= DENSE_PARITY_TOL["grad"]
            and tuple(a["k7"]) == info["k7_launches_expected"]
            and tuple(b["k7"]) == (0, 0)):
        raise SystemExit("reduced rwkv6 train step, card against CPU: "
                         + json.dumps(info))
    return info


def run_dense_train_phases():
    """Phases 66-68 in order."""
    return {"kernels": phase_k7_bwd(), "train": phase_dense_train(),
            "parity": phase_dense_parity()}


def _dense_train_records(dt):
    """K7's backward's record: timed at the train step's shape from the
    zero state, with its launches in phase 67's first rwkv6 run."""
    k, tr = dt["kernels"], dt["train"][RWKV]
    t = k["train"]
    return [_record(
        "wkv6_scan_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
        "src/repro/models/ssm.py:177 (no Pallas kernel; XLA differentiates "
        "_rwkv6_core's lax.scan)", tr["launches"]["wkv6_scan_bwd"],
        dict(t, max_abs_err=max(c["max_abs_err"] for n, c in k.items()
                                if n != "design")),
        {"timed_at": "[4,2048,40,64] f32 from the zero state, y's "
                     "cotangent alone (rwkv6-3b's train step)",
         "launches_path": f"{RWKV} train at 32 layers, 3 AdamW steps of "
                          f"4 x 2048 (one call a layer a step, three kernels "
                          f"a call)",
         "launches_forward_same_run": tr["launches"]["wkv6_scan"],
         "device_ms": t["device_ms"], "bound_share": t["bound_share"],
         "device_ms_by_kernel": t["device_ms_by_kernel"],
         "plain": t["plain"], "library": "none (no PyTorch call computes "
                                         "WKV6's backward)",
         "design": k["design"],
         "rel_err_f64": k[K7B_F64]["rel_err_f64"],
         "plain_rel_err_f64": k[K7B_F64]["plain_rel_err_f64"],
         "train_step_k7_share": tr["profile"],
         "cases": {n: {x: c[x] for x in ("shape", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "rel_err",
                                         "checkpoints_bitwise")}
                   for n, c in k.items() if n != "design"}})]


# phase 54: the tensor-core kernel's band, and the same band starting
# one key tile late where the window has moved past the sequence's start
K5_BAND_LINE = ("  const int lo = window > 0 ? max(0, q0 - window + 1) / BKT : "
                "0;")
K5_BAND_LATE = ("  const int lo = window > 0 ? max(0, q0 - window + 1) / BKT "
                "+ (q0 >= window) : 0;")


def phase_k5_gate_mutant():
    """Phase 54 (``--only``): phase 49's K5 gates against a K5 that is
    wrong by one key tile. ``csrc/flash_attn.cu`` is compiled again, in a
    temporary directory, with ``K5_BAND_LATE`` for the tensor-core
    kernel's band, and both builds are held to ``_k5_check`` at the
    windowed arch shapes of ``K5_ARCH_SHAPES``. Passes when the real
    kernel passes and the row gate rejects the wrong one at every
    shape; records whether the elementwise gate alone would have."""
    import ctypes
    import tempfile
    import torch
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attn.cu").read_text()
    if src.count(K5_BAND_LINE) != 1:
        raise SystemExit("phase 54: the band line of csrc/flash_attn.cu "
                         "moved; update K5_BAND_LINE")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(54)
    real = _build.load("flash_attn")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "flash_attn.cu"
        cu.write_text(src.replace(K5_BAND_LINE, K5_BAND_LATE))
        lib = Path(tmp) / "libflash_attn_late.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-o", str(lib), str(cu)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"phase 54: nvcc failed:\n{r.stdout}{r.stderr}")
        late = ctypes.CDLL(str(lib))
        for name, (B, S, H, KV, hd, window) in K5_ARCH_SHAPES.items():
            if window is None:
                continue
            q, k, v = [torch.randn(sh, generator=gen, device="cuda")
                       .to(torch.bfloat16) for sh in
                       ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
            rec = {"real": _k5_check(q, k, v, True, window)}
            _build._LIBS["flash_attn"] = late
            try:
                rec["band_late"] = _k5_check(q, k, v, True, window)
            finally:
                _build._LIBS["flash_attn"] = real
            out[name] = rec
            log(f"  K5 gate, {name} [{B},{S},{H},{hd}] window {window}: "
                + json.dumps(rec))
            del q, k, v
            torch.cuda.empty_cache()
    bad = [n for n, r in out.items() if not r["real"]["ok"]
           or r["band_late"]["max_row_rel_err"] <= r["band_late"]["row_tol"]]
    if bad:
        raise SystemExit(f"phase 54: the gates do not tell K5 from its "
                         f"late-band build at {bad}: {out}")
    return out


def phase_prefill_attn_compare(rounds: int = 6):
    """Phase 55 (``--only``): the serve prefill with its attention core on
    K5 against the same prefill on ``attend`` (the engine's own path,
    with ``flash_takes`` answering no), random weights from seed 0, bf16
    compute, for moe-gpt2 (12 layers, B=8 x 128), moe-transformerxl (18,
    B=8 x 256) and olmoe-1b-7b cut to 4 layers (B=4 x 2048). Each round
    times one prefill of each path to a synchronise, K5's first in even
    rounds and second in odd ones; then one of each under the profiler
    (device ms, K5's device ms). The last-token logits of the two paths
    are compared, in bf16 and again with the same weights at f32 compute
    (K5's FMA route against ``attend`` in f32), where no bf16 rounding
    can move a token to another expert."""
    import statistics
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import LuffyConfig
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as bk
    from repro_torch.models.model import build_model
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False)
    takes = bk.flash_takes

    def dev_ms(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(ev.self_device_time_total / 1e3, ev.key)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        return (sum(r[0] for r in rows),
                sum(ms for ms, key in rows if "flash_" in key))

    out = {}
    for arch, layers, B, S in (("moe-gpt2", 12, 8, 128),
                               ("moe-transformerxl", 18, 8, 256),
                               ("olmoe-1b-7b", 4, 4, 2048)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        model = build_model(cfg, device="cuda", seed=0)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (B, S)), dtype=torch.int32, device="cuda")

        def run(k5: bool):
            bk.flash_takes = takes if k5 else (lambda cfg: False)
            try:
                return model.prefill(toks, S, luffy=luffy)[0]
            finally:
                bk.flash_takes = takes

        lg = {k5: run(k5) for k5 in (True, False)}        # warm-up
        ms = {True: [], False: []}
        for r in range(rounds):
            for k5 in ((True, False) if r % 2 == 0 else (False, True)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(k5)
                torch.cuda.synchronize()
                ms[k5].append((time.perf_counter() - t0) * 1e3)
        dev = {k5: dev_ms(lambda: run(k5)) for k5 in (True, False)}
        rec = {"layers": layers, "batch": B, "prompt_len": S}
        for k5, name in ((True, "k5"), (False, "attend")):
            med = statistics.median(ms[k5])
            rec[name] = dict(wall_ms=ms[k5], median_wall_ms=med,
                             tokens_per_s=B * S / med * 1e3,
                             device_ms=dev[k5][0], k5_device_ms=dev[k5][1])
        rec["logits_max_abs_diff"] = (lg[True] - lg[False]).abs().max().item()
        rec["logits_max_abs"] = lg[False].abs().max().item()
        rec["k5_faster_in_rounds"] = sum(
            a < b for a, b in zip(ms[True], ms[False]))
        del model, lg
        _free_card()
        model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                            device="cuda", seed=0)
        lg = {k5: run(k5) for k5 in (True, False)}
        rec["f32_logits_max_abs_diff"] = (lg[True] - lg[False]).abs().max(
        ).item()
        rec["f32_logits_max_abs"] = lg[False].abs().max().item()
        out[arch] = rec
        log(f"prefill attention {arch}: " + json.dumps(rec))
        del model, lg
        _free_card()
    return out


def _record(name, source, replaces, launches, t, extra=None):
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": t["max_abs_err"], "ms": t["ms"],
           "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
    rec.update(extra or {})
    return rec


def _paper_records(paper):
    """The kernels' records at the paper models' width: launches from
    moe-bert-large's full-width train run (K1-K3) and its expert-parallel
    run (K4), everything else measured by phase 23."""
    k = paper["kernels"]
    bl = paper["train"]["moe-bert-large"]["launches"]
    tl = paper["train"]["moe-transformerxl"]["launches"]
    el = paper["ep"]["launches"]
    at = f"d {PAPER_D}, F {PAPER_F}, 16 experts"

    def rec(kernel, source, replaces, path, t, timed_at, **kw):
        ep = path == "ep"
        return _record(f"{kernel}@d{PAPER_D}", source, replaces,
                       (el if ep else bl)[kernel], t,
                       dict(kernel=kernel, timed_at=f"{timed_at} ({at})",
                            launches_path=(
                                "moe-bert-large, 4 layers, EP f8 wire with "
                                "error feedback, 4 steps" if ep else
                                "moe-bert-large full-width train, 6 steps"),
                            launches_moe_transformerxl=tl[kernel],
                            device_ms=t["device_ms"], **kw))

    return [
        rec("expert_ffn", "src/repro_torch/csrc/expert_ffn.cu",
            "src/repro/kernels/expert_ffn.py:52", "train", k["expert_ffn"],
            "[16,1024,1024]x4096, bf16 h, f32 weights, gelu",
            library="torch.bmm f32 on the same inputs",
            library_bf16_ms=k["expert_ffn"]["library_bf16_ms"],
            checks=k["expert_ffn"]["checks"]),
        rec("expert_ffn_bwd", "src/repro_torch/csrc/expert_ffn_bwd.cu",
            "src/repro/kernels/expert_ffn.py:52 (no Pallas backward)",
            "train", k["expert_ffn_bwd"],
            "[16,1024,1024]x4096, bf16 h and dy, f32 weights",
            library="torch.bmm f32 composite on the same inputs",
            library_bf16_ms=k["expert_ffn_bwd"]["library_bf16_ms"],
            fma_ms=k["expert_ffn_bwd"]["fma_ms"],
            checks=k["expert_ffn_bwd"]["checks"]),
        rec("masked_similarity_fused", "src/repro_torch/csrc/similarity.cu",
            "src/repro/kernels/similarity.py:81", "train",
            k["masked_similarity_fused"],
            "32 groups of [128,1024] bf16, a carried s_prev"),
        rec("gather_rows", "src/repro_torch/csrc/condense.cu",
            "src/repro/kernels/condense.py:26", "train", k["gather_rows"],
            "[4096,1024] bf16, 9 reps per group",
            library="torch.index_select"),
        rec("gather_rows_bwd", "src/repro_torch/csrc/condense.cu",
            "src/repro/kernels/condense.py:26 (no Pallas backward)", "train",
            k["gather_rows_bwd"], "[4096,1024] bf16, the group-local entry",
            library="index_add_ into zeros"),
        rec("pack_quant", "src/repro_torch/csrc/pack.cu",
            "src/repro/kernels/pack.py:72", "ep", k["pack_quantize_f8"],
            "[4096,1024] bf16 -> f8 wire rows",
            library="index_select, then the codec"),
        rec("pack_quant_bwd", "src/repro_torch/csrc/pack.cu",
            "src/repro/kernels/pack.py:72 (no Pallas backward)", "ep",
            k["pack_quantize_bwd"], "f8 wire rows of 1024, bf16 cotangents"),
    ]



def _arch_records(arch):
    """K5 at each item-8.1 arch's prefill shape (phase 49) with the
    launches of that arch's serve run (phase 50: two batched prefills),
    and K1 at olmoe's prefill shape with the launches of its serve,
    EP serve and train runs."""
    k5, sv = arch["kernels"]["k5"], arch["serve"]
    recs = []
    for name, t in k5.items():
        a = name.replace("-local", "").replace("-global", "")
        recs.append(_record(
            f"flash_attention@{name}", "src/repro_torch/csrc/flash_attn.cu",
            "src/repro/kernels/flash_attn.py:87",
            sv[a]["launches"]["flash_attention"], t,
            {"kernel": "flash_attention",
             "timed_at": f"{list(t['shape'])} (B, S, H, KV, hd) bf16, "
                         f"causal, window {t['window']}",
             "launches_path": f"{a} serve at {sv[a]['layers']} layers, 2 "
                              f"batched prefills (every layer's, gemma3's "
                              f"local and global together)",
             "dispatch": t["route"], "device_ms": t["device_ms"],
             "library": "F.scaled_dot_product_attention, same band mask",
             "library_error": t["library_error"],
             "bound_share": t["bound_share"],
             "tflops_live": t["tflops_live"],
             "repeat_bitwise": t["repeat_bitwise"],
             "plain": t["plain"]}))
    k1 = arch["kernels"]["k1"]["prefill"]
    recs.append(_record(
        "expert_ffn@olmoe-1b-7b", "src/repro_torch/csrc/expert_ffn.cu",
        "src/repro/kernels/expert_ffn.py:52",
        sv["olmoe-1b-7b"]["launches"]["expert_ffn"], k1,
        {"kernel": "expert_ffn",
         "timed_at": f"olmoe's prefill [64,{K1_OLMOE_SHAPES['prefill']},"
                     f"2048]x1024 (B=4 x 2048 tokens, top-8), bf16 h, f32 "
                     f"weights (warm bf16 cache), silu; bound at bf16 "
                     f"weights",
         "launches_path": "olmoe-1b-7b serve, 16 layers, 2 batched "
                          "prefills",
         "launches_decode": sv["olmoe-1b-7b"]["decode_launches"][
             "expert_ffn"],
         "launches_ep_serve": arch["ep"]["m4"]["launches"]["expert_ffn"],
         "launches_train": arch["train"]["launches"]["expert_ffn"],
         "dispatch": k1["route"], "device_ms": k1["device_ms"],
         "library": "torch.bmm f32 on the same inputs",
         "library_bf16_ms": k1["library_bf16_ms"],
         "bound_share": k1["bound_share"],
         "decode_shape": arch["kernels"]["k1"]["decode"]}))
    return recs

PHASE_S: dict = {}


def _time_phases():
    """Wrap every module-level ``phase_*`` function so that its wall
    seconds add up in ``PHASE_S`` (a phase that calls another counts the
    inner one's time too)."""
    import functools

    def timed(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                PHASE_S[fn.__name__] = PHASE_S.get(fn.__name__, 0.0) \
                    + time.perf_counter() - t
        return run

    g = globals()
    for n in [n for n in g if n.startswith("phase_") and callable(g[n])]:
        g[n] = timed(g[n])


def _only_runners():
    """Phase number -> a runner taking ``need`` (which runs a phase once
    and returns its result), for ``--only``. A phase that reads another's
    result runs that one first; the rest run alone."""
    def serve_ep(need):
        return phase_ep_serve(need(4)[1])

    def reuse(need):
        return (phase_reuse_kernels(), phase_reuse_ep(need(11), need(14)),
                phase_reuse_guarantee(), phase_reuse_parity())

    plain = {
        3: lambda: (phase_kernels(), phase_kernels_train()),
        4: phase_slice, 5: phase_parity, 6: phase_profile, 7: phase_train,
        8: phase_train_parity, 9: phase_train_profile,
        10: phase_kernels_k4, 11: phase_ep_train, 12: phase_ep_bf16,
        13: phase_ep_parity, 14: phase_ep_profile, 15: phase_kernels_k56,
        16: phase_hymba_slice, 17: phase_hymba_paths,
        18: phase_hymba_profile, 20: phase_ep_serve_parity,
        21: phase_seq_train, 23: phase_paper_kernels,
        24: phase_paper_train, 25: phase_paper_serve, 26: phase_paper_ep,
        27: phase_paper_parity, 28: phase_paper_ep_parity,
        29: phase_paper_profile, 30: phase_sched_kernels,
        31: phase_sched_ep_dense, 32: phase_sched_ep_dedup,
        33: phase_sched_serve, 34: phase_sched_parity,
        35: phase_sched_profile, 36: phase_k1_lanes,
        37: phase_replicate_ep, 38: phase_replicate_parity,
        39: phase_overlap_ep, 40: phase_plan_cache_serve,
        41: phase_continuous_serve, 42: phase_recycled_slot,
        44: phase_checkpoint}
    runners = {n: (lambda need, fn=fn: fn()) for n, fn in plain.items()}
    runners.update({19: serve_ep, 22: reuse,
                    43: lambda need: phase_traced_ep(need(11), need(14)),
                    45: lambda need: phase_calibrate(),
                    46: lambda need: phase_tuned_train(need(45)),
                    47: lambda need: phase_traced_probe(need(45)),
                    48: lambda need: phase_tuned_serve_dryrun(need(45)),
                    49: lambda need: phase_arch_kernels(),
                    50: lambda need: phase_arch_serve(),
                    51: lambda need: phase_arch_parity(),
                    52: lambda need: phase_olmoe_ep_serve(),
                    53: lambda need: phase_olmoe_train(),
                    54: lambda need: phase_k5_gate_mutant(),
                    55: lambda need: phase_prefill_attn_compare(),
                    56: lambda need: phase_llama4_kernels(),
                    57: lambda need: phase_llama4_serve(),
                    58: lambda need: phase_llama4_parity(),
                    59: lambda need: phase_llama4_ep_serve(),
                    60: lambda need: phase_seamless_kernels(),
                    61: lambda need: phase_seamless_serve(),
                    62: lambda need: phase_seamless_parity(),
                    63: lambda need: phase_rwkv_kernels(),
                    64: lambda need: phase_rwkv_serve(),
                    65: lambda need: phase_rwkv_parity(),
                    66: lambda need: phase_k7_bwd(),
                    67: lambda need: phase_dense_train(),
                    68: lambda need: phase_dense_parity()})
    return runners


def run_only(phases) -> int:
    """Phases 1 and 2 (the card, the build), then ``phases`` in the order
    given, each with the phases whose results it reads; ends with
    ``DONE``."""
    runners = _only_runners()
    unknown = sorted(set(phases) - set(runners) - {1, 2})
    if unknown:
        raise SystemExit(f"--only: no phase {unknown}; phases "
                         f"{sorted(runners)}")
    t_start = time.perf_counter()
    _, _, smi = phase_device()
    phase_build()
    done = {}

    def need(n):
        if n not in done:
            t = time.perf_counter()
            done[n] = runners[n](need)
            log(f"phase {n}: {time.perf_counter() - t:.1f}s")
        return done[n]

    for n in phases:
        if n not in (1, 2):
            need(n)
    log(f"total {time.perf_counter() - t_start:.1f}s on {smi}")
    print("DONE", flush=True)
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module docstring).")
    ap.add_argument("--only", nargs="+", type=int, metavar="PHASE",
                    help="run phases 1 and 2, then only these (and the "
                         "phases whose results they read); prints DONE, "
                         "not the kernels line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    _time_phases()
    if args.only:
        return run_only(args.only)
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    _, tc_ptxas = phase_build()
    log("kernels:")
    checks, timed = phase_kernels()
    timed_train = phase_kernels_train()
    timed_k4 = phase_kernels_k4()
    # phase 23 runs here, beside the kernels' other checks: late in a
    # long process the profiler drops launches from its records
    log("kernels at the paper width (phase 23):")
    paper_kernels = phase_paper_kernels()
    # slice 17's phases run here, on a card the earlier phases have not
    # filled (yi-34b's weights alone take 68.8e9 B) and while the profiler
    # still records every launch
    log("the attention decoders of item 8.1 (phases 49-53):")
    arch = run_arch_phases()
    log("llama4-maverick and internvl2-2b (phases 56-59):")
    l4 = run_llama4_phases()
    log("the encoder-decoder seamless-m4t-large-v2 (phases 60-62):")
    sm = run_seamless_phases()
    log("the attention-free rwkv6-3b (phases 63-65):")
    rw = run_rwkv_phases()
    log("training the dense f32 archs, K7's backward (phases 66-68):")
    dense = run_dense_train_phases()
    slice_info, slice_out = phase_slice()
    phase_parity()
    serve_prof = phase_profile()
    train_info = phase_train()
    phase_train_parity()
    phase_train_profile()
    ep_info = phase_ep_train()
    ep_bf16 = phase_ep_bf16()
    phase_ep_parity()
    ep_prof = phase_ep_profile()
    # the pipelined executor's phases run here, where the profiler still
    # records every launch (phase 33 follows phase 19)
    log("pipelined executor:")
    sched_k1 = phase_sched_kernels()
    sched_dense = phase_sched_ep_dense()
    sched_dedup = phase_sched_ep_dedup(ep_info)
    phase_sched_parity()
    sched_prof = phase_sched_profile()
    # slice 14's phases run here too, where the profiler still records
    # every launch
    objective = run_objective_phases()
    log("continuous batching, slot recycling, tracing, checkpoints:")
    continuous = phase_continuous_serve(slice_info)
    phase_recycled_slot()
    phase_traced_ep(ep_info, ep_prof)
    phase_checkpoint()
    log("calibration, autotuning, the traced probe, the dry run:")
    tuning = run_tuning_phases()
    log("kernels K5, K6:")
    timed_k56 = phase_kernels_k56()
    hymba_info = phase_hymba_slice()
    phase_hymba_paths()
    hymba_prof = phase_hymba_profile()
    ep_serve = phase_ep_serve(slice_out)
    del slice_out
    sched_serve = phase_sched_serve(ep_serve.pop("sync"))
    phase_ep_serve_parity()
    seq_train = phase_seq_train()
    log("reuse and lsh:")
    timed_lsh = phase_reuse_kernels()
    reuse_ep = phase_reuse_ep(ep_info, ep_prof)
    phase_reuse_guarantee()
    phase_reuse_parity()
    paper = run_paper_phases(paper_kernels)
    log("serve M=1 vs M=4: " + json.dumps({
        "prefill_tok_s": [slice_info["prefill_tok_s"],
                          ep_serve["prefill_tok_s"]],
        "decode_ms_per_step": [slice_info["decode_ms_per_step"],
                               ep_serve["decode_ms_per_step"]],
        "prefill_device_busy_share": [
            serve_prof["prefill"]["device_busy_share"],
            ep_serve["profile"]["prefill"]["device_busy_share"]],
        "decode_device_busy_share": [
            serve_prof["decode_step"]["device_busy_share"],
            ep_serve["profile"]["decode_step"]["device_busy_share"]]}))
    hl = hymba_info["launches"]
    el = ep_info["launches"]
    tl = train_info["launches"]
    k1 = dict(timed["train"], max_abs_err=max(
        c["max_abs_err"] for c in checks if c["shape"] == "train"))
    k1b = timed_train["expert_ffn_bwd"]
    records = [
        _record("expert_ffn", "src/repro_torch/csrc/expert_ffn.cu",
                "src/repro/kernels/expert_ffn.py:52", tl["expert_ffn"], k1,
                {"launches_by_path": {"serve": slice_info["k1_launches"],
                                      "train": tl["expert_ffn"],
                                      "seq_sharded_train":
                                          seq_train["launches"]["expert_ffn"]},
                 "launches_ep_serve": ep_serve["launches"]["expert_ffn"],
                 "launches_continuous_serve": continuous["launches"][
                     "expert_ffn"],
                 "launches_calibration_probe": tuning["calibrate"][
                     "launches"]["expert_ffn"],
                 "calibration_probe_ms": tuning["calibrate"]["info"][
                     "k1_probe_ms"],
                 "calibration_probe_shape_ms": arch["kernels"]["k1_probe"][
                     "ms"],
                 "calibration_probe_library_bf16_ms": arch["kernels"][
                     "k1_probe"]["library_bf16_ms"],
                 "launches_arch_paths": {
                     "olmoe-1b-7b serve": arch["serve"]["olmoe-1b-7b"][
                         "launches"]["expert_ffn"],
                     "olmoe-1b-7b EP serve": arch["ep"]["m4"]["launches"][
                         "expert_ffn"],
                     "olmoe-1b-7b train": arch["train"]["launches"][
                         "expert_ffn"]},
                 "timed_at": "train shape [16,2048,768]x3072, bf16 h, f32 "
                             "weights read through the warm bf16 cache "
                             "(the tensor-core route), gelu; bound at bf16 "
                             "weights",
                 "dispatch": k1["route"], "cast_ms": k1["cast_ms"],
                 "device_ms": k1["device_ms"],
                 "library": "torch.bmm f32 on the same inputs",
                 "library_bf16_ms": k1["library_bf16_ms"],
                 "bound_f32_weights_ms": k1["bound_f32_weights_ms"],
                 "bound_share": k1["bound_share"],
                 "ptxas_tensor_core_kernel": tc_ptxas["K1"],
                 "max_abs_err_all_checks": max(c["max_abs_err"]
                                               for c in checks),
                 "shapes": timed}),
        _record("expert_ffn_bwd", "src/repro_torch/csrc/expert_ffn_bwd.cu",
                "src/repro/kernels/expert_ffn.py:52 (no Pallas backward; "
                "XLA differentiates the reference)", tl["expert_ffn_bwd"],
                k1b,
                {"timed_at": "train shape [16,2048,768]x3072, bf16 h and "
                             "dy, f32 weights (their bf16 terms cached), "
                             "gelu; bound at the bf16 tensor-core rate",
                 "dispatch": k1b["route"], "device_ms": k1b["device_ms"],
                 "fma_ms": k1b["fma_ms"],
                 "library": "torch.bmm f32 composite on the same inputs",
                 "library_bf16_ms": k1b["library_bf16_ms"],
                 "bound_issued_ms": k1b["bound_issued_ms"],
                 "bound_share": k1b["bound_share"],
                 "ptxas_tensor_core_kernel": tc_ptxas["K1_bwd"],
                 "max_abs_err_all_checks": max(
                     c["max_abs_err"] for c in k1b["checks"]),
                 "max_model_rel_err": max(
                     c.get("model_rel_err", 0.0) for c in k1b["checks"])}),
        _record("masked_similarity", "src/repro_torch/csrc/similarity.cu",
                "src/repro/kernels/similarity.py:81",
                tl["masked_similarity"], timed_train["masked_similarity"],
                {"launches_note": "both entries; on the train and EP paths "
                                  "every launch is the fused entry's",
                 "timed_at": "64 groups of [128,768] bf16 rows, the "
                             "contract entry (a mask); bound at the bf16 "
                             "tensor-core rate",
                 **{k: timed_train["masked_similarity"][k] for k in (
                     "device_ms", "route", "tile", "bound_share_device",
                     "bound_f32_ms", "device_ms_f32_route", "live_groups",
                     "checks")},
                 "ptxas_tensor_core_kernel": tc_ptxas["K2"]}),
        _record("masked_similarity_fused",
                "src/repro_torch/csrc/similarity.cu",
                "src/repro/kernels/similarity.py:81",
                tl["masked_similarity_fused"],
                timed_train["masked_similarity_fused"],
                {"fuses": "the skip rules of src/repro/condense/"
                          "backends.py:131-158 (fast_similarity)",
                 "launches_calibration_probe": tuning["calibrate"][
                     "launches"]["masked_similarity_fused"],
                 "calibration_probe_ms": tuning["calibrate"]["info"][
                     "k2_probe_ms"],
                 "timed_at": "64 groups of [128,768] bf16 rows, strided "
                             "int64 expert ids, a carried s_prev; bound at "
                             "the bf16 tensor-core rate",
                 **{k: timed_train["masked_similarity_fused"][k] for k in (
                     "device_ms", "route", "tile", "bound_share_device",
                     "live_groups", "checks")}}),
        _record("gather_rows", "src/repro_torch/csrc/condense.cu",
                "src/repro/kernels/condense.py:26", tl["gather_rows"],
                timed_train["gather_rows"],
                {"timed_at": "[8192,768] bf16 rows, the path's map (9 "
                             "representatives per group of 128)",
                 "library": "torch.index_select",
                 **{k: timed_train["gather_rows"][k] for k in (
                     "device_ms", "library_device_ms", "source_rows",
                     "bitwise")},
                 "ptxas": tc_ptxas["K3"]}),
        _record("gather_rows_bwd", "src/repro_torch/csrc/condense.cu",
                "src/repro/kernels/condense.py:26 (no Pallas backward; XLA "
                "transposes the reference's gather)", tl["gather_rows_bwd"],
                timed_train["gather_rows_bwd"],
                {"timed_at": "[8192,768] bf16 rows, 9 representatives per "
                             "group of 128, the group-local entry the path "
                             "takes (general_ms: the general entry with its "
                             "sort)",
                 **{k: timed_train["gather_rows_bwd"][k] for k in (
                     "general_ms", "device_ms", "general_device_ms",
                     "library_device_ms", "bitwise")}}),
        _record("pack_quantize_f8", "src/repro_torch/csrc/pack.cu",
                "src/repro/kernels/pack.py:72", el["pack_quant"],
                timed_k4["pack_quantize_f8"],
                {"launches_path": "EP train, --wire-dtype f8e4m3",
                 "timed_at": "[8192,768] bf16 rows -> 4x2x2048 wire rows",
                 **{k: timed_k4["pack_quantize_f8"][k] for k in (
                     "device_ms", "host_us", "bound_share_device")},
                 "ptxas": tc_ptxas["K4"]}),
        _record("pack_quantize_cast", "src/repro_torch/csrc/pack.cu",
                "src/repro/kernels/pack.py:105",
                ep_bf16["launches"]["pack_cast"],
                timed_k4["pack_quantize_cast"],
                {"launches_path": "EP train, --wire-dtype bf16",
                 "timed_at": "[8192,768] bf16 rows -> 4x2x2048 bf16 wire "
                             "rows",
                 **{k: timed_k4["pack_quantize_cast"][k] for k in (
                     "device_ms", "host_us", "bound_share_device")}}),
        _record("pack_quantize_bwd", "src/repro_torch/csrc/pack.cu",
                "src/repro/kernels/pack.py:72 (no Pallas backward; XLA "
                "transposes the reference's jnp codec)",
                el["pack_quant_bwd"], timed_k4["pack_quantize_bwd"],
                {"launches_path": "EP train, --wire-dtype f8e4m3",
                 "timed_at": "4x2x2048 bf16 cotangent rows of 768",
                 "device_ms": timed_k4["pack_quantize_bwd"]["device_ms"],
                 "ptxas": tc_ptxas["K4_bwd"],
                 "max_abs_err_by_cotangent_scale": {
                     f"{g:g}": e for g, e in
                     timed_k4["pack_quantize_bwd"]["errs"].items()}}),
        _record("flash_attention", "src/repro_torch/csrc/flash_attn.cu",
                "src/repro/kernels/flash_attn.py:87", hl["flash_attention"],
                timed_k56["flash_attention"],
                {"launches_path": "hymba-1.5b serve, 2 batched prefills",
                 # since slice 17 every decoder's batched prefill on the
                 # card attends on K5
                 "launches_serve_prefills": {
                     "moe-gpt2": slice_info["launches"]["flash_attention"],
                     "moe-gpt2 EP": ep_serve["launches"]["flash_attention"],
                     "moe-gpt2 EP pipelined": sched_serve["launches"][
                         "flash_attention"],
                     "moe-transformerxl": paper["serve"]["launches"][
                         "flash_attention"],
                     **{a: arch["serve"][a]["launches"]["flash_attention"]
                        for a in ARCH_SERVE}},
                 "timed_at": "[4,2048,25,64] bf16, 5 KV heads, causal, "
                             "window 1024",
                 "bound_f32_ms": timed_k56["flash_attention"]["bound_f32_ms"],
                 "library": "F.scaled_dot_product_attention, same band mask",
                 "tflops_live": timed_k56["flash_attention"]["tflops_live"],
                 "bound_share": timed_k56["flash_attention"]["bound_share"],
                 "ptxas_tensor_core_kernel": tc_ptxas["K5"],
                 "prefill_share": hymba_prof["kernel_share"][
                     "flash_attention"],
                 "checks": timed_k56["flash_attention"]["checks"]}),
        _record("mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
                "src/repro/kernels/mamba_scan.py:66", hl["mamba_scan"],
                timed_k56["mamba_scan"],
                {"launches_path": "hymba-1.5b serve, 2 batched prefills "
                                  "(every launch through the fused entry)",
                 "timed_at": "[4,2048,3200]x16 f32, the contract entry",
                 **{k: timed_k56["mamba_scan"][k] for k in _K6_KEYS},
                 "ptxas": tc_ptxas["K6"],
                 "checks": timed_k56["mamba_scan"]["checks"]}),
        _record("mamba_scan_fused", "src/repro_torch/csrc/mamba_scan.cu",
                "src/repro/kernels/mamba_scan.py:66",
                hl["mamba_scan_fused"], timed_k56["mamba_scan_fused"],
                {"launches_path": "hymba-1.5b serve, 2 batched prefills",
                 "fuses": "the f32 passes around the scan, softplus "
                          "(src/repro/models/ssm.py:72), skip and gate "
                          "(:104-106)",
                 "timed_at": "[4,2048,3200]x16, bf16 x, z and y, f32 "
                             "dt_lin; max_abs_err of the f32 checks",
                 **{k: timed_k56["mamba_scan_fused"][k] for k in _K6_KEYS},
                 "prefill_share": hymba_prof["kernel_share"]["mamba_scan"],
                 "prefill_tokens_per_s": hymba_prof["tokens_per_s"],
                 "checks": timed_k56["mamba_scan_fused"]["checks"]}),
        _record("masked_similarity_fused_lsh",
                "src/repro_torch/csrc/similarity.cu",
                "src/repro/kernels/similarity.py:81",
                reuse_ep["launches"]["masked_similarity_fused_lsh"],
                timed_lsh,
                {"fuses": "the skip rules and the lsh backend's bucket "
                          "restriction of src/repro/condense/backends.py:"
                          "87-158 (the CODES instances)",
                 "launches_path": "EP train with " + " ".join(REUSE_FLAGS),
                 "timed_at": "64 groups of [128,768] bf16 rows, strided "
                             "int64 expert ids, a carried s_prev, codes at "
                             "bits 8; bound at the bf16 tensor-core rate",
                 **{k: timed_lsh[k] for k in (
                     "device_ms", "device_ms_in_turns", "route", "tile",
                     "bound_share_device", "live_groups", "computed_tiles",
                     "measured_share", "checks", "ptxas")}}),
    ]
    for rec in records[:6]:
        rec["launches_ep_train"] = el[rec["name"]]
    records.insert(1, _record(
        "expert_ffn@chunk", "src/repro_torch/csrc/expert_ffn.cu",
        "src/repro/kernels/expert_ffn.py:52",
        sched_dense["launches"]["expert_ffn"], sched_k1,
        {"kernel": "expert_ffn",
         "timed_at": f"the pipelined dense wire's chunk [16,{SCHED_K1_R},768]"
                     f"x3072 (4 ranks x {SCHED_CAPACITY // SCHED_CHUNKS} of "
                     f"the capacity {SCHED_CAPACITY}), bf16 h, f32 weights "
                     f"(warm bf16 cache), gelu; bound at bf16 weights",
         "launches_path": f"EP train, dense hier wire, --exec-mode pipeline "
                          f"--pipeline-chunks {SCHED_CHUNKS}, 2 steps",
         "launches_dedup_pipeline": sched_dedup["launches"]["expert_ffn"],
         "launches_ep_serve_pipeline": sched_serve["launches"]["expert_ffn"],
         "dispatch": sched_k1["route"], "device_ms": sched_k1["device_ms"],
         "library": "torch.bmm f32 on the same inputs",
         "library_bf16_ms": sched_k1["library_bf16_ms"],
         "bound_share": sched_k1["bound_share"],
         "rows_bitwise": sched_k1["rows_bitwise"],
         "profile_k1_overlap_share": sched_prof["k1_overlap_share"]}))
    lanes = objective["lanes"]
    rl = objective["replicate"]["launches"]
    lane_at = (f"the replicate EP shape [20,2048,768]x3072 over the "
               f"16-expert stack, map {list(LANE_MAP)} "
               f"({lanes['live_groups']} live groups), bf16 h, f32 weights "
               f"(warm bf16 cache), gelu; bound counts the live groups")
    records[2:2] = [
        _record("expert_ffn@lanes", "src/repro_torch/csrc/expert_ffn.cu",
                "src/repro/kernels/expert_ffn.py:52", rl["expert_ffn_lanes"],
                lanes,
                {"kernel": "expert_ffn", "timed_at": lane_at,
                 "launches_path": "EP train, dense hier wire, "
                                  "--plan-objective replicate, 2 steps",
                 "device_ms": lanes["device_ms"],
                 "no_map_16_groups_ms": lanes["no_map_16_ms"],
                 "concatenated_stack_ms": lanes["concat_ms"],
                 "concatenated_stack_casts_per_call":
                     lanes["concat_casts_per_call"],
                 "library": "torch.bmm bf16 on the mapped bf16 stack",
                 "bound_share": lanes["bound_share"],
                 "checks": lanes["checks"]}),
        _record("expert_ffn_bwd@lanes",
                "src/repro_torch/csrc/expert_ffn_bwd.cu",
                "src/repro/kernels/expert_ffn.py:52 (no Pallas backward; XLA "
                "differentiates the reference)", rl["expert_ffn_bwd_lanes"],
                dict(max_abs_err=lanes["bwd_max_abs_err"],
                     ms=lanes["bwd_ms"], plain_ms=lanes["bwd_plain_ms"],
                     bound_ms=lanes["bwd_bound_ms"],
                     bound_by=lanes["bwd_bound_by"],
                     library_ms=lanes["bwd_library_ms"]),
                {"kernel": "expert_ffn_bwd", "timed_at": lane_at,
                 "launches_path": "EP train, dense hier wire, "
                                  "--plan-objective replicate, 2 steps",
                 "device_ms": lanes["bwd_device_ms"],
                 "no_map_16_groups_ms": lanes["bwd_no_map_16_ms"],
                 "library": "torch.bmm bf16 composite on the mapped stack"}),
    ]
    records += _paper_records(paper)
    records += _arch_records(arch)
    records += _llama4_records(l4)
    records += _seamless_records(sm)
    records += _rwkv_records(rw)
    records += _dense_train_records(dense)
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in sorted(PHASE_S.items(),
                                            key=lambda kv: -kv[1])}))
    log(f"total {time.perf_counter() - t_start:.1f}s on {smi}")
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
