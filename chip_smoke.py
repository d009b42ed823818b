#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

``python3 chip_smoke.py --only moe_ep_cards`` runs the device phase and
phase 36 alone (on a machine with four cards, its four-card part, which
trains across the cards as well); ``--only pipeline_cards`` the device
phase and phase 37 (with four cards, qwen2-72b at full depth across
them).

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — requires CUDA, prints the card's name and power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them) and builds the CUDA kernels into ``build/kernels/`` (one ``nvcc``
   per source, all started together).
2. kernels — holds each Hopper kernel against its plain PyTorch version on
   the card:
   - small edge cases: 8×8 blocks, bn = 16, ragged N, empty rows, pad
     blocks, an all-empty (all-pad) matrix, G > 1, a plan with idle lanes
     and split rows; the SpMM merge and the SDDMM each run twice for bit
     identity; the SDDMM (B2) also at (64, 64) and (16, 32) blocks with 8
     slots a CTA: rows longer than a chunk, chunks across rows, slots out
     of row order, N = 1, 4, 21 and 37 (rows TMA cannot take), N = 256,
     and G = 3 at N = 256 (the dC panel streamed);
   - planned_kernels: the rmw kernel (B4) on edge plans (idle lanes, a
     row split over three or more lanes, a row split twice on one lane,
     empty rows, an all-empty A, row_atomic, chunk 1, 8×8 blocks with
     bn = 16, G > 1, ragged N), f32 and bf16, each twice for bit
     identity and bitwise against the compact kernel + merge; then B1
     and B4 at 64 × 64 blocks on a row split into more runs than a
     cluster has blocks and a run longer than the ring, N = 1, 4, 17 and
     256 (every consumer and B-panel route of the run walk);
   - the serving shapes of the SpMM kernels (the qwen3-4b MLP
     down-projection over 4 sequences at N = 1, 112 and 128 tokens, and
     the sparse logit head);
   - the training shapes: the block SDDMM (dA) and both planned kernels
     on the transpose-side plan (dB) of the MLP down-projection at G=1,
     N=256 and of the head at G=1, N=4, and on the MLP's forward plan at
     G=1, N=256 (the train path's forward and remat recompute); then a
     power-law block pattern at the MLP's size, whose heavy rows the
     balanced plan splits over lanes;
   each in f32 and bf16, after an L2 flush.  Prints kernel, plain, library
   (one dense ``torch.matmul``) and bound times, the kernel's share of its
   bound (bound_ms / ms), and for B4 the time of the compact kernel +
   merge on the same plan.
3. reference — the qwen3-4b smoke config on the card against the same
   weights on the CPU (the plain path the CPU tests hold against the JAX
   reference): logits within 1e-4, equal greedy tokens.
4. serve   — qwen3-4b at full width and depth with a block-sparse MLP and
   a block-sparse logit head, random weights from a seed, f32: ``generate``
   answers a batch of 4 prompts, ``complete_static`` answers the same 4
   requests one at a time through the ``SparseLogitHead``.  Launch counts
   are zeroed just before and read just after, and must equal one naive
   launch per layer per forward pass and one launch per head call of
   the kernel of the head plan's layout (rmw: B4).  Then the head is
   built again with ``plan="auto"`` (search seconds, winning config, a
   cache hit on a second build) and the same 4 requests go through it,
   counted again: greedy tokens equal to the default head's, logits
   within 1e-4.  Outside the counted runs it times a prefill, a decode
   step and a head call, and profiles one prefill, one decode step and
   one head call with ``torch.profiler`` (wall ms, summed kernel ms, the
   top kernels).
   ``generate``, ``complete_static`` and the batcher decode through the
   cached callables (``serve.jitted_decode_step``): on the card a CUDA
   graph, captured on a state's second step and replayed after it (the
   launch counts above count each replay).  Every serving phase (serve,
   qwen2_serve, hybrid_serve, ssm_serve, encdec_serve, vlm_serve,
   moe_serve, moe_ep_serve, qwen3_moe_ep_serve: ``replay_check``; batcher
   and hybrid_batcher: ``fused_graph_check`` on the fused step and the
   head) holds 8 replays against the eager step on a copy of the same
   state, outputs and every cache ``torch.equal`` (a difference would be
   recorded and held within 1e-5·max + 1e-6), and prints the graph's
   capture ms, node count and pool bytes, and the replayed step's wall ms
   beside the eager one.
5. train_reference — the qwen3-4b smoke config with a sparse MLP at
   (8, 8) blocks: the loss and every gradient of one batch on the card
   against the same weights and batch on the CPU (plain path), then one
   ``make_train_step`` step on both (parameters within 2·lr).
6. train   — ``repro_torch.launch.train`` on qwen3-4b at full width and
   depth with ``--sparse-mlp``, f32, seed 0, 4 × 256 tokens in 4
   microbatches, 4 AdamW steps.  On the card the launcher compiles its
   step (``train.jitted_train_step``): step 1 is eager (the warm-up),
   step 2 captures the whole step as one CUDA graph and replays it, steps
   3 and 4 are replays alone.  Launch counts are zeroed just before and
   read just after and must equal the count derived from the plan's
   layouts: per layer and microbatch, the forward plan's kernel for the
   forward and the remat recompute, the transpose-side plan's for dB,
   the SDDMM once for dA.  Prints loss and grad norm per step, the
   graph (one capture, a replay a step after it; capture ms, nodes,
   pool GiB), the warm-up, capture and replayed steps' walls, tokens/s,
   the peak GiB, the host syncs of one more replayed step (none allowed,
   CUDA's sync debug mode) and one replayed step profiled.  Then the same
   4 steps from the same seed through ``make_train_step`` itself, eagerly
   (``held_against_eager``): losses, grad norms and every parameter
   equal bit for bit (where two eager runs are not bit-equal themselves,
   their gap is printed and the replay held to the card-against-CPU
   tolerance), with the eager run's peak GiB and one profiled eager
   step.
7. head_backward — a backward through a full-size
   ``SparseLogitHead.build(trainable=True)``, its launches counted by
   the plans' layouts, its grads held against the kernels' plain
   versions on the card.
7a. partitioned — the mesh-partitioned SpMM (``kernels/partition.py``;
   B1 + the row-offset merge per shard, B2 per shard for dA), f32 at
   full width: the head built by ``SparseLogitHead.build(n_shards=D,
   n_col_shards=C)`` at (D, C) = (1, 1), (2, 1), (4, 1), (2, 2), at
   N = 1 and 4, each call twice bit for bit, (1, 1) bit-equal to the
   single-device compact head, the others within ``check_close`` of it
   and of the plain versions; the MLP's forward + backward at G 1,
   N 256 under ``plan_spmm_vjp(n_shards=D, n_col_shards=C)`` at (1, 1)
   (bit-equal to the compact plan), (4, 1) and (2, 2); then
   ``complete_static`` answers the serve phase's 4 requests through the
   head at (4, 1), greedy tokens against the default head's (a mismatch
   fails only where that step's top-2 logit margin exceeds the f32
   tolerance; margins reported). Launches are zeroed just before the
   MLP runs and the served run and read just after (the kernels line's
   ``"partitioned"``). Prints host plan seconds, ``padding_waste``,
   per-shard steps, launches and merge steps a call, events ms of each
   case, B1 alone and the epilogue apart, and the single-device B4 and
   B1 + merge on the same weight; ``device_count``: with one card every
   (D, C) above 1 runs as the stacked loop.  The mesh branch runs once on
   the one card (the head at (4, 1), N = 4, under a bound mesh of
   ``"cuda"`` entries, another device name than the payload's), bit-equal
   to the loop, each shard's own blocks kept from the first call to the
   second; a mesh of several cards is not run.
7b. autotune — ``plan_search(measure=True, top_k=3)`` on the MLP
   down-projection and the head weights (each finalist's config, layout
   and measured µs); both layouts of the default knobs through
   ``maple_spmm`` (bitwise equal); on the MLP, the reordered plans
   (row-atomic bitwise, chunked within 1e-5·max) and ELL and bitmap
   copies (bitwise against the BlockCSR route).  Launches are counted
   over the phase.
8. spgemm_kernels — the SpGEMM numeric phase (B5), its CSR SDDMM (B6) and
   dB, and the element walk with a dense B (B7) against their plain
   versions on the card, f32 and bf16, over the element-pattern goldens
   and edge cases (empty rows, an all-zero A, nnz at capacity,
   zero-dimension operands, la = 1, lc = 1, pad steps, rows and panels
   wider than a warp, B rows of 48 and 120 entries, A column fibers of 60,
   B rows no slot consumes, a row whose slots take only empty B rows, an
   output row of lc > 256); B5 on each of its routes (8 lanes a row, a
   warp a row), B6 and dB twice each for bit identity,
   B5 in f32 bit-equal to its plain version, dB 0 on unused B rows; B7 bit
   for bit, and alone at L > 32 with a row all pad, N = 1, 37, 64, 300.
9. spgemm  — the paper's protocol C = A×A on the cage12 clone at scale
   1.0 (seed 0; its n, nnz, la, lb, lc, P and nnz(C) are printed; the
   clone's rng takes the string hashes of the process, so the script
   re-runs itself with ``PYTHONHASHSEED=0`` unless it is set): the host plan
   timed, ``maple_spgemm`` forward and the backward of sum(C²) with the
   launch counts zeroed just before and read just after (one B5, one B6,
   one dB), C held against scipy's A @ A (pattern and values) and against
   the plain path on the card (B5 bit for bit), the gradient against the
   plain versions, and warm forward and forward + backward times; then
   ``maple_spmspm(A, B)`` with a dense (n, 64) B (one B7 launch, against
   scipy); then the four kernels timed at these shapes beside
   their bounds, plain versions and ``torch.sparse.mm`` (cuSPARSE), and
   B5, B6 and dB again on C = A×A over the poisson3Da clone (B rows of 25
   entries on average, up to 48).
9a. gustavson — the row-wise product oracles of ``core.gustavson`` on the
   card at full Table-I size: ``spmm_rowwise(A, B)`` on cage12 with the
   spgemm phase's dense (n, 64) B against B7 (``maple_spmspm``) and B7's
   plain version; ``spmspm_rowwise``, ``spmspm_rowwise_scan`` (row chunk
   112) and ``dense_oracle`` on poisson3Da against B5's C
   (``maple_spgemm``) densified (14 000² f32).  Each within 1e-5·max +
   1e-6, each oracle run twice bit for bit; the launch counts are zeroed
   just before and read just after: one B5, one B7, none from the oracles.
9b. paper_tables — ``repro_torch.launch.paper_tables`` at scale 1.0 over
   the 14 Table-I clones (generated on the card, the model on the host):
   every row (n, nnz, P, nnz(C), energy, on-chip energy and speedup % and
   area × of both families), the two mean rows beside the paper's
   values, each clone's generate and analyze seconds; cage12's P and
   nnz(C) must equal the spgemm phase's plan and B5's output nnz.
10. moe_kernels — the MoE grouped GEMM (B8) against its plain version, f32
    and bf16: the reference sweep's groups (empty groups included) at
    D = F = 256, bt = 128, and decode's bt = 8 at the smoke widths; each
    twice for bit identity.
10a. moe_backward_kernels — B8's dx (its transposed-weight mode: w read in
    place) and ``moe_dw_kernel`` against their plain versions, f32 and
    bf16: bt 8, 16, 56, 96 and 216, several tiles an expert (adjacent or
    not), experts with no tile (a zero dW), D and F off multiples of 16
    (both copy routes of each kernel, reported as ``dx_copy`` /
    ``dw_copy``), each twice bit for bit.
11. moe_reference — the granite-moe-3b smoke config on the card against
    the same weights on the CPU: logits within 1e-4, equal greedy tokens.
12. moe_serve — granite-moe-3b at full width and depth (32 layers, f32,
    random weights from a seed): ``generate`` answers 4 prompts with 16
    greedy tokens; the B8 launch count is zeroed just before and read
    just after and must be 3 per layer per forward pass.  Layer 0's MoE,
    on its inputs in a prefill (cap 96) and in a decode step (cap 8), is
    held against a per-expert oracle whose routing is recomputed in
    float64 with numpy (``expert_idx``, ``order``, ``keep`` and the
    capacity must be equal).  Prints prefill ms, decode ms per step,
    tokens/s, peak GiB and a profile of one decode step.  Then B8 at
    granite's four expert-product shapes (gate/up and down, prefill and
    decode) against its plain version, f32 and bf16, timed beside its
    bound, plain version and ``torch.bmm``.
12a. batcher — the continuous batcher (``serve/batcher.py``) over paged
    decode, f32, weights from seed 0, full width and depth.  Run A:
    qwen3-4b with the sparse MLP and head, 16 greedy requests (Poisson
    0.5 a round on the step clock, prompts 16 to 128, 8 to 32 new
    tokens; the serve bench's workload and pool sizing,
    ``serve.workload``), 8 slots, pages of 16, ``max_seq`` 160: every request ends by length,
    peak pages under the static equivalent, no page left, the head's plan
    unchanged (the planners raise during the run), launches exactly B3
    36 × (fused steps + admissions) and B4 fused steps + admissions, each
    request's tokens against ``complete_static`` through the same head
    under the margin rule; then fused steps at full occupancy (8 rounds'
    wall, the host syncs of one and where they happen, one profiled).
    Run B: the bench's chaos (schedule seed 7, malformed prompts,
    deadlines, the pool at 0.6 of the worst case), 12 requests: statuses
    in ``STATUSES``, the chaos bites, every ok completion against an
    uninterrupted ``complete_static``.  Run D: run A's first 4 requests
    sampled (temperature 0.8, top-k 50, seed 0): every B3 and B4 launch
    of the first run held against its plain version on its inputs (B3 at
    G 8, N 1 and G 1, N = each prompt; B4 at N 8 and N 1), two runs
    equal, request 0 alone bit-equal logits at every draw and the same
    tokens.  Run E: round 2's fused step fails past the retry budget with
    two requests live: both finish on the static path (a fallback drain),
    greedy tokens against ``complete_static`` under the margin rule,
    sampled tokens equal to an uninterrupted run's.  Run C:
    granite-moe-3b, 6 greedy requests, 4 slots: B8 launches exactly
    3 × 32 × (fused steps + admissions), every request ends by length.
13. block_attn_kernels — block-sparse local attention (B9) against its
    plain version, f32 and bf16 (bf16 also row by row, ``check_rows``),
    over the reference sweep's shapes, one with bq != bk and one at hd
    256; each twice for bit identity.
14. local_attention — ``local_block_attention`` at recurrentgemma-9b's
    local-attention shape (B 2, S 8192, H 16, hd 256, window 2048,
    128-blocks), in f32 and in bf16: exactly one B9 launch a call, held
    against the plain version and the dense oracle one example at a time
    (bf16 also row by row), then timed beside its bound, plain version
    and ``scaled_dot_product_attention`` in its dtype with a band mask.
15. qwen2_reference — phase 3 on the qwen2-7b smoke config (QKV biases
    drawn non-zero): logits within 1e-4 of the CPU's, equal greedy tokens.
16. qwen2_serve — phase 4 on qwen2-7b at full width and depth (28 layers,
    d_model 3 584, 28 heads, 4 KV heads, d_ff 18 944, vocab padded to
    153 600; QKV biases drawn non-zero), the same sparse MLP and head
    (153 600 × 3 584), without the autotuned head: launches exactly
    28 × ((1 + 16) + 4 × 16) = 2 268 naive and 64 of the head's layout;
    tokens/s, prefill and decode-step ms (wall and device), peak GiB.
17. hybrid_reference — the recurrentgemma-9b smoke config (5 layers,
    window 16, a sparse MLP at (8, 8)) on the card against the CPU: a
    prefill of 40 tokens and 23 decode steps past the window (the rolling
    cache wraps), logits within 1e-4, greedy tokens equal, B9 once per
    local-attention layer in the prefill; then the batcher on the card,
    1 request of 8 + 40 tokens through 8 pages of 4: pages reclaimed
    behind the window, tokens equal to ``generate``.
18. hybrid_serve — phase 4 on recurrentgemma-9b at full width and depth
    (38 layers: 12 local-attention, 26 RG-LRU; d_model 4 096, 16 heads
    over 1 KV head, hd 256, window 2 048, d_ff 12 288, vocab 256 000),
    the sparse GeGLU down-projection and a 256 000 × 4 096 head: launches
    exactly B9 12 × (1 + 4) = 60, B3 38 × ((1 + 16) + 4 × 16) = 3 078, B4
    64; every B3, B4 and B9 launch of one prefill, one decode step and
    one scored request held against the plain versions; then one request
    of 2 304 tokens (``continuation_check``): ``prefill`` of 2 296 plus 8
    ``decode_step`` over the wrapped rolling cache against ``prefill`` of
    all of it, its prefill timed and profiled (B9's share).
19. hybrid_batcher — recurrentgemma-9b through the continuous batcher:
    6 greedy requests (run C's workload), 4 slots, pages of 16; launches
    exactly B9 12 × admissions, B3 38 × (fused steps + admissions), B4
    fused steps + admissions; tokens against ``complete_static`` under the
    margin rule.  Then B9 timed at the serve path's two prefill shapes.
20. ssm_reference — phase 17 on the mamba2-2.7b smoke config (a prompt of
    two SSD chunks), its batcher a mid-stream join with no pages.
21. ssm_serve — phase 4 on mamba2-2.7b at full width and depth (64
    layers, d_model 2 560, d_state 128, headdim 64, vocab 51 200, no MLP)
    and a 51 200 × 2 560 head: B4 64, no B3; ``continuation_check`` on 512
    tokens (two SSD chunks) from a one-chunk prefix and 256 decode steps.
22. encdec_reference — the whisper-base smoke config (2 encoder and 2
    decoder layers, layer norms, GELU MLPs, cross-attention) with every
    bias drawn non-zero and the layer norms' scales off one, on the card
    against the CPU: greedy ``generate`` tokens equal, a prefill and 8
    decode steps within 1e-4, one request through an (8, 8) sparse head
    by ``head_route`` (``prefill(return_hidden=True)`` then
    ``decode_step(return_hidden=True)``), tokens equal;
    ``prefill_cross_kv`` into an ``init_decode_state`` equal to the
    prefill's cross caches.
23. encdec_serve — phase 4 on whisper-base at full width and depth (6
    encoder and 6 decoder layers, d_model 512, 8 heads, hd 64, d_ff 2 048,
    enc_seq 1 536, vocab 51 865 padded to 53 248; biases drawn non-zero)
    with a 53 248 × 512 sparse head and no sparse MLP (its MLP is the plain
    GELU one): ``generate`` on 4 prompts with their encoder frames, then
    the 4 requests one at a time through the head by ``head_route``;
    launches exactly B4 64, B3 0, B9 0; also the encoder's device ms.
24. vlm_reference — phase 22 on the internvl2-1b smoke config (8
    patches, QKV biases drawn non-zero, a sparse MLP at (8, 8)).
25. vlm_serve — phase 23 on internvl2-1b at full width and depth (24
    layers, d_model 896, 14 heads over 2 KV heads, hd 64, d_ff 4 864, 256
    patches, vocab 151 655 padded to 153 600) with the sparse MLP at
    (64, 64), d 0.25, and a 153 600 × 896 head: launches exactly B3
    24 × ((1 + 16) + 4 × 16) = 1 944 and B4 64.  Then the kernel rows of
    both models: B3 at internvl's down-projection (G 4, N 1 and 368), B4
    on both heads (N 1), f32.
26. train_families_reference — one train step of the whisper-base,
    internvl2-1b (sparse MLP at (8, 8)), granite-moe-3b-a800m,
    mamba2-2.7b, recurrentgemma-9b (dense, and the sparse MLP at (8, 8);
    48 tokens against its window of 16: local attention on
    ``chunked_attention``), qwen2-72b and qwen3-moe-235b-a22b (two-level
    remat over its 2 layers; at 1 and at 2 microbatches, the second
    through its bf16 gradient accumulator) smoke configs (biases drawn
    non-zero), card against CPU as phase 5: the loss within 1e-5
    relative, every gradient within 1e-4·max + 1e-6, the parameters
    after one AdamW step within 2·lr.
27. train_encdec, train_vlm, train_moe, train_ssm — phase 6 on whisper-base
    (4 × 256 tokens, each beside 1 536 encoder frames), internvl2-1b with
    the sparse MLP (4 × (256 patches + 256 tokens)), granite-moe-3b-a800m
    (8 × 256 tokens in its 8 microbatches) and mamba2-2.7b (4 × 256), each
    at full width and depth through ``launch/train.main``, f32, 4 AdamW
    steps through the captured step as phase 6, remat per layer.  Every
    Maple kernel's launches are zeroed just before and read just after:
    B2 and B4 by phase 6's formula on internvl, 9 B8 (3 forward, 3
    recomputed, 3 dx) and 3 ``moe_dw_kernel`` per layer and microbatch on
    granite, none on the other two.  Finite losses and grad norms, the
    graph and the steps' walls, tokens/s, the peak GiB, a replayed step's
    host syncs and one more replayed step profiled; whisper-base and
    granite are also held against the eager step as phase 6.  Then B8's
    forward and dx and
    ``moe_dw_kernel`` at granite's training shapes (capacity 56, E 48;
    gate/up and down), f32 and bf16, timed beside their bound, plain
    version, one ``torch.bmm`` and the earlier kernels' ms (``was_ms``).
27a. train_hybrid — phase 27 on recurrentgemma-9b at full width (d_model
    4 096, 16 heads over 1 KV head, hd 256, d_ff 12 288, lru_width 4 096,
    window 2 048, vocab 256 000) with the sparse MLP at (64, 64), d 0.25,
    cut to the deepest 3u + 2 layers whose reckoned f32 peak
    (``reckon_train_peak``) leaves 12 GiB of the card free for the
    captured step's pool (8 layers; 11 ran out in the capture) (``n_layers``,
    ``depth_reduced`` and the full config's 38 printed): 8 sequences of
    2 304 tokens in its 8 microbatches, 3 AdamW steps through the
    captured step (the capture at that depth: no eager fall-back), remat
    per layer.
    B4 and B2 by phase 6's formula, B9 0 (local attention trains on
    ``chunked_attention``, the reference's route).
27b. chunked_attention — ``layers.chunked_attention`` (not a TPU kernel:
    the reference's jnp flash attention), f32, forward and forward +
    backward, at train_hybrid's local attention (B 1, S 2 304, H 16 over
    1 KV head, hd 256, window 2 048) and a global causal qwen3-4b layer at
    4 096 tokens: held against the plain masked softmax, timed after the
    L2 flush beside it, one ``scaled_dot_product_attention`` with the same
    mask and the bound; recorded, not gated.
28. moe_ep_reference — expert parallelism (``moe_layer_ep``) on one
    card's mesh, ``("data", "model") = (1, 4)`` of ``"cuda"`` entries
    (every peer's work on the one card; phase 36 runs a mesh of cards):
    the granite-moe-3b smoke config with ``moe_impl="ep_a2a"`` at
    capacity 1.25, the same weights under the card mesh and a CPU mesh
    of the same shape: prefill logits within 1e-4, greedy tokens equal,
    B8 exactly 3 × 4 peers a layer a forward pass; one microbatch's loss
    and every gradient card against CPU (``train_against_cpu``).
29. moe_ep_serve — granite-moe-3b at full width and depth, its own
    config (EP, capacity 1.25), f32: ``generate`` on 4 prompts, 16
    greedy tokens, under the mesh; B8 launches exactly 3 × 4 × 32 a
    forward pass (the sort path's ``moe_serve``: 3 × 32); tokens/s,
    prefill and decode-step wall and device ms, peak GiB, the slots
    dropped at each level over a prefill's layers; layer 0's MoE card EP
    against CPU EP and, at capacity 8.0 (no slot dropped), EP against the
    sort path, within 1e-5·max + 1e-6; the same layer's forward and
    backward at phase 30's shapes (a 1 × 256 microbatch: e_loc 12,
    cap_exp 272), card mesh against CPU mesh: y, dx and every expert and
    router gradient within 1e-5·max + 1e-6.  The decode step's profile is
    also summed by ``key_averages`` beside the one-pass sums.
30. train_moe_ep — phase 27's ``train_moe`` under the mesh through
    ``launch.train.run``, 3 steps, the step captured under the bound
    mesh: B8 (forward, remat, dx) and ``moe_dw_kernel`` launches each × 4
    peers.
31. qwen3_moe_ep_serve — phase 29 on qwen3-moe-235b-a22b at full width
    (d_model 4 096, 128 experts, top-8, d_expert 1 536), cut to the
    deepest stack whose reckoned f32 peak leaves 4 GiB free (the cut and
    the full config's 94 layers printed).
32. train_resume — whisper-base at full width and depth through
    ``launch/train.py``'s CLI, f32, through the captured step (each run,
    the resumed one on the checkpoint's tensors too, warms up, captures
    its second step and replays after it): run A 4 steps (twice), run B 2
    steps with ``--ckpt-dir`` then 4 from it (resumed at 2); B's
    parameters and
    optimizer state equal A's bit for bit (or, where A's two runs differ,
    within that); checkpoint save and load seconds and bytes on disk;
    ``launch/serve.py --ckpt-dir`` gives ``generate``'s greedy tokens on
    B's parameters.
33. pipeline — GPipe ``pipeline_apply`` on one card's ``("pod",)`` mesh of
    4 ``"cuda"`` entries: first the qwen3-4b smoke config (8 layers, a
    sparse MLP at (8, 8)) card mesh against a CPU mesh (output and every
    gradient within 1e-4·max + 1e-6); then qwen3-4b at full width and
    depth (36 layers, f32, the train phase's sparse MLP), 4 microbatches
    of a 4 × 256 batch, each stage's 9 blocks by ``lm.apply_layers``: the
    output and the gradients of ``sum(y·R)`` against the same blocks run
    in order on each microbatch and against the whole batch through them
    at once, within 1e-5·max + 1e-6; B4 and B2 launches exactly as the
    stage calls give them; wall ms, a profiled forward + backward's device
    ms beside the train phase's step, peak GiB.
34. dryrun — ``repro_torch.launch.dryrun`` over every arch × shape on
    both production meshes, walked on ``meta`` by worker processes (host
    only): each cell's status, GiB per chip, dominant term and step time,
    the host seconds; a ``FAILED`` cell fails the phase.  Meanwhile dense
    qwen3-4b, bf16 parameters, on a (1, 1) mesh: a train step (4 × 256 in
    4 microbatches) and a decode step (4 × 4 096) walked on ``meta`` and
    on the card with equal FLOPs, bytes, dot FLOPs and ops; the reckoned
    memory against ``max_memory_allocated`` and the roofline step time
    against the measured device ms, as ratios (recorded, not gated).
35. examples — the reference's four examples (``repro_torch.examples``),
    each driven by its ``main`` on the card and held against the same
    example run on the CPU in this process from the same weights, every
    kernel's launches zeroed just before the card run and read just
    after.  quickstart: layer A's text equal; layer B (``maple_spmm`` on a
    ``BlockCSR`` with no plan) within 1e-5·max + 1e-6 of the plain
    version, exactly one B4 launch; layer C's three captured steps' losses
    within 1e-4 relative, greedy tokens equal.  accelerator_sim at
    ``--scale 0.1 --matrices wg sc fb --spgemm --events``: the text equal
    apart from ``max|dC|`` (at most 1e-5), exactly 3 B5 launches.
    serve_lm (recurrentgemma-9b smoke): T=0 tokens, every completion's
    rid, status, ``finished_by`` and tokens, both engines' fused steps,
    ``memory_stats()`` and ``fault_stats()`` equal; B9 exactly once a
    local-attention layer a prefill; one host sync a fused step once the
    fused step is captured.  train_lm: lm-125m ``--sparse-mlp --steps 50
    --ckpt-dir build/examples/train_lm`` at the example's widths and
    depth through the captured step (B4 and B2 launches by the plan;
    losses at steps 0 and 49; warm-up, capture and median replayed wall,
    tok/s, peak GiB, 0 host syncs and one profiled replayed step; the
    step-50 checkpoint loads back bit-equal); 3 steps at 2 × 32 tokens
    card against CPU, losses within 1e-4 relative; ``--partition 2 --steps
    3``, the stacked loop on one card: B1 and B2 launches per shard
    exactly, losses within 1e-5 relative of the 50-step run's first three,
    the replays bit-equal to the same run eager.
36. moe_ep_cards — expert-parallel serving with each ``model`` peer's
    experts on its own card: a ``(data=1, model=4)`` mesh over the cards
    the process sees (four cards: ``cuda:0`` to ``cuda:3``; one card: four
    ``cuda:0`` entries, the same per-peer code).  granite-moe-3b at full
    width and depth, f32, drawn whole on ``cuda:0``: ``generate`` (4
    prompts, 16 greedy tokens) under one card's ``(1, 4)`` mesh of
    ``"cuda"`` entries on the whole tree, then under the mesh on the tree
    placed by ``sharding.device_put_params`` (the whole tree dropped): the
    prefill's and every decode step's logits and the tokens bit for bit;
    B8 launches counted by the card current at each launch (3 a peer a
    layer a forward pass, each peer's on its card); each card's
    ``memory_allocated`` against the placed tree's bytes there (within
    256 MiB; with four cards no card holds the whole expert stack);
    prefill and eager decode-step wall and device ms by card (B8 and the
    copies apart; the walls of 3 unprofiled calls beside) and tokens/s
    on both meshes.  A mesh of several cards
    decodes eagerly (``serve.engine.captured``); one card's captures.
    With four cards also: qwen3-moe-235b at phase 31's depth the same way
    (its whole expert leaves moved to the other cards first where the
    slices do not fit beside them); qwen3-moe-235b at the deepest stack the four cards hold
    (reckoned by card, drawn a layer at a time on the last card and
    placed): ``generate`` twice with equal greedy tokens, finite logits,
    B8 by card, layer 0's MoE against the CPU mesh within 1e-5·max +
    1e-6, bytes by card, timings; the partitioned logit head at (D, C) =
    (4, 1) and (2, 2), N = 1 and 4, on ``partition_mesh``'s private mesh
    of cards, bit for bit against the stacked loop, B1 by card.  With
    one card the line says the four-card part did not run.
    Training with the placed tree, every run (``placed_train_check``):
    granite cut to 2 layers at full width, 2 eager steps of
    ``train_moe_ep``'s 8 × 256 tokens in 8 microbatches on four ``cuda:0``
    entries against the whole tree on one card's (1, 4) mesh: losses and
    grad norms within 1e-5 relative, parameters within 1e-6 of the tree's
    largest |parameter|, B8 and ``moe_dw_kernel`` launches exact (path
    ``moe_ep_cards_train``).  With
    four cards (``train``; one card: "not run: needs four cards"):
    granite at full width and depth, 3 eager steps of that batch with the
    placed tree on four ``cuda:0`` entries (host copies of the parameters
    and both moments kept), then on the four cards: every step's loss and
    grad norm and the state after step 3 bit for bit; B8 (forward, remat,
    dx) 2 304 and ``moe_dw_kernel`` 768 launches a step on each card
    (counted by the card current at each launch, on autograd's worker
    threads too); each card's ``memory_allocated`` after a step against
    the placed state's bytes (within 1 GiB); the eager walls of steps 2
    and 3; one step profiled by card (B8, dW and the copies between cards
    apart); layer 0's MoE forward and backward of ``sum(y·R)`` at the
    training shapes on the cards against the CPU mesh (y, dx, every expert
    and router gradient within 1e-5·max + 1e-6; B8 6 and dW 3 a card);
    and ``launch.train.run(ckpt_dir=...)`` on the cards, granite cut to
    the deepest stack whose checkpoint stays under 5 GB on disk (12 bytes
    a stored parameter): 4 straight steps against 2, a save, a resume and
    2 more, bit for bit, with save and load seconds and bytes on disk.
37. pipeline_cards — the GPipe pipeline with each stage's layer groups
    on its own card (``pipeline_apply`` over a ``("pod",)`` mesh of 4:
    the cards the process sees where there are four, else four
    ``cuda:0`` entries).  Every run: qwen2-72b's smoke config cut to 8
    layers, f32, a sparse MLP at (8, 8), QKV biases drawn, card mesh
    against CPU mesh (output, dx and every gradient of ``sum(y·R)``
    within 1e-4·max + 1e-6, as phase 33's qwen3-4b smoke); then
    qwen2-72b at full width cut to 8 layers (2 a stage), bf16, its
    sparse MLP at (64, 64) d 0.25, drawn on ``cuda:0``, on four
    ``cuda:0`` entries: the config's 8 microbatches of 1 × 1 024 tokens
    embedded by a table drawn on the card, used and dropped; launches
    zeroed just before and read just after, exactly as ``pipeline``
    reckons them (path ``pipeline_cards``); y, dx and every gradient
    against the same blocks run in order, microbatch by microbatch,
    within 1e-2·max; and layer 0's sparse down-projection on one such
    microbatch (the forward, dh and the blocks' gradient: B4 on each
    plan and B2, at 8 192 × 29 568) against the plain masked-dense
    product in f32, within 1e-2·max.
    With four cards also: that tree placed by
    ``pipeline.place_stages`` on the cards, bit for bit against the four
    ``cuda:0`` entries (the gaps held to 1e-2·max where not), each
    layer's gradient on its stage's card, the unplaced tree refused; then
    qwen2-72b at all 80 layers, 20 drawn on each card (no card holds the
    whole tree; one host pattern, one plan): launches, ring bytes
    (``collective-permute``, against M·(P−1) hops of 1 × 1 024 × 8 192 ×
    2 bytes each way) and peak GiB by card (beside the parameters and
    gradients reckoned); the wall of a second run, a third profiled by
    card (device ms), the efficiency Σ device ms / (4 × wall) beside
    GPipe's M / (M + P − 1); y, dx and every gradient against the same
    blocks run in order on their cards within 1e-2·max.  With fewer
    cards the line says the four-card part did not run.
38. the ``{"kernels": [...]}`` summary (``launches_by_path`` has every
    path above), then the final ``{"ok": true, ...}``.

Every phase's line carries ``t_s``, the seconds since the start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
SOURCES = {"maple_spmm_naive": "src/repro_torch/csrc/maple_spmm.cu",
           "maple_spmm_compact": "src/repro_torch/csrc/maple_spmm.cu",
           "maple_spmm_planned": "src/repro_torch/csrc/maple_spmm.cu",
           "maple_sddmm_bsr": "src/repro_torch/csrc/maple_sddmm.cu",
           "maple_spgemm_numeric": "src/repro_torch/csrc/maple_spgemm.cu",
           "maple_sddmm_csr": "src/repro_torch/csrc/maple_spgemm.cu",
           "maple_spgemm_db": "src/repro_torch/csrc/maple_spgemm.cu",
           "maple_spmspm_ell": "src/repro_torch/csrc/maple_spmspm.cu",
           "moe_gemm": "src/repro_torch/csrc/moe_gemm.cu",
           "moe_gemm_dw": "src/repro_torch/csrc/moe_gemm.cu",
           "block_attention": "src/repro_torch/csrc/block_attn.cu"}
# dB has no TPU kernel: the reference leaves it to an XLA scatter-add; nor
# has the experts' dW: the reference trains its MoE layer through einsum,
# whose gradient XLA computes
REPLACES = {"maple_spmm_naive": "src/repro/kernels/maple_spmm.py:91",
            "maple_spmm_compact": "src/repro/kernels/maple_spmm.py:288",
            "maple_spmm_planned": "src/repro/kernels/maple_spmm.py:176",
            "maple_sddmm_bsr": "src/repro/kernels/maple_sddmm.py:124",
            "maple_spgemm_numeric": "src/repro/kernels/maple_spgemm.py:92",
            "maple_sddmm_csr": "src/repro/kernels/maple_sddmm.py:214",
            "maple_spgemm_db": "src/repro/kernels/ops.py:934",
            "maple_spmspm_ell": "src/repro/kernels/maple_spmspm.py:61",
            "moe_gemm": "src/repro/kernels/moe_gemm.py:57",
            "moe_gemm_dw": "src/repro/models/moe.py:97",
            "block_attention": "src/repro/kernels/block_attn.py:94"}
# the serving shapes of the kernels: the qwen3-4b MLP down-projection
# (d_ff -> d_model) as sparse_mlp builds it, over a batch of 4 sequences
# (G) at decode (N = 1 token) and prefill (N = 112 tokens, the serve
# phase's prompts, and 128); the sparse logit head (d_model -> padded
# vocab) as the serve benchmark builds it, one request at a time
MLP = dict(name="mlp_down 2560x9728 (64,64) d=0.25", d_out=2560, d_in=9728,
           block=(64, 64), density=0.25, G=4, N=(1, 112, 128))
HEAD = dict(name="logit_head 153600x2560 (64,64) d=0.5 L=8", d_out=153_600,
            d_in=2560, block=(64, 64), density=0.5, n_lanes=8, G=1, N=(1, 4))
# the training shapes: the same weights at the activations of one
# microbatch of the train phase (1 × 256 tokens) and of the head check
# (1 × 4 tokens); dA and dB of y = x·Wᵀ are the SDDMM over (dC, x) and the
# compact kernel on Wᵀ over dC
TRAIN_MLP = dict(MLP, G=1, N=(256,))
TRAIN_HEAD = dict(HEAD, G=1, N=(4,))
# a power-law block pattern at the MLP's size (row i holds about
# 152·(i+1)^-1.2 of the 152 block columns): the balanced plan splits the
# heavy rows over lanes, and B4 walks each row in one thread block
POWER_LAW = dict(MLP, name="power_law 2560x9728 (64,64)", G=1, N=(1, 256))
SERVE_ARCH = "qwen3-4b"
# the slice that puts a second dense family on the kernels: qwen2-7b (QKV
# biases) at full width and depth, sparse MLP and head as qwen3-4b's
QWEN2_ARCH = "qwen2-7b"
# the SpGEMM slice: C = A×A on the paper's cage12 clone at full size
# (Table I: n 130 000, nnz 2.0 M), and A times a dense (n, 64) B
CAGE12, CAGE12_SCALE = "cg", 1.0
# the second timed SpGEMM shape: poisson3Da (Table I, n 14 000, nnz 353 000,
# banded), whose B rows average 25 entries and reach 48 where cage12's
# average 15 and reach 36
POISSON = "p3"
SPMSPM_N = 64
TRAIN_ARGV = ["--arch", "qwen3-4b", "--sparse-mlp", "--steps", "4",
              "--global-batch", "4", "--seq-len", "256", "--seed", "0",
              "--device", "cuda"]
# the MoE slice: granite-moe-3b-a800m served at full width and depth; its
# expert products on B8 at prefill (4 prompts of 112 tokens: capacity 96)
# and decode (4 tokens: capacity 8), E = 48 padded experts
MOE_ARCH = "granite-moe-3b-a800m"
MOE_E = 48
MOE_SHAPES = (("prefill gate", 96, 1536, 512), ("prefill down", 96, 512, 1536),
              ("decode gate", 8, 1536, 512), ("decode down", 8, 512, 1536))
# (group sizes, D, F, bt): the reference sweep, then decode's tile at the
# smoke config's widths
MOE_EDGE = (([256, 0, 384, 128], 256, 256, 128), ([128] * 4, 256, 256, 128),
            ([0, 0, 512, 0], 256, 256, 128),
            ([8, 0, 16, 8, 0, 8, 0, 8], 64, 32, 8))
# block-sparse local attention: the reference sweep's (S, window, bq, bk)
# at hd 32, one with bq != bk, and one at recurrentgemma-9b's hd 256; then
# recurrentgemma-9b's local attention
ATTN_EDGE = ((256, 64, 64, 64, 32), (512, 128, 128, 128, 32),
             (256, 40, 64, 64, 32), (128, 128, 64, 64, 32),
             (256, 40, 128, 64, 32), (512, 200, 128, 128, 256))
ATTN = dict(B=2, S=8192, H=16, hd=256, window=2048, bq=128, bk=128)
REPS = 20
# (HBM bytes/s, {operand type: peak FLOP/s}) from NVIDIA's data sheets:
# f32 operands at the FP32 rate outside the tensor cores, bf16 operands
# (accumulated in f32) at the dense bf16 tensor-core rate
CARD_SPECS = {
    "H100 PCIe": (2.0e12, {torch.float32: 51e12, torch.bfloat16: 756e12}),
    "H100 NVL": (3.9e12, {torch.float32: 60e12, torch.bfloat16: 835e12}),
    "H100": (3.35e12, {torch.float32: 67e12, torch.bfloat16: 989e12}),
    "H200": (4.8e12, {torch.float32: 67e12, torch.bfloat16: 989e12})}


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def card_spec(name: str):
    for key, spec in CARD_SPECS.items():
        if all(part in name for part in key.split()):
            return spec
    raise RuntimeError(f"no published rates for {name!r}; add them to "
                       f"CARD_SPECS")


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush (the weights of a layer loop are never L2-resident)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def check_close(got, want, dtype, what):
    """f32: only the order of summation differs; bf16: one rounding of
    the f32 sum at the end, at most one bf16 ulp (2^-8 relative) apart.
    ``got`` is brought to ``want``'s device."""
    got, want = got.float().to(want.device), want.float()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    limit = (1e-5 * scale + 1e-6) if dtype == torch.float32 else 1e-2 * scale
    if not err <= limit:
        raise AssertionError(f"{what}: max|kernel - plain| = {err} > {limit}")
    return err


ROW_LIMIT = 2.0 ** -7


def row_rel_err(got, want):
    """The largest error of a run of max(hd, 64) consecutive output values
    (one query row of one head at hd >= 64) over the run's norm; inf where
    a run that should be 0 is not."""
    import torch.nn.functional as F
    n = max(want.shape[-1], 64)
    d = (got.float() - want.float()).flatten()
    w = want.float().flatten()
    pad = -d.numel() % n
    d = F.pad(d, (0, pad)).view(-1, n).norm(dim=1)
    w = F.pad(w, (0, pad)).view(-1, n).norm(dim=1)
    rel = torch.where(w > 0, d / w.clamp(min=1e-30),
                      torch.where(d > 0, torch.inf, 0.0))
    return float(rel.max()) if rel.numel() else 0.0


def check_rows(got, want, what):
    """bf16 B9, beside ``check_close``: ``row_rel_err`` within 2^-7.  P's
    one rounding to bf16 and the output's leave about 2e-3 of a row; one
    key too many or too few in a row of 2048 moves it about 1.3e-2, where
    ``check_close``'s 1e-2·max lets through an error as large as a typical
    output.  Returns ``row_rel_err``."""
    err = row_rel_err(got, want)
    if not err <= ROW_LIMIT:
        raise AssertionError(f"{what}: a run of output values is off by "
                             f"{err} of its norm > 2^-7")
    return err


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def bsr(rng, gm, gk, bm, bk, density, *, extra_pad=0, empty_rows=False,
        dtype=torch.float32):
    from repro_torch.core.csr import BlockCSR
    mask = rng.random((gm, gk)) < density
    if empty_rows:
        mask[::2] = False
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    a = BlockCSR.from_dense(d, (bm, bk), n_blocks_max=int(mask.sum())
                            + 1 + extra_pad, device="cuda")
    return dataclasses.replace(a, blocks=a.blocks.to(dtype))


def run_naive_case(a, g, n, dtype, bn, rng):
    from repro_torch.kernels.maple_spmm import (maple_spmm_naive,
                                                maple_spmm_naive_plain)
    from repro_torch.kernels.ops import _meta_on
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).cuda().to(dtype)
    meta = _meta_on(a, b3.device)
    args = (a.blocks, meta["row_ptr"], meta["block_col"], b3)
    got = maple_spmm_naive(*args, bn=bn)
    torch.cuda.synchronize()
    want = maple_spmm_naive_plain(*args)
    return got, want, args, b3


def run_compact_case(a, plan, g, n, dtype, bn, rng):
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_compact_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).cuda().to(dtype)
    dev = plan.on_device(b3.device)
    n_slots = plan.n_lanes * plan.r_max
    args = (a.blocks, dev["order"], dev["step_col"], dev["runs"], b3)
    tiles = maple_spmm_compact(*args, n_slots=n_slots, bn=bn)
    torch.cuda.synchronize()
    want_tiles = maple_spmm_compact_plain(*args, n_slots=n_slots)
    live = torch.from_numpy(plan.slot_row.reshape(-1) >= 0).cuda()
    bm = plan.block_m
    view = lambda t: t.view(g, n_slots, bm, n)[:, live]
    merge = lambda t: _scatter_merge_f32(t.view(g, n_slots, bm, n),
                                         dev["merge"], gm=plan.n_block_rows)
    merged = [merge(tiles) for _ in range(2)]
    if not torch.equal(merged[0], merged[1]):
        raise AssertionError("slot merge is not bit-identical over two runs")
    return (view(tiles), view(want_tiles), merged[0], merge(want_tiles),
            args, n_slots, b3)


def edge_cases():
    from repro_torch.kernels.schedule import plan_spmm
    rng = np.random.default_rng(SEED)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for kw in (dict(), dict(empty_rows=True, extra_pad=3),
                   dict(density=0.0, extra_pad=2)):
            a = bsr(rng, 6, 5, 8, 8, kw.pop("density", 0.45), dtype=dtype,
                    **kw)
            for g, n in ((1, 1), (3, 21), (2, 40)):
                got, want, _, _ = run_naive_case(a, g, n, dtype, 16, rng)
                check_close(got, want, dtype, f"naive edge {kw} g{g} n{n}")
                cases += 1
            # split rows (chunk 1), idle lanes (8 lanes, rows whole)
            for lanes, chunk, whole in ((8, 1, False), (8, None, True),
                                        (3, None, False), (1, 2, False)):
                plan = plan_spmm(a, n_lanes=lanes, chunk=chunk,
                                 row_atomic=whole)
                tiles, want_tiles, merged, want_merged, *_ = \
                    run_compact_case(a, plan, 3, 21, dtype, 16, rng)
                check_close(tiles, want_tiles, dtype,
                            f"compact edge {kw} L{lanes}")
                check_close(merged, want_merged, dtype,
                            f"compact merge edge {kw} L{lanes}")
                cases += 1
    return cases


def run_planned_case(a, plan, g, n, dtype, bn, rng):
    """B4 on ``plan`` over random B: two launches must give the same bits
    and equal B1 + the slot merge on the same plan bit for bit."""
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_planned,
                                                maple_spmm_planned_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).cuda().to(dtype)
    dev = plan.on_device(b3.device)
    args = (a.blocks, dev["order"], dev["step_col"], dev["row_runs"],
            dev["row_run_ptr"], b3)
    got = [maple_spmm_planned(*args, bn=bn) for _ in range(2)]
    n_slots = plan.n_lanes * plan.r_max
    tiles = [maple_spmm_compact(a.blocks, dev["order"], dev["step_col"],
                                dev["runs"], b3, n_slots=n_slots, bn=bn)
             for _ in range(2)]
    merged = _scatter_merge_f32(tiles[0].view(g, n_slots, plan.block_m, n),
                                dev["merge"], gm=plan.n_block_rows)
    torch.cuda.synchronize()
    if not torch.equal(got[0], got[1]):
        raise AssertionError("B4 is not bit-identical over two runs")
    live = torch.from_numpy(plan.slot_row.reshape(-1) >= 0).cuda()
    view = lambda t: t.view(g, n_slots, plan.block_m, n)[:, live]
    if not torch.equal(view(tiles[0]), view(tiles[1])):
        raise AssertionError("B1 is not bit-identical over two runs")
    if not torch.equal(got[0], merged):
        raise AssertionError("B4 differs from B1 + merge on one plan")
    return got[0], maple_spmm_planned_plain(*args), args, b3


def planned_edge_cases():
    """B4 against its plain version, f32 and bf16, on plans with idle
    lanes, a row split over three or more lanes, a row split twice on one
    lane, empty rows, an all-empty A, row_atomic, chunk 1, 8×8 blocks with
    bn = 16, G > 1 and ragged N; each twice and against B1 + merge."""
    from repro_torch.core.csr import BlockCSR
    from repro_torch.kernels.schedule import plan_spmm
    rng = np.random.default_rng(SEED + 11)
    seen, cases = set(), 0
    for dtype in (torch.float32, torch.bfloat16):
        mask = np.zeros((6, 5), bool)
        mask[0] = True                              # a 5-block row
        mask[3, 1] = True
        d = np.repeat(np.repeat(mask, 8, 0), 8, 1) * rng.standard_normal(
            (48, 40)).astype(np.float32)
        heavy = BlockCSR.from_dense(d, (8, 8), n_blocks_max=8, device="cuda")
        heavy = dataclasses.replace(heavy, blocks=heavy.blocks.to(dtype))
        mats = {"uniform": bsr(rng, 6, 5, 8, 8, 0.45, dtype=dtype),
                "empty_rows": bsr(rng, 6, 5, 8, 8, 0.45, empty_rows=True,
                                  extra_pad=3, dtype=dtype),
                "all_empty": bsr(rng, 6, 5, 8, 8, 0.0, extra_pad=2,
                                 dtype=dtype),
                "heavy_row": heavy}
        for name, a in mats.items():
            for lanes, chunk, whole in ((8, None, True), (8, 1, False),
                                        (3, 1, False), (1, 2, False)):
                plan = plan_spmm(a, n_lanes=lanes, chunk=chunk,
                                 row_atomic=whole)
                live = plan.step_col >= 0
                per = np.stack([np.bincount(plan.step_row[l][live[l]],
                                            minlength=plan.n_block_rows)
                                for l in range(plan.n_lanes)])
                seen |= {k for k, hit in (
                    ("idle_lanes", (plan.written.sum(1) == 0).any()),
                    ("row_over_3_lanes", plan.written.sum(0).max() >= 3),
                    ("row_twice_on_one_lane", plan.chunk > 0 and
                     (per > plan.chunk).any()),
                    ("empty_rows", (np.diff(a.row_ptr) == 0).any()),
                    ("all_empty", a.nnzb == 0),
                    ("row_atomic", whole), ("chunk_1", chunk == 1)) if hit}
                for g, n in ((1, 1), (3, 21), (2, 40)):
                    got, want, _, _ = run_planned_case(a, plan, g, n, dtype,
                                                       16, rng)
                    check_close(got, want, dtype,
                                f"planned edge {name} L{lanes} g{g} n{n}")
                    cases += 1
    expected = {"idle_lanes", "row_over_3_lanes", "row_twice_on_one_lane",
                "empty_rows", "all_empty", "row_atomic", "chunk_1"}
    if seen != expected:
        raise AssertionError(f"edge plans missed {expected - seen}")
    walk_cases, walk_seen = run_walk_edge_cases()
    return {"phase": "planned_kernels", "cases": cases + walk_cases,
            "plans_cover": sorted(seen | walk_seen),
            "bitwise_vs_compact_merge": True, "rerun_bitwise": True,
            "ok": True}


def run_walk_edge_cases():
    """B1 and B4 at 64 × 64 blocks (the wgmma, skinny and 8 × 8 FFMA
    consumers, every B-panel copy route), f32 and bf16, N = 1, 4, 17 and
    256, G = 2: a row split into more runs than a cluster has blocks, a
    run longer than the ring (its segments loop it), empty rows, a
    one-block row; each launch twice (bit-identical), B4 bitwise against
    B1 + merge and within tolerance of its plain version."""
    from repro_torch.core.csr import BlockCSR
    from repro_torch.kernels.maple_spmm import SEGMENTS
    from repro_torch.kernels.schedule import plan_spmm
    rng = np.random.default_rng(SEED + 14)
    mask = np.zeros((6, 24), bool)
    mask[0] = True                                  # 24 blocks
    mask[2, ::8] = True
    mask[3, 2:22] = True                            # 20 blocks
    mask[5, 7] = True                               # one block
    d = np.repeat(np.repeat(mask, 64, 0), 64, 1) * rng.standard_normal(
        (6 * 64, 24 * 64)).astype(np.float32)
    seen, cases = set(), 0
    for dtype in (torch.float32, torch.bfloat16):
        a = BlockCSR.from_dense(d, (64, 64), n_blocks_max=int(mask.sum())
                                + 2, device="cuda")
        a = dataclasses.replace(a, blocks=a.blocks.to(dtype))
        for lanes, chunk, whole in ((16, 1, False), (1, None, True),
                                    (8, None, False)):
            plan = plan_spmm(a, n_lanes=lanes, chunk=chunk, row_atomic=whole)
            runs_a_row = int(np.diff(plan.row_run_ptr).max())
            longest = int((plan.runs[:, 2] - plan.runs[:, 1]).max())
            if runs_a_row > SEGMENTS:
                seen.add("row_over_cluster")
            if longest > 4 * SEGMENTS:              # > 4 stages a segment
                seen.add("run_over_ring")
            for n in (1, 4, 17, 256):
                got, want, _, _ = run_planned_case(a, plan, 2, n, dtype, 128,
                                                   rng)
                check_close(got, want, dtype,
                            f"run walk L{lanes} n{n} {dtype}")
                cases += 1
    if seen != {"row_over_cluster", "run_over_ring"}:
        raise AssertionError(f"run-walk plans cover only {seen}")
    return cases, seen


def measure(name, got, want, dtype, kernel, plain, library, nbytes, flops,
            spec, flush, reps, **shape):
    """Check the kernel against its plain version, then time the kernel,
    the plain version and the library call, and the bound."""
    err = check_close(got, want, dtype, f"{name} {shape}")
    ms = time_ms(kernel, reps, flush)
    plain_ms = time_ms(plain, max(3, reps // 4), flush)
    library_ms = time_ms(library, reps, flush)
    t_bytes, t_ops = nbytes / spec[0] * 1e3, flops / spec[1][dtype] * 1e3
    bound = max(t_bytes, t_ops)
    return {"name": name, "dtype": str(dtype).replace("torch.", ""),
            **shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_share": bound / ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sparse_weight(gen, shape, dtype):
    from repro_torch.models.layers import init_sparse_linear
    w = init_sparse_linear(gen, shape["d_in"], shape["d_out"],
                           block_shape=shape["block"],
                           block_density=shape["density"])
    return dataclasses.replace(w, blocks=w.blocks.to(dtype))


def spmm_cost(w, g, n, isz, out_bytes, meta_bytes):
    """(bytes, FLOPs) the function needs: live weight blocks, metadata, B
    and the output each moved once; 2 FLOPs per live weight element per
    output column."""
    bm, bk = w.block_shape
    live = w.nnzb * bm * bk
    return (live * isz + meta_bytes + g * w.shape[1] * n * isz + out_bytes,
            2 * live * n * g)


def serving_shapes(spec, flush):
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_compact_plain,
                                                maple_spmm_naive,
                                                maple_spmm_naive_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    from repro_torch.kernels.schedule import plan_spmm
    rng = np.random.default_rng(SEED + 1)
    rows = []
    plan_s = None
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dtype).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        mlp = sparse_weight(gen, MLP, dtype)
        dense = mlp.to_dense()
        for n in MLP["N"]:
            g = MLP["G"]
            got, want, args, b3 = run_naive_case(mlp, g, n, dtype, 128, rng)
            nbytes, flops = spmm_cost(
                mlp, g, n, isz, out_bytes=g * mlp.shape[0] * n * isz,
                meta_bytes=4 * (mlp.n_block_rows + 1 + mlp.nnzb))
            rows.append(measure(
                "maple_spmm_naive", got, want, dtype,
                lambda: maple_spmm_naive(*args, bn=128),
                lambda: maple_spmm_naive_plain(*args),
                lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush,
                REPS, G=g, N=n, shape=MLP["name"]))
        del dense, mlp
        head = sparse_weight(gen, HEAD, dtype)
        t0 = time.perf_counter()
        plan = plan_spmm(head, n_lanes=HEAD["n_lanes"])
        plan_s = time.perf_counter() - t0
        dense = head.to_dense()
        n_live = int((plan.slot_row >= 0).sum())
        bm = plan.block_m
        for n in HEAD["N"]:
            g = HEAD["G"]
            tiles, want_tiles, merged, want_merged, args, n_slots, b3 = \
                run_compact_case(head, plan, g, n, dtype, 128, rng)
            check_close(merged, want_merged, dtype, f"head merge n{n}")
            nbytes, flops = spmm_cost(
                head, g, n, isz, out_bytes=g * n_live * bm * n * 4,
                meta_bytes=4 * 2 * plan.order.size + 16 * plan.runs.shape[0])
            row = measure(
                "maple_spmm_compact", tiles, want_tiles, dtype,
                lambda: maple_spmm_compact(*args, n_slots=n_slots, bn=128),
                lambda: maple_spmm_compact_plain(*args, n_slots=n_slots),
                lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush,
                REPS, G=g, N=n, shape=HEAD["name"])
            out = maple_spmm_compact(*args, n_slots=n_slots, bn=128)
            merge_ranks = plan.on_device(b3.device)["merge"]
            row["merge_ms"] = time_ms(
                lambda: _scatter_merge_f32(out.view(g, n_slots, bm, n),
                                           merge_ranks,
                                           gm=plan.n_block_rows),
                REPS, flush)
            # the merge reads each live slot once and writes the result
            row["merge_bound_ms"] = (g * (n_live + plan.n_block_rows) * bm
                                     * n * 4) / spec[0] * 1e3
            rows.append(row)
            rows.append(planned_row(head, plan, g, n, dtype, isz, spec,
                                    flush, rng, HEAD["name"], dense=dense))
        del dense, head
    return rows, plan_s


def run_sddmm_case(a, g, n, dtype, bn, rng, order=None):
    """The SDDMM of ``a``'s pattern on random (dC, B), its slots in
    ``order`` (default: the container's, by row); checks that two launches
    give the same bits."""
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_bsr,
                                                 maple_sddmm_bsr_plain)
    bm, bk = a.block_shape
    rand = lambda rows: torch.from_numpy(rng.standard_normal(
        (g, rows, n)).astype(np.float32)).cuda().to(dtype)
    dc, b3 = rand(a.shape[0]), rand(a.shape[1])
    order = np.arange(a.n_blocks_max) if order is None else order
    meta = {k: torch.from_numpy(getattr(a, k)[order]).cuda()
            for k in ("block_row", "block_col")}
    args = (dc, b3, meta["block_row"], meta["block_col"])
    got = [maple_sddmm_bsr(*args, bm=bm, bk=bk, bn=bn) for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(got[0], got[1]):
        raise AssertionError("SDDMM is not bit-identical over two runs")
    if bool((got[0][meta["block_col"] < 0] != 0).any()):
        raise AssertionError("SDDMM wrote a non-zero pad slot")
    return got[0], maple_sddmm_bsr_plain(*args, bm=bm, bk=bk), args


# B2 with 8 slots a CTA: (block, block grid, density, G, N, slots out of
# row order).  Rows longer than a chunk and chunks that span rows (the dC
# panel kept, then reloaded), rows TMA cannot take (N = 4, 37, 1 and 21),
# N = 256, G = 3 at N = 256 (the panel streamed beside B)
SDDMM_EDGE = (((64, 64), (6, 20), 0.7, 1, 256, False),
              ((64, 64), (6, 20), 0.7, 1, 4, False),
              ((64, 64), (6, 20), 0.7, 1, 37, False),
              ((64, 64), (6, 20), 0.7, 1, 1, False),
              ((64, 64), (4, 6), 0.5, 3, 256, False),
              ((64, 64), (6, 20), 0.7, 1, 256, True),
              ((16, 32), (6, 20), 0.7, 2, 21, True))


def sddmm_edge_cases():
    import repro_torch.kernels.maple_sddmm as sddmm
    rng = np.random.default_rng(SEED + 2)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for kw in (dict(), dict(empty_rows=True, extra_pad=3),
                   dict(density=0.0, extra_pad=2)):
            a = bsr(rng, 6, 5, 8, 8, kw.pop("density", 0.45), dtype=dtype,
                    **kw)
            for g, n in ((1, 1), (3, 21), (2, 40)):
                got, want, _ = run_sddmm_case(a, g, n, dtype, 16, rng)
                check_close(got, want, dtype, f"sddmm edge {kw} g{g} n{n}")
                cases += 1
        sddmm.CHUNK = 8
        try:
            for block, grid, density, g, n, shuffle in SDDMM_EDGE:
                a = bsr(rng, *grid, *block, density, empty_rows=True,
                        extra_pad=2, dtype=dtype)
                order = rng.permutation(a.n_blocks_max) if shuffle else None
                got, want, _ = run_sddmm_case(a, g, n, dtype, 128, rng,
                                              order=order)
                check_close(got, want, dtype,
                            f"sddmm edge {block} {grid} g{g} n{n} "
                            f"shuffled={shuffle}")
                cases += 1
        finally:
            sddmm.CHUNK = 0
    return cases


def training_shapes(spec, flush):
    """dA (the SDDMM) and dB (the compact kernel on the transpose-side
    plan) of the MLP down-projection and the head, at the training
    activations."""
    from repro_torch.core.csr import bsr_transpose
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_bsr,
                                                 maple_sddmm_bsr_plain)
    from repro_torch.kernels.schedule import plan_spmm, plan_spmm_vjp
    rng = np.random.default_rng(SEED + 3)
    rows, plans = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dtype).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        for shape in (TRAIN_MLP, TRAIN_HEAD):
            w = sparse_weight(gen, shape, dtype)
            t0 = time.perf_counter()
            train = plan_spmm_vjp(w, n_lanes=shape.get("n_lanes", 8))
            plans[shape["name"]] = {"plan_spmm_vjp_s":
                                    time.perf_counter() - t0,
                                    "bwd_runs": int(train.bwd.runs.shape[0]),
                                    "fwd_runs": int(train.fwd.runs.shape[0])}
            bm, bk = w.block_shape
            g, n = shape["G"], shape["N"][0]
            live = w.nnzb * bm * bk
            # dA: (dC, B) -> (n_blocks, bm, bk) f32
            got, want, args = run_sddmm_case(w, g, n, dtype, 128, rng)
            dc, b3 = args[:2]
            nbytes = (g * (w.shape[0] + w.shape[1]) * n * isz
                      + w.n_blocks_max * (bm * bk * 4 + 8))
            rows.append(measure(
                "maple_sddmm_bsr", got, want, dtype,
                lambda: maple_sddmm_bsr(*args, bm=bm, bk=bk),
                lambda: maple_sddmm_bsr_plain(*args, bm=bm, bk=bk),
                lambda: torch.matmul(dc, b3.transpose(1, 2)), nbytes,
                2 * live * g * n, spec, flush, REPS, G=g, N=n,
                shape=shape["name"]))
            del got, want, args, dc, b3
            if shape is TRAIN_MLP:
                name = f"{shape['name']} forward"
                rows.append(compact_row(w, train.fwd, g, n, dtype, isz,
                                        spec, flush, rng, name))
                rows.append(planned_row(w, train.fwd, g, n, dtype, isz,
                                        spec, flush, rng, name))
            # dB: Aᵀ on the transpose-side plan over dC
            wt = bsr_transpose(w)
            name = f"{shape['name']} transposed (dB)"
            rows.append(compact_row(wt, train.bwd, g, n, dtype, isz, spec,
                                    flush, rng, name))
            rows.append(planned_row(wt, train.bwd, g, n, dtype, isz, spec,
                                    flush, rng, name))
            del w, wt
            torch.cuda.empty_cache()
        # the power-law pattern: heavy rows split over lanes
        w = power_law_weight(dtype)
        plan = plan_spmm(w)
        plans[POWER_LAW["name"]] = {
            "runs": int(plan.runs.shape[0]), "rows": plan.n_block_rows,
            "longest_row_blocks": int(np.diff(w.row_ptr).max()),
            "most_runs_in_a_row": int(np.diff(plan.row_run_ptr).max())}
        for n in POWER_LAW["N"]:
            for row in (compact_row(w, plan, 1, n, dtype, isz, spec, flush,
                                    rng, POWER_LAW["name"]),
                        planned_row(w, plan, 1, n, dtype, isz, spec, flush,
                                    rng, POWER_LAW["name"])):
                rows.append(row)
        del w
    return rows, plans


def compact_row(a, plan, g, n, dtype, isz, spec, flush, rng, name):
    """The compact kernel on ``plan`` over ``a`` at the training
    activations: tiles and merge held against the plain versions, then
    timed."""
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_compact_plain)
    tiles, want_tiles, merged, want_merged, cargs, n_slots, b3 = \
        run_compact_case(a, plan, g, n, dtype, 128, rng)
    check_close(merged, want_merged, dtype, f"merge {name}")
    n_live = int((plan.slot_row >= 0).sum())
    nbytes, flops = spmm_cost(
        a, g, n, isz, out_bytes=g * n_live * plan.block_m * n * 4,
        meta_bytes=4 * 2 * plan.order.size + 16 * plan.runs.shape[0])
    dense = a.to_dense()
    row = measure(
        "maple_spmm_compact", tiles, want_tiles, dtype,
        lambda: maple_spmm_compact(*cargs, n_slots=n_slots, bn=128),
        lambda: maple_spmm_compact_plain(*cargs, n_slots=n_slots),
        lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush, REPS,
        G=g, N=n, shape=name)
    row["runs"] = int(plan.runs.shape[0])
    return row


def planned_row(a, plan, g, n, dtype, isz, spec, flush, rng, name,
                dense=None):
    """B4 on ``plan`` over ``a``: checked against its plain version and
    B1 + merge (bitwise), then timed beside its bound, the plain version,
    ``torch.matmul`` and B1 + merge on the same plan."""
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_planned,
                                                maple_spmm_planned_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    got, want, args, b3 = run_planned_case(a, plan, g, n, dtype, 128, rng)
    dev = plan.on_device(b3.device)
    n_slots = plan.n_lanes * plan.r_max
    bm = plan.block_m
    # every output row is written once, f32
    nbytes, flops = spmm_cost(
        a, g, n, isz, out_bytes=g * a.shape[0] * n * 4,
        meta_bytes=4 * 2 * plan.order.size + 16 * plan.row_runs.shape[0]
        + 4 * (plan.n_block_rows + 1))
    dense = a.to_dense() if dense is None else dense
    row = measure(
        "maple_spmm_planned", got, want, dtype,
        lambda: maple_spmm_planned(*args, bn=128),
        lambda: maple_spmm_planned_plain(*args),
        lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush, REPS,
        G=g, N=n, shape=name)
    row["compact_merge_ms"] = time_ms(
        lambda: _scatter_merge_f32(
            maple_spmm_compact(a.blocks, dev["order"], dev["step_col"],
                               dev["runs"], b3, n_slots=n_slots,
                               bn=128).view(g, n_slots, bm, n),
            dev["merge"], gm=plan.n_block_rows), REPS, flush)
    row["runs"] = int(plan.row_runs.shape[0])
    row["rows"] = plan.n_block_rows
    return row


def power_law_weight(dtype):
    """The MLP's shape and blocks with a power-law block pattern (no row
    empty), random values from the seed."""
    from repro_torch.core.csr import BlockCSR
    from repro_torch.core.sparsity import block_pattern_mask
    bm, bk = POWER_LAW["block"]
    gm, gk = POWER_LAW["d_out"] // bm, POWER_LAW["d_in"] // bk
    rng = np.random.default_rng(SEED + 13)
    mask = block_pattern_mask("power_law", rng, gm, gk)
    rows, cols = np.nonzero(mask)
    blocks = torch.randn((rows.size, bm, bk), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED + 13)) / np.sqrt(gk * bk)
    row_ptr = np.zeros(gm + 1, np.int32)
    np.cumsum(mask.sum(1), out=row_ptr[1:])
    return BlockCSR(blocks=blocks.to(dtype), block_col=cols.astype(np.int32),
                    block_row=rows.astype(np.int32), row_ptr=row_ptr,
                    shape=(gm * bm, gk * bk), block_shape=(bm, bk))


# --------------------------------------------------------------------------
# phase 3: the port on the card against the port's plain CPU path
# --------------------------------------------------------------------------

def small_reference(arch=SERVE_ARCH, phase="reference"):
    """``arch``'s smoke config with a sparse MLP and a sparse head on the
    card against the same weights on the CPU.  QKV biases, which
    ``init_params`` sets to zero, are drawn non-zero first."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.csr import BlockCSR
    from repro_torch.models import lm
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                                   complete_static, generate)
    cfg = dataclasses.replace(get_smoke_config(arch), sparse_mlp=True,
                              sparse_block=(8, 8))
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    attn = cpu["groups"]["b0"]["attn"]
    bias_gen = torch.Generator().manual_seed(SEED + 5)
    for name in ("bq", "bk", "bv") if cfg.qkv_bias else ():
        attn[name] = 0.5 * torch.randn(attn[name].shape, generator=bias_gen)
    move = lambda t: (dataclasses.replace(t, blocks=t.blocks.cuda(),
                                          device_meta={})
                      if isinstance(t, BlockCSR) else t.cuda())
    to_cuda = lambda tree: {k: to_cuda(v) if isinstance(v, dict) else move(v)
                            for k, v in tree.items()}
    gpu = to_cuda(cpu)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 9)))
    sampling = SamplingConfig(max_new_tokens=6)
    tok_cpu, _ = generate(cpu, cfg, {"tokens": prompts}, sampling)
    tok_gpu, _ = generate(gpu, cfg, {"tokens": prompts.cuda()}, sampling)
    lg_cpu, _ = lm.prefill(cpu, cfg, {"tokens": prompts})
    lg_gpu, _ = lm.prefill(gpu, cfg, {"tokens": prompts.cuda()})
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    if not torch.allclose(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"card prefill logits differ from CPU: {err}")
    if not torch.equal(tok_cpu, tok_gpu.cpu()):
        raise AssertionError("card greedy tokens differ from CPU")
    w = init_sparse_linear(torch.Generator().manual_seed(SEED + 7),
                           cfg.d_model, cfg.vocab_padded, block_shape=(8, 8),
                           block_density=0.5)
    head_cpu = SparseLogitHead.build(w)
    head_gpu = SparseLogitHead.build(move(w))
    new_cpu = complete_static(cpu, cfg, prompts[0].numpy(), 5,
                              sampling=SamplingConfig(), head=head_cpu)[0]
    new_gpu = complete_static(gpu, cfg, prompts[0].numpy(), 5,
                              sampling=SamplingConfig(), head=head_gpu)[0]
    if new_cpu != new_gpu:
        raise AssertionError("card sparse-head greedy tokens differ from CPU")
    return {"phase": phase, "config": f"{arch} smoke, sparse_mlp (8,8), "
            f"sparse head (8,8) d=0.5", "qkv_bias": cfg.qkv_bias,
            "prefill_max_abs_err": err, "greedy_tokens_equal": True}


# --------------------------------------------------------------------------
# phase 4: serve qwen3-4b at full width
# --------------------------------------------------------------------------

PLANNED = {"rmw": "maple_spmm_planned", "compact": "maple_spmm_compact"}


def _spmm_kernels():
    from repro_torch.kernels import (maple_spmm_compact, maple_spmm_naive,
                                     maple_spmm_planned)
    return maple_spmm_naive, maple_spmm_compact, maple_spmm_planned


def spmm_counters():
    """The SpMM kernels' launch counts, by kernel name."""
    return {f.__name__: f.launches for f in _spmm_kernels()}


def zero_spmm_counters():
    for f in _spmm_kernels():
        f.launches = 0


def model_kernels(cfg):
    """(blocks with a sparse MLP, local-attention blocks) of ``cfg``: the
    layers that launch B3 (a sparse MLP's down-projection) and B9 each
    forward pass of the decoder (an encoder's MLPs stay dense)."""
    kinds = cfg.block_kinds()
    n_mlp = sum(k != "ssm" for k in kinds) \
        if cfg.ffn_kind == "dense" and cfg.sparse_mlp else 0
    return n_mlp, kinds.count("local_attn")


def pad_block(s: int) -> int:
    """``s`` padded to the local-attention tile, the sequence B9 sees."""
    from repro_torch.models.layers import LOCAL_BLOCK
    return -(-s // LOCAL_BLOCK) * LOCAL_BLOCK


BIAS_LEAVES = ("bias", "b_in", "b_out", "bq", "bk", "bv")


def draw_biases(params, gen):
    """Every bias of ``params`` (zeros at init: QKV, layer norm and GELU
    MLP biases) drawn in place as 0.5·N(0, 1) from ``gen``, and every
    layer norm's scale (ones) as 1 + 0.2·N(0, 1), in the tree's order, so
    the model's paths use them."""
    for name, t in list(params.items()):
        if isinstance(t, dict):
            draw_biases(t, gen)
        elif name in BIAS_LEAVES:
            t.normal_(generator=gen).mul_(0.5)
        elif name == "scale" and "bias" in params:
            t.normal_(generator=gen).mul_(0.2).add_(1.0)


def extra_inputs(cfg, b, gen):
    """The non-token inputs of ``b`` requests, N(0, 1) from ``gen`` on
    its device: encoder frames (b, enc_seq, D) or patch embeddings (b,
    n_patches, D), as ``launch/serve.py`` draws them."""
    out = {}
    if cfg.n_enc_layers:
        out["enc_frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model),
                                        generator=gen, device=gen.device)
    if cfg.n_patches:
        out["vision_embeds"] = torch.randn((b, cfg.n_patches, cfg.d_model),
                                           generator=gen, device=gen.device)
    return out


def head_route(params, cfg, head, prompt, extra, new):
    """One request with its own extra inputs scored by ``head``, greedy:
    ``prefill(return_hidden=True)`` and one
    ``decode_step(return_hidden=True)`` a further token, through the
    cached callables, as ``complete_static`` walks a token-only request.
    Returns (new tokens, "length" or "error" on non-finite logits,
    None)."""
    from repro_torch.serve import (SamplingConfig, jitted_decode_step,
                                   jitted_prefill)
    from repro_torch.serve.engine import sample_token
    tok = torch.from_numpy(np.asarray(prompt)).to(
        params["embed_tokens"].device)[None]
    step_fn = jitted_decode_step(cfg, return_hidden=True)
    hidden, state = jitted_prefill(
        cfg, tok.shape[1] + cfg.n_patches + new, return_hidden=True)(
            params, batch={"tokens": tok, **extra})
    out = []
    while True:
        row = head(hidden)[:, -1]
        if not bool(torch.isfinite(row[:, :cfg.vocab_size]).all()):
            return out, "error", None
        nxt = sample_token(row, None, SamplingConfig(), cfg.vocab_size)
        out.append(int(nxt[0]))
        if len(out) >= new:
            return out, "length", None
        hidden, state = step_fn(params, state=state, tokens=nxt[:, None])


def serve(card, arch=SERVE_ARCH, phase="serve", autotuned=True,
          continuation=None):
    """Serve ``arch`` at full width and depth with the sparse MLP (where
    the model has a gated MLP) and head (its biases, where the config has
    them, drawn non-zero: ``draw_biases``); with ``autotuned`` also
    through a ``plan="auto"`` head; with ``continuation`` = (prompt
    length, prefix length), ``continuation_check`` on one long request.
    A model that takes encoder frames or a vision prefix gets them drawn
    from the seed, and its 4 requests go through the head one at a time
    by ``head_route`` (``complete_static`` takes tokens only).  Returns
    the launches of each counted run (by path) and the phase's line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.block_attn import block_attention
    from repro_torch.models import lm
    from repro_torch.models.layers import GATED, init_sparse_linear
    from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                                   complete_static, generate)
    from repro_torch.train.optimizer import named_leaves
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, sparse_mlp=cfg.activation in GATED)
    n_mlp, n_local = model_kernels(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    draw_biases(params, gen)
    head = SparseLogitHead.build(init_sparse_linear(
        gen, cfg.d_model, cfg.vocab_padded, block_shape=(64, 64),
        block_density=0.5))
    extra = extra_inputs(cfg, 4, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompt_len = int(rng.integers(16, 129))
    prompts = rng.integers(0, cfg.vocab_size, (4, prompt_len))
    batch = {"tokens": torch.from_numpy(prompts).cuda(), **extra}
    row0 = {k: v[:1] for k, v in batch.items()}
    seq = prompt_len + cfg.n_patches         # what the decoder prefills
    new = 16
    sampling = SamplingConfig(max_new_tokens=new)
    route = "head_route" if extra else "complete_static"

    zero_spmm_counters()
    block_attention.launches = 0
    t0 = time.perf_counter()
    tokens, _ = generate(params, cfg, batch, sampling)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if extra:
        singles = [head_route(params, cfg, head, p, {
            k: v[i:i + 1] for k, v in extra.items()}, new)
            for i, p in enumerate(prompts)]
    else:
        singles = [complete_static(params, cfg, p, new,
                                   sampling=SamplingConfig(), head=head)
                   for p in prompts]
    torch.cuda.synchronize()
    static_s = time.perf_counter() - t0
    launches = spmm_counters()
    launches["block_attention"] = block_attention.launches
    # generate: one prefill + one decode step per new token; each request
    # of complete_static (or head_route): one prefill + (new - 1) decode
    # steps, each scored by the head in its plan's layout; every layer's
    # sparse MLP is one naive launch; every local-attention layer one B9
    # launch a prefill (decode reads its rolling cache without it)
    expect = {"maple_spmm_naive": n_mlp * ((1 + new) + 4 * new),
              "maple_spmm_compact": 0, "maple_spmm_planned": 0,
              "block_attention": n_local * (1 + 4)}
    expect[PLANNED[head.plan.fused]] += 4 * new

    if tokens.shape != (4, new) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(tokens.shape)} "
                             f"tokens outside the vocabulary")
    for toks, reason, _ in singles:
        if reason != "length" or len(toks) != new:
            raise AssertionError(f"{route} ended with {reason!r} after "
                                 f"{len(toks)} tokens")
    if launches != expect:
        raise AssertionError(f"kernel launches on the path {launches}, "
                             f"expected {expect}")
    by_path = {phase: launches}
    if autotuned:
        search = autotuned_head(params, cfg, head, prompts, singles, new)
        by_path["serve_autotuned_head"] = search["launches"]
    else:
        search = None

    # checks and timings outside the counted run: every B3 and B4 launch
    # of one batch prefill, one decode step and one scored request held
    # against the plain versions at this model's shapes
    held = {}
    with held_against_plain(held, phase):
        logits, state = lm.prefill(params, cfg, batch, max_seq=seq + new)
        _, state = lm.decode_step(params, cfg, state, tokens[:, :1])
        hidden, _ = lm.prefill(params, cfg, row0, return_hidden=True)
        head_logits = head(hidden)
    shapes = {(PLANNED[head.plan.fused], 1, cfg.d_model, 1)}
    if n_mlp:
        shapes |= {("maple_spmm_naive", 4, cfg.d_ff, seq),
                   ("maple_spmm_naive", 4, cfg.d_ff, 1),
                   ("maple_spmm_naive", 1, cfg.d_ff, seq)}
    if n_local:
        shapes |= {("block_attention", b, pad_block(prompt_len),
                    cfg.n_heads, cfg.head_dim) for b in (4, 1)}
    if not shapes <= set(held):
        raise AssertionError(f"{phase} held {sorted(held)}, not every shape "
                             f"of {sorted(shapes)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(head_logits)
            .all()):
        raise AssertionError("non-finite logits")
    if search is not None:
        auto_logits = search.pop("head")(hidden)
        auto_err = float((auto_logits - head_logits).abs().max())
        if not torch.allclose(auto_logits, head_logits, rtol=1e-4,
                              atol=1e-4):
            raise AssertionError(f"autotuned head logits differ by "
                                 f"{auto_err}")
        search["logits_max_abs_diff"] = auto_err
        del auto_logits
    del head_logits
    alone, _ = lm.prefill(params, cfg, row0)
    alone_err = float((alone - logits[:1]).abs().max())
    if not torch.allclose(alone, logits[:1], rtol=1e-3, atol=1e-3):
        raise AssertionError(
            f"batch-1 prefill logits differ from the batch's: max|diff| "
            f"{alone_err}, max|logit| {float(logits[:1].abs().max())}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.prefill(params, cfg, batch, max_seq=seq + new)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_tok = tokens[:, :1]
    t0 = time.perf_counter()
    for _ in range(4):
        _, state = lm.decode_step(params, cfg, state, step_tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / 4
    t0 = time.perf_counter()
    for _ in range(4):
        head(hidden)
    torch.cuda.synchronize()
    head_ms = (time.perf_counter() - t0) * 1e3 / 4
    profiles = {
        "prefill": profile(lambda: lm.prefill(params, cfg, batch,
                                              max_seq=seq + new),
                           totals=MODEL_TOTALS),
        "decode_step": profile(lambda: lm.decode_step(params, cfg, state,
                                                      step_tok),
                               totals=MODEL_TOTALS),
        "sparse_head": profile(lambda: head(hidden),
                               totals=("run_kernel",))}
    if cfg.n_enc_layers:
        profiles["encoder"] = profile(
            lambda: lm._encode(params, cfg, extra["enc_frames"]))
    _, state = lm.prefill(params, cfg, batch, max_seq=seq + 32)
    graph = replay_check(params, cfg, state, step_tok, phase)
    del state, logits, hidden
    long = None
    if continuation is not None:
        long = continuation_check(params, cfg, *continuation)
    release_graphs()
    return by_path, {
        "phase": phase, "config": f"{arch} "
        f"{'sparse_mlp (64,64) d=0.25, ' if n_mlp else ''}"
        f"sparse head (64,64) d=0.5 n_lanes=8, f32", "n_layers": cfg.n_layers,
        "pattern": cfg.layer_plan(), "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "window": cfg.window,
        "lru_width": cfg.lru_width, "ssm_d_state": cfg.ssm_d_state,
        "vocab_padded": cfg.vocab_padded, "qkv_bias": cfg.qkv_bias,
        "norm": cfg.norm, "activation": cfg.activation,
        "n_enc_layers": cfg.n_enc_layers, "enc_seq": cfg.enc_seq,
        "n_patches": cfg.n_patches,
        "n_params": sum(t.numel() for _, t in named_leaves(params)),
        "param_count": cfg.param_count(),
        "head_fused": head.plan.fused, "autotuned_head": search,
        "depth_reduced": False, "batch": 4, "prompt_len": prompt_len,
        "prefill_len": seq, "new_tokens": new, "setup_s": setup_s,
        "generate_s": gen_s, "generate_tok_per_s": 4 * new / gen_s,
        f"{route}_s": static_s, f"{route}_tok_per_s": 4 * new / static_s,
        "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
        "prefill_device_ms": profiles["prefill"]["device_ms"],
        "decode_step_device_ms": profiles["decode_step"]["device_ms"],
        "replayed_decode_step_ms": graph["replayed_decode_step_ms"],
        "decode_step_graph": graph,
        "encoder_device_ms": profiles["encoder"]["device_ms"]
        if "encoder" in profiles else None,
        "sparse_head_ms": head_ms, "launches": launches,
        "batch1_vs_batch_max_abs_diff": alone_err,
        "held_against_plain": {" ".join(map(str, k)): v
                               for k, v in sorted(held.items())},
        "card": card,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiles": profiles, "continuation": long}


# the kernels a model path's profile sums apart: B1 / B3 / B4 (the run
# walk) and B9
MODEL_TOTALS = ("run_kernel", "block_attn")


def continuation_check(params, cfg, total, prefix):
    """One request of ``total`` random tokens: ``prefill`` of its first
    ``prefix`` plus one ``decode_step`` a token up to the end against
    ``prefill`` of all of it, at the last position: within 1e-4·max|logit|
    + 1e-5, or, where this model's f32 rounding alone moves its logits
    further, within 4× that rounding (``floor``: the same prompt's logits
    prefilled alone and in a batch of four, which sums every product in
    another order); the same argmax unless the top-2 margin is inside the
    limit.  Past a local window the decode steps wrap the rolling cache
    and B9 skips the band's first tiles; on an SSM the full prefill runs
    more SSD chunks than the prefix's.  Also times the full prefill (wall)
    and profiles it once (device, B9's share)."""
    from repro_torch.kernels.block_attn import block_attention
    from repro_torch.models import lm
    rng = np.random.default_rng(SEED + 9)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (4, total))).cuda()
    prompt = prompts[:1]
    block_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _ = lm.prefill(params, cfg, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    b9 = block_attention.launches
    v = cfg.vocab_size
    want = full[0, -1, :v].float()
    batch, _ = lm.prefill(params, cfg, {"tokens": prompts})
    floor = float((batch[0, -1, :v].float() - want).abs().max())
    del batch
    _, state = lm.prefill(params, cfg, {"tokens": prompt[:, :prefix]},
                          max_seq=total)
    for t in range(prefix, total):
        logits, state = lm.decode_step(params, cfg, state,
                                       prompt[:, t:t + 1])
    got = logits[0, -1, :v].float()
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max()) + 1e-5
    limit = max(tol, 4 * floor)
    top2 = torch.topk(want, 2).values
    margin = float(top2[0] - top2[1])
    argmax_equal = int(got.argmax()) == int(want.argmax())
    if not err <= limit or not (argmax_equal or margin <= limit):
        raise AssertionError(f"{cfg.name}: prefill({prefix}) + "
                             f"{total - prefix} decode steps differ from "
                             f"prefill({total}) by {err} (limit {limit}: "
                             f"1e-4 rule {tol}, 4 × rounding floor "
                             f"{floor}); argmax equal {argmax_equal}, "
                             f"top-2 margin {margin}")
    del state, logits
    prof = profile(lambda: lm.prefill(params, cfg, {"tokens": prompt}),
                   warmup=False, totals=MODEL_TOTALS)
    b9_ms = prof["totals"]["block_attn"]["device_ms"]
    return {"prompt_len": total, "prefix": prefix,
            "decode_steps": total - prefix, "max_abs_err": err,
            "max_abs_logit": float(want.abs().max()), "tol_1e-4": tol,
            "rounding_floor": floor, "limit": limit,
            "limit_by": "1e-4·max" if tol >= 4 * floor else "4×floor",
            "argmax_equal": argmax_equal, "top2_margin": margin,
            "b9_launches_per_prefill": b9, "prefill_ms": prefill_ms,
            "prefill_device_ms": prof["device_ms"],
            "b9_share_of_device": b9_ms / prof["device_ms"]
            if prof["device_ms"] else None, "profile": prof}


def autotuned_head(params, cfg, head, prompts, singles, new):
    """The autotuned head on ``head``'s weight: searched once, a cache hit
    when built again, then the same requests through it, counted; greedy
    tokens equal to the default head's.  Returns the search's record with
    the autotuned head under ``"head"``."""
    from repro_torch.kernels.autotune import plan_cache_stats, plan_search
    from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                                   complete_static)
    t0 = time.perf_counter()
    auto = SparseLogitHead.build(head.weight, plan="auto")
    search_s = time.perf_counter() - t0
    hits = plan_cache_stats()["hits"]
    again = SparseLogitHead.build(head.weight, plan="auto")
    if again.plan is not auto.plan or plan_cache_stats()["hits"] != hits + 1:
        raise AssertionError("second plan='auto' build missed the cache")
    zero_spmm_counters()
    auto_singles = [complete_static(params, cfg, p, new,
                                    sampling=SamplingConfig(), head=auto)
                    for p in prompts]
    torch.cuda.synchronize()
    auto_launches = spmm_counters()
    auto_expect = {"maple_spmm_naive": cfg.n_layers * 4 * new,
                   "maple_spmm_compact": 0, "maple_spmm_planned": 0}
    auto_expect[PLANNED[auto.plan.fused]] += 4 * new
    if auto_launches != auto_expect:
        raise AssertionError(f"autotuned head launches {auto_launches}, "
                             f"expected {auto_expect}")
    if [t for t, _, _ in auto_singles] != [t for t, _, _ in singles]:
        raise AssertionError("the autotuned head's greedy tokens differ "
                             "from the default head's")
    _, rep = plan_search(head.weight, full=True)        # the cached search
    return {"config": rep.best_config, "fused": auto.plan.fused,
            "n_candidates": rep.n_candidates, "n_built": rep.n_built,
            "best_score": rep.best_score,
            "default_score": rep.default_score, "search_s": search_s,
            "cache_hit_on_rebuild": True, "launches": auto_launches,
            "tokens_equal_default_head": True, "head": auto}


# --------------------------------------------------------------------------
# phase 5: one train step of the smoke config, card against CPU
# --------------------------------------------------------------------------

def grads_close(got, want, what):
    """Within 1e-4·max|want| + 1e-6: f32 sums in another order through a
    whole model (the CPU parity tests' tolerance)."""
    err = float((got.float().cpu() - want.float()).abs().max())
    limit = 1e-4 * float(want.abs().max()) + 1e-6
    if not err <= limit:
        raise AssertionError(f"{what}: max|card - cpu| = {err} > {limit}")
    return err


def train_against_cpu(cfg, batch, cpu, n_micro=2, meshes=None):
    """The loss and every gradient of ``batch`` under the trainer's
    parameters ``cpu`` (per-layer layout) on the card against the CPU,
    then one ``make_train_step`` step (``n_micro`` microbatches) on both
    from the same weights: (losses, largest gradient error, number of
    gradients, largest parameter error after the step, lr).  ``meshes``
    maps ``"cpu"`` and ``"cuda"`` to the mesh bound around each side's
    forward and backward (none without it)."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import lm
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.optimizer import named_leaves, tree_map
    own = lambda tree, dev: tree_map(lambda t: t.detach().to(dev).clone(),
                                     tree)
    grads, losses = {}, {}
    for name, params, dev in (("cpu", own(cpu, "cpu"), "cpu"),
                              ("cuda", own(cpu, "cuda"), "cuda")):
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        with use_mesh((meshes or {}).get(dev)):
            loss, _ = lm.loss_fn(params, cfg, {k: v.to(dev) for k, v in
                                               batch.items()},
                                 mlp_plan=lm.sparse_mlp_plan(params))
            loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {k: t.grad.detach().cpu().clone()
                       for k, t in named_leaves(params)}
    if not abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"]):
        raise AssertionError(f"card loss {losses['cuda']} != cpu "
                             f"{losses['cpu']}")
    grad_err = max(grads_close(grads["cuda"][k], g, f"grad {k}")
                   for k, g in grads["cpu"].items())
    # one optimizer step of the train step on both, from the same weights
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=10)
    after = {}
    for name, dev in (("cpu", "cpu"), ("cuda", "cuda")):
        params = tree_map(lambda t: t.detach().to(dev).clone(), cpu)
        step = make_train_step(cfg, ocfg, n_micro,
                               mlp_plan=lm.sparse_mlp_plan(params))
        with use_mesh((meshes or {}).get(dev)):
            params, _, m = step(params, init_opt_state(ocfg, params),
                                {k: v.to(dev) for k, v in batch.items()})
        after[name] = {k: t.detach() for k, t in named_leaves(params)}
    lr = float(m["lr"])
    param_err = max(float((after["cuda"][k].cpu() - p).abs().max())
                    for k, p in after["cpu"].items())
    if not param_err <= 2 * lr:
        raise AssertionError(f"params after one step differ by {param_err} "
                             f"> 2·lr = {2 * lr}")
    return losses, grad_err, len(grads["cpu"]), param_err, lr


def train_reference():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), sparse_mlp=True,
                              sparse_block=(8, 8))
    cpu = lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(SEED), device="cpu"))
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=SEED), 0)
    losses, grad_err, n_grads, param_err, lr = train_against_cpu(cfg, batch,
                                                                 cpu)
    return {"phase": "train_reference", "config": "qwen3-4b smoke, "
            "sparse_mlp (8,8), 4 x 16 tokens, 2 microbatches",
            "loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"],
            "grad_max_abs_err": grad_err, "n_grads": n_grads,
            "param_max_abs_err_after_step": param_err, "lr": lr}


# --------------------------------------------------------------------------
# the captured train step (a CUDA graph) against the eager step
# --------------------------------------------------------------------------

def train_graph(run, batch, mesh=None):
    """The captured step of a launcher ``run`` (``train.jitted_train_step``):
    one capture, a replay every step after the warm-up; its capture ms,
    nodes and pool; the steps' walls as warm-up, capture and replays; the
    host syncs of one more replayed step on ``batch`` under the run's
    ``mesh`` (none allowed: the loss read after it is outside it); the
    GiB the card holds after it."""
    from repro_torch.distributed.sharding import use_mesh
    graph = run.step_fn.graph
    steps = len(run.history)
    if not graph.captured or (graph.captures, graph.replays) != (1,
                                                                 steps - 1):
        raise AssertionError(f"{graph.name}: {graph.captures} captures, "
                             f"{graph.replays} replays over {steps} steps")
    with use_mesh(mesh):
        syncs = host_syncs(lambda: run.step_fn(run.params, run.opt, batch))
    if graph.replays != steps:
        raise AssertionError(f"{graph.name} did not replay on the same "
                             f"tensors")
    if syncs:
        raise AssertionError(f"a replayed step of {graph.name} synced the "
                             f"host: {syncs}")
    torch.cuda.synchronize()
    step_ms = [rec["step_s"] * 1e3 for rec in run.history]
    return {"capture_ms": graph.capture_ms, "nodes": graph.nodes,
            "pool_gib": graph.pool_bytes / 2**30,
            "step_ms_warm_up": step_ms[0], "step_ms_capture": step_ms[1],
            "step_ms_replayed": step_ms[2:],
            "host_syncs_replayed_step": len(syncs),
            "reserved_gib_after": torch.cuda.memory_reserved() / 2**30}


def host_leaves(params) -> dict:
    """Every parameter leaf copied to the host, by path."""
    from repro_torch.train.optimizer import named_leaves
    return {k: t.detach().cpu() for k, t in named_leaves(params)}


def leaf_gaps(a, b) -> dict:
    """Per leaf of two ``host_leaves`` the largest |a - b|, only where
    they differ."""
    return {k: float((t.double() - b[k].double()).abs().max())
            for k, t in a.items() if not torch.equal(t, b[k])}


def without_state(run):
    """``run``'s record without its parameters, optimizer state and step
    (the captured step holds its graph and the parameters), so that the
    card can be freed for an eager run of the same steps."""
    return dataclasses.replace(run, params=None, opt=None, step_fn=None)


def eager_train(spec, totals=()):
    """The steps a launcher run took (``spec``: its ``without_state``),
    from the seed it started from, on its data, through
    ``make_train_step`` itself, no graph; then one more step profiled.
    Returns (parameters, [(loss, grad norm)] a step, peak GiB, the
    profile with each step's wall up to its loss on the host)."""
    from repro_torch.data import synth_batch
    from repro_torch.models import lm
    from repro_torch.train import init_opt_state, make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = spec.device
    gen = torch.Generator(device=dev).manual_seed(spec.data.seed)
    params = lm.unstack_layers(lm.init_params(spec.cfg, gen, device=dev))
    opt = init_opt_state(spec.opt_cfg, params)
    step = make_train_step(spec.cfg, spec.opt_cfg, spec.micro_batches,
                           mlp_plan=lm.sparse_mlp_plan(params))
    batch = lambda i: {k: v.to(dev) for k, v in synth_batch(
        spec.data, i, spec.extra).items()}
    metrics, walls = [], []
    for i in range(len(spec.history)):
        b = batch(i)
        t0 = time.perf_counter()       # as the launcher: up to the loss
        params, opt, m = step(params, opt, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    after = host_leaves(params)
    nxt = batch(len(spec.history))
    prof = profile(lambda: step(params, opt, nxt), warmup=False,
                   totals=totals)
    del params, opt, step, nxt
    torch.cuda.empty_cache()
    return after, metrics, peak_gib, {**prof, "step_ms": walls}


def held_against_eager(spec, captured, what, totals=()):
    """A captured run (``spec``, its parameters ``captured`` on the host)
    against the same steps run eagerly: losses, grad norms and every
    parameter bit for bit.  Where they differ, the eager run is repeated:
    if two eager runs are bit-equal the replay is at fault; if not, the
    gap between them is recorded and the replay held to the card-against-
    CPU tolerance (losses 1e-5 relative, grad norms 1e-4, parameters
    within 2·lr a step)."""
    want = [(r["loss"], r["grad_norm"]) for r in spec.history]
    eager, got, peak_gib, prof = eager_train(spec, totals)
    diffs = leaf_gaps(captured, eager)
    line = {"eager_peak_gib": peak_gib, "eager_profile": prof,
            "eager_loss": [m[0] for m in got],
            "eager_grad_norm": [m[1] for m in got],
            "bit_equal": got == want and not diffs}
    if line["bit_equal"]:
        return {**line, "eager_gap": None}
    again, got2, _, _ = eager_train(spec)
    gap = leaf_gaps(again, eager)
    if got2 == got and not gap:
        raise AssertionError(
            f"{what}: the replayed steps differ from the eager step, which "
            f"is bit-stable: losses {want} against {got}, parameters "
            f"{dict(list(diffs.items())[:5])}")
    lrs = sum(r["lr"] for r in spec.history)
    for (loss, gn), (l2, g2) in zip(want, got):
        if not (abs(loss - l2) <= 1e-5 * abs(l2)
                and abs(gn - g2) <= 1e-4 * abs(g2)):
            raise AssertionError(f"{what}: replay {loss} / {gn} against "
                                 f"eager {l2} / {g2}")
    over = {k: v for k, v in diffs.items() if v > 2 * lrs}
    if over:
        raise AssertionError(f"{what}: parameters past 2·lr a step "
                             f"({2 * lrs}): {dict(list(over.items())[:5])}")
    return {**line, "eager_gap": {
        "loss": [a[0] - b[0] for a, b in zip(got, got2)],
        "grad_norm": [a[1] - b[1] for a, b in zip(got, got2)],
        "params": dict(sorted(gap.items(), key=lambda kv: -kv[1])[:8]),
        "n_params_differ": len(gap)},
        "replay_against_eager": {
            "params": dict(sorted(diffs.items(), key=lambda kv: -kv[1])[:8]),
            "n_params_differ": len(diffs), "limit": 2 * lrs}}


# --------------------------------------------------------------------------
# phase 6: train qwen3-4b at full width and depth
# --------------------------------------------------------------------------

def add_sparse_train_launches(expect, cfg, plan, steps, micro=None):
    """Add a sparse-MLP train run's launches to ``expect``: per layer and
    microbatch (``micro``, else the config's), the MLP forward and its
    remat recompute in the forward plan's layout, dB in the transpose-side
    plan's, dA on the SDDMM (the trainer's plan: the same knobs from the
    same pattern).  A partitioned plan runs B1 once a column panel for
    each shard that holds a run, on each side, and B2 once a shard and
    panel (every shard holds the plan's slot capacity)."""
    from repro_torch.kernels import PartitionedSpmmPlan
    per_layer = (micro or cfg.train_microbatches) * cfg.n_layers * steps
    fwd_calls = 2 if cfg.remat else 1
    if isinstance(plan.fwd, PartitionedSpmmPlan):
        b1 = lambda p: p.n_col_shards * sum(int(s.runs.shape[0] > 0)
                                             for s in p.shards)
        expect["maple_spmm_compact"] += per_layer * (
            fwd_calls * b1(plan.fwd) + b1(plan.bwd))
        expect["maple_sddmm_bsr"] += (per_layer * plan.fwd.n_shards
                                      * plan.fwd.n_col_shards)
        return
    expect["maple_sddmm_bsr"] += per_layer
    expect[PLANNED[plan.fwd.fused]] += per_layer * fwd_calls
    expect[PLANNED[plan.bwd.fused]] += per_layer


def train(card):
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_spmm_counters()
    maple_sddmm_bsr.launches = 0
    t0 = time.perf_counter()
    run = launch_train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {**spmm_counters(),
                "maple_sddmm_bsr": maple_sddmm_bsr.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = run.cfg
    steps, tokens = len(run.history), 4 * 256
    micro = cfg.train_microbatches
    plan = lm.sparse_mlp_plan(run.params)
    expect = {"maple_spmm_naive": 0, "maple_spmm_compact": 0,
              "maple_spmm_planned": 0, "maple_sddmm_bsr": 0}
    add_sparse_train_launches(expect, cfg, plan, steps)
    fused = [plan.fwd.fused, plan.bwd.fused]
    if launches != expect:
        raise AssertionError(f"kernel launches on the train path "
                             f"{launches}, expected {expect}")
    for rec in run.history:
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
            raise AssertionError(f"non-finite step {rec}")
    captured = host_leaves(run.params)
    # more replayed steps, outside the counted run: one under the sync
    # debug mode, one under the profiler
    from repro_torch.data import synth_batch
    batch = {k: v.cuda() for k, v in synth_batch(run.data, steps).items()}
    graph = train_graph(run, batch)
    # the run walk (B1 / B4) and the block SDDMM (B2), summed by name
    totals = ("run_kernel", "sddmm_kernel")
    prof = profile(lambda: run.step_fn(run.params, run.opt, batch),
                   warmup=False, totals=totals)
    spec = without_state(run)
    del run, batch, plan
    held = held_against_eager(spec, captured, "train", totals)
    del captured
    replayed = graph["step_ms_replayed"]
    return launches, {
        "phase": "train", "config": "qwen3-4b sparse_mlp (64,64) d=0.25, "
        "f32, AdamW, remat per layer", "argv": TRAIN_ARGV,
        "n_layers": cfg.n_layers, "depth_reduced": False,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "vocab_size": cfg.vocab_size, "microbatches": micro,
        "tokens_per_step": tokens,
        "loss": [rec["loss"] for rec in spec.history],
        "grad_norm": [rec["grad_norm"] for rec in spec.history],
        "step_ms": [rec["step_s"] * 1e3 for rec in spec.history],
        "graph": graph,
        "tok_per_s_replayed": [tokens / (ms / 1e3) for ms in replayed],
        "run_s": total_s, "peak_mem_gib": peak_gib, "launches": launches,
        "launches_expected": expect, "plan_fused": fused,
        "held_against_eager": held, "card": card, "profile": prof}


# --------------------------------------------------------------------------
# phase 7: backward through a full-size trainable sparse head
# --------------------------------------------------------------------------

def head_backward():
    from repro_torch.core.csr import transpose_payload
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_bsr,
                                                 maple_sddmm_bsr_plain)
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact_plain,
                                                maple_spmm_planned_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import SparseLogitHead
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    w = init_sparse_linear(gen, HEAD["d_in"], HEAD["d_out"],
                           block_shape=HEAD["block"],
                           block_density=HEAD["density"])
    t0 = time.perf_counter()
    head = SparseLogitHead.build(w, n_lanes=HEAD["n_lanes"], trainable=True)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 5)
    hidden = torch.from_numpy(rng.standard_normal((1, 4, HEAD["d_in"]))
                              .astype(np.float32)).cuda().requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((1, 4, HEAD["d_out"]))
                           .astype(np.float32)).cuda()
    blocks = w.blocks.clone().requires_grad_()
    trained = SparseLogitHead(weight=dataclasses.replace(w, blocks=blocks),
                              plan=head.plan)
    train = head.plan
    zero_spmm_counters()
    maple_sddmm_bsr.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (trained(hidden) * cot).sum().backward()
    torch.cuda.synchronize()
    fwd_bwd_ms = (time.perf_counter() - t0) * 1e3
    launched = {**spmm_counters(), "maple_sddmm_bsr": maple_sddmm_bsr.launches}
    # the forward in the forward plan's layout, dB in the transpose-side
    # plan's, dA on the SDDMM
    expect = {"maple_spmm_naive": 0, "maple_spmm_compact": 0,
              "maple_spmm_planned": 0, "maple_sddmm_bsr": 1}
    expect[PLANNED[train.fwd.fused]] += 1
    expect[PLANNED[train.bwd.fused]] += 1
    if launched != expect:
        raise AssertionError(f"head forward+backward launched {launched}, "
                             f"expected {expect}")
    # the same two gradients from the kernels' plain versions
    d = train.on_device(cot.device)
    bm, bk = w.block_shape
    dc = cot.transpose(1, 2).contiguous()                  # (1, V, 4)
    b3 = hidden.detach().transpose(1, 2).contiguous()      # (1, D, 4)
    at = transpose_payload(w.blocks, d["t_perm"], w.n_blocks_max)
    bwd = train.bwd.on_device(dc.device)
    if train.bwd.fused == "rmw":
        db = maple_spmm_planned_plain(at, bwd["order"], bwd["step_col"],
                                      bwd["row_runs"], bwd["row_run_ptr"],
                                      dc)
    else:
        n_slots = train.bwd.n_lanes * train.bwd.r_max
        tiles = maple_spmm_compact_plain(at, bwd["order"], bwd["step_col"],
                                         bwd["runs"], dc, n_slots=n_slots)
        db = _scatter_merge_f32(tiles.view(1, n_slots, bk, 4), bwd["merge"],
                                gm=train.bwd.n_block_rows)
    da = maple_sddmm_bsr_plain(dc, b3, d["block_row"], d["block_col"],
                               bm=bm, bk=bk)
    err_x = check_close(hidden.grad, db.transpose(1, 2), torch.float32,
                        "head dhidden")
    err_w = check_close(blocks.grad, da, torch.float32, "head dW")
    return {"phase": "head_backward", "shape": HEAD["name"], "G": 1, "N": 4,
            "plan_spmm_vjp_s": build_s, "fwd_runs": int(train.fwd.runs
                                                        .shape[0]),
            "bwd_runs": int(train.bwd.runs.shape[0]),
            "fwd_bwd_ms": fwd_bwd_ms, "dhidden_max_abs_err": err_x,
            "dW_max_abs_err": err_w, "launches": launched,
            "plan_fused": [train.fwd.fused, train.bwd.fused]}


# --------------------------------------------------------------------------
# the mesh-partitioned SpMM: B1 + the row-offset merge and B2 per shard
# --------------------------------------------------------------------------

# (n_shards, n_col_shards) of the head and of the MLP at its train shape
PARTITION_HEAD = ((1, 1), (2, 1), (4, 1), (2, 2))
PARTITION_MLP = ((1, 1), (4, 1), (2, 2))


def device_ms(fn, calls: int = 10) -> float:
    """Device ms a call of ``fn`` with the host kept ahead: a sleep kernel
    holds the card while the host enqueues ``calls`` back-to-back calls,
    so the events around them time the card alone (no L2 flush between
    calls).  ``time_ms`` on a call whose host dispatch outlasts its
    kernels times the host instead."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)          # at least 0.2 s at 1.98 GHz
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host_s > 0.15:
        raise AssertionError(f"enqueueing {calls} calls took {host_s} s: "
                             f"the card may have waited for the host")
    return start.elapsed_time(end) / calls


# --------------------------------------------------------------------------
# captured decode steps (CUDA graphs) against the eager step
# --------------------------------------------------------------------------

GRAPH_STEPS = 8       # replays held against the eager step
GRAPH_TIMED = 8       # replays timed after them


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def tree_pairs(got, want, path="state"):
    """(name, got, want) of each tensor leaf of two trees of one layout."""
    if isinstance(got, dict):
        for k in got:
            yield from tree_pairs(got[k], want[k], f"{path}/{k}")
    elif torch.is_tensor(got):
        yield path, got, want


def held_equal(pairs, step, differs, what):
    """Each (name, got, want) ``torch.equal``; one that is not (cuBLAS
    taking another algorithm under capture) is recorded in ``differs``
    and held within 1e-5·max + 1e-6."""
    for name, got, want in pairs:
        if torch.equal(got, want):
            continue
        err = float((got.double() - want.double()).abs().max())
        top = float(want.double().abs().max())
        differs.append({"step": step, "tensor": name, "max_abs_err": err,
                        "max_abs": top})
        if not err <= 1e-5 * top + 1e-6:
            raise AssertionError(f"{what}: replay {step} differs from the "
                                 f"eager step at {name} by {err} (max "
                                 f"{top})")


def release_graphs():
    """Drop every cached decode callable's graph, and the weights and
    state it holds."""
    from repro_torch.serve.engine import release_graphs as release
    release()


def graph_numbers(graph):
    return {"captures": graph.captures, "capture_ms": graph.capture_ms,
            "nodes": graph.nodes, "pool_bytes": graph.pool_bytes}


def replay_check(params, cfg, state, tokens, what):
    """``serve.jitted_decode_step(cfg)`` on ``state``: its eager warm-up,
    its capture and ``GRAPH_STEPS`` replays, each against the eager
    ``lm.decode_step`` on a copy of the state fed the same greedy tokens
    (logits and every cache ``torch.equal``, else ``held_equal``; each
    call's launches equal to the eager step's); then ``GRAPH_TIMED``
    replays timed on the host clock as ``decode_step_ms`` times the eager
    step, and one under ``profile``.  Drops the graph after."""
    from repro_torch.kernels import launch_counters
    from repro_torch.models import lm
    from repro_torch.serve import jitted_decode_step
    fn = jitted_decode_step(cfg)
    graph = fn.graph
    counters = launch_counters()
    counts = lambda: {k: f.launches for k, f in counters.items()}  # noqa
    before = graph.captures, graph.replays
    other = tree_clone(state)
    differs = []
    for step in range(GRAPH_STEPS + 1):
        c0 = counts()
        out, state = fn(params, state=state, tokens=tokens)
        c1 = counts()
        want, other = lm.decode_step(params, cfg, other, tokens)
        c2 = counts()
        mine = {k: c1[k] - c0[k] for k in c0}
        eager = {k: c2[k] - c1[k] for k in c0}
        if mine != eager:
            raise AssertionError(f"{what}: call {step} counted {mine}, the "
                                 f"eager step {eager}")
        if state["pos"] != other["pos"]:
            raise AssertionError(f"{what}: pos {state['pos']} against "
                                 f"{other['pos']}")
        held_equal([("logits", out, want), *tree_pairs(
            {k: v for k, v in state.items() if k != "pos"},
            {k: v for k, v in other.items() if k != "pos"})], step, differs,
            what)
        tokens = want[:, -1, :cfg.vocab_size].argmax(-1)[:, None].to(
            tokens.dtype)
    if (graph.captures - before[0], graph.replays - before[1]) != \
            (1, GRAPH_STEPS):
        raise AssertionError(f"{what}: {graph.captures - before[0]} captures"
                             f", {graph.replays - before[1]} replays")
    del other
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAPH_TIMED):
        _, state = fn(params, state=state, tokens=tokens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_TIMED
    prof = profile(lambda: fn(params, state=state, tokens=tokens),
                   warmup=False)
    line = {"replays_held": GRAPH_STEPS, "bit_equal": not differs,
            "n_differs": len(differs), "differs": differs[:8],
            "replayed_decode_step_ms": wall_ms,
            "replayed_device_ms": prof["device_ms"],
            "replayed_launches": prof["launches"],
            "replayed_profile_wall_ms": prof["wall_ms"],
            **graph_numbers(graph)}
    release_graphs()
    return line


def fused_graph_check(params, cfg, head, max_slots, page_size, prompt=64):
    """The batcher's fused step (the paged step and the head, one graph)
    at full occupancy: ``max_slots`` requests of ``prompt`` tokens
    admitted at round 0, whose fused step is the graph's eager warm-up;
    then ``GRAPH_STEPS`` rounds, the first capturing, each fused step held
    against the eager one (``ContinuousBatcher._fused``) on a copy of the
    caches fed the same packed (tokens | pos | table): logits, the new
    positions and every cache ``torch.equal`` (else ``held_equal``).  Each
    fused step is timed alone (the call, then a synchronize), replayed
    and eager; then ``GRAPH_TIMED`` rounds' walls (host clock)."""
    from repro_torch.serve import (BatcherConfig, ContinuousBatcher, Request,
                                   RequestQueue)
    from repro_torch.serve.workload import worst_pool
    rng = np.random.default_rng(SEED + 11)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, prompt)
                    .astype(np.int32),
                    max_new_tokens=GRAPH_STEPS + GRAPH_TIMED + 4, rid=i)
            for i in range(max_slots)]
    queue = RequestQueue()
    queue.submit_all(reqs)
    eng = ContinuousBatcher(params, cfg, queue, BatcherConfig(
        max_slots=max_slots, page_size=page_size,
        n_pages=worst_pool(reqs, max_slots, page_size),
        max_seq=prompt + GRAPH_STEPS + GRAPH_TIMED + 8), head=head)
    eng.step(0.0)
    if eng.live() != max_slots or eng.graph.captured:
        raise AssertionError("the fused check's first round")
    replayed = eng._decode
    differs, replay_ms, eager_ms = [], [], []

    def checked(host):
        caches = {k: v for k, v in eng.state.items()
                  if k not in ("pos", "table")}
        copy = tree_clone(caches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, new_state = replayed(host)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want, pos, _ = eng._fused(copy, torch.from_numpy(host).to(
            eng.device))
        torch.cuda.synchronize()
        replay_ms.append((t1 - t0) * 1e3)
        eager_ms.append((time.perf_counter() - t1) * 1e3)
        held_equal([("logits", out, want), ("pos", new_state["pos"], pos),
                    *tree_pairs(caches, copy)], len(eager_ms), differs,
                   "the fused step")
        return out, new_state

    eng._decode = checked
    for t in range(1, GRAPH_STEPS + 1):
        eng.step(float(t))
    del eng._decode
    if (eng.graph.captures, eng.graph.replays) != (1, GRAPH_STEPS):
        raise AssertionError(f"the fused step: {eng.graph.captures} "
                             f"captures, {eng.graph.replays} replays")
    walls = []
    for t in range(GRAPH_TIMED):
        t0 = time.perf_counter()
        eng.step(float(GRAPH_STEPS + 1 + t))
        walls.append((time.perf_counter() - t0) * 1e3)
    if eng.live() != max_slots:
        raise AssertionError("the fused check's rounds retired a request")
    line = {"slots": max_slots, "prompt": prompt,
            "replays_held": GRAPH_STEPS, "bit_equal": not differs,
            "n_differs": len(differs), "differs": differs[:8],
            # the first replay follows its capture (timed with it)
            "replayed_step_ms": replay_ms[1:],
            "replayed_step_ms_median": statistics.median(replay_ms[1:]),
            "capture_and_first_replay_ms": replay_ms[0],
            "eager_step_ms": eager_ms,
            "eager_step_ms_median": statistics.median(eager_ms),
            "round_wall_ms": walls,
            "round_wall_ms_median": statistics.median(walls),
            **graph_numbers(eng.graph)}
    del eng
    return line


def greedy_steps(r, want, got, rows, vocab, what):
    """Request ``r``'s greedy tokens ``got`` against ``want``, whose
    step-t logits are ``rows[t]``, step by step: a differing token fails
    unless that step's top-2 margin is within the f32 tolerance
    (1e-5·max|row| + 1e-6; the two paths sum in different orders), and
    from it on the two may diverge.  Returns the steps compared."""
    steps = []
    for t in range(len(want)):
        row = rows[t][:vocab]
        top2 = torch.topk(row, 2).values
        margin = float(top2[0] - top2[1])
        limit = 1e-5 * float(row.abs().max()) + 1e-6
        same = t < len(got) and want[t] == got[t]
        steps.append({"request": r, "step": t, "margin": margin,
                      "equal": same})
        if not same:
            if margin > limit:
                raise AssertionError(
                    f"request {r} step {t}: {what} chose "
                    f"{got[t] if t < len(got) else None}, the reference "
                    f"path {want[t]}, top-2 margin {margin} > {limit}")
            break                         # the requests diverge from here
    return steps


class RecordingHead:
    """A logit head that keeps each call's last-position logits (f32, on
    the card) beside what it returns."""

    def __init__(self, head):
        self.head, self.rows = head, []

    def __call__(self, hidden):
        logits = self.head(hidden)
        self.rows.append(logits[0, -1].float())
        return logits


def partitioned(spec, flush, card):
    """The mesh-partitioned SpMM on the card at full width (module
    docstring, phase 7a): the head at every (D, C) of
    :data:`PARTITION_HEAD`, the MLP's forward and backward at
    :data:`PARTITION_MLP`, and served tokens through the head at (4, 1)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import (maple_sddmm_bsr, maple_spmm,
                                     plan_partitioned_spmm,
                                     plan_partitioned_spmm_vjp, plan_spmm,
                                     plan_spmm_vjp)
    from repro_torch.distributed import sharding
    from repro_torch.kernels.ops import (_partitioned_tiles, _planned_spmm_f32,
                                         _scatter_merge_f32)
    from repro_torch.models import lm
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                                   complete_static)

    def counters():
        return {**spmm_counters(), "maple_sddmm_bsr": maple_sddmm_bsr.launches}

    def zero():
        zero_spmm_counters()
        maple_sddmm_bsr.launches = 0

    def bound(w, n, plan):
        nbytes, flops = spmm_cost(
            w, 1, n, 4, out_bytes=w.shape[0] * n * 4,
            meta_bytes=4 * 2 * plan.order.size + 16 * plan.runs.shape[0])
        return max(nbytes / spec[0], flops / spec[1][torch.float32]) * 1e3

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    hw = init_sparse_linear(gen, HEAD["d_in"], HEAD["d_out"],
                            block_shape=HEAD["block"],
                            block_density=HEAD["density"])
    lanes = HEAD["n_lanes"]
    single = {"rmw": plan_spmm(hw, n_lanes=lanes),
              "compact": plan_spmm(hw, n_lanes=lanes, fused="compact")}
    compact_head = SparseLogitHead(weight=hw, plan=single["compact"])
    hiddens = {n: torch.from_numpy(rng.standard_normal((1, n, HEAD["d_in"]))
                                   .astype(np.float32)).cuda()
               for n in HEAD["N"]}
    # the plain versions: the port's executor on CPU copies of the head
    cpu_blocks = hw.blocks.cpu()
    cases, heads = [], {}
    for d_, c_ in PARTITION_HEAD:
        t0 = time.perf_counter()
        # build keeps one shard single-device, as the reference does, so
        # (1, 1) asks the partitioned planner itself
        head = (SparseLogitHead.build(hw, n_lanes=lanes, n_shards=d_,
                                      n_col_shards=c_) if d_ * c_ > 1 else
                SparseLogitHead(weight=hw, plan=plan_partitioned_spmm(
                    hw, n_shards=1, n_lanes=lanes)))
        plan_s = time.perf_counter() - t0
        plan = head.plan
        heads[(d_, c_)] = head
        for n, hidden in hiddens.items():
            b3 = hidden.transpose(1, 2).contiguous()          # (1, D, N)
            zero()
            got = head(hidden)
            torch.cuda.synchronize()
            per_call = counters()
            if not torch.equal(head(hidden), got):
                raise AssertionError(f"partitioned head {(d_, c_)} N={n} "
                                     f"is not bit-identical over two runs")
            want = compact_head(hidden)
            if (d_, c_) == (1, 1):
                if not torch.equal(got, want):
                    raise AssertionError("the one-shard head differs from "
                                         "the single-device compact head")
                err = 0.0
            else:
                err = check_close(got, want, torch.float32,
                                  f"partitioned head {(d_, c_)} N={n}")
            plain = _planned_spmm_f32(cpu_blocks, b3.cpu(), plan, bn=128)
            plain_err = check_close(got, plain.transpose(1, 2).cuda(),
                                    torch.float32,
                                    f"partitioned head {(d_, c_)} N={n} "
                                    f"against the plain versions")
            del plain
            tiles = _partitioned_tiles(hw.blocks, b3, plan, bn=128)
            merge = plan.on_device(b3.device)["merge"]
            cases.append({
                "case": "head", "D": d_, "C": c_, "N": n, "plan_s": plan_s,
                "padding_waste": plan.padding_waste,
                "shard_steps": list(plan.shard_steps),
                "shard_runs": [int(p.runs.shape[0]) for p in plan.shards],
                "launches_per_call": per_call,
                "merge_steps_per_call": len(plan.merge_ranks),
                "max_abs_err_vs_compact": err,
                "max_abs_err_vs_plain": plain_err,
                "ms": time_ms(lambda: _planned_spmm_f32(
                    hw.blocks, b3, plan, bn=128), REPS, flush),
                "b1_ms": time_ms(lambda: _partitioned_tiles(
                    hw.blocks, b3, plan, bn=128), REPS, flush),
                "epilogue_ms": time_ms(lambda: _scatter_merge_f32(
                    tiles, merge, gm=plan.n_block_rows), REPS, flush),
                "bound_ms": bound(hw, n, single["compact"])})
            del tiles
    del cpu_blocks
    # the mesh branch on the one card: a mesh of "cuda" entries is another
    # device than the payload's cuda:0, so every shard takes its own blocks
    head, hidden = heads[(4, 1)], hiddens[max(HEAD["N"])]
    loop = head(hidden)
    mesh = sharding.Mesh([torch.device("cuda")] * 4,
                         (sharding.PARTITION_AXIS,))
    with sharding.use_mesh(mesh):
        on_mesh = head(hidden)
        kept = [sd["payload"][hw.blocks][1] for sd in
                head.plan.on_device(torch.device("cuda"))["shards"]]
        again = head(hidden)
        reused = all(sd["payload"][hw.blocks][1] is k for sd, k in zip(
            head.plan.on_device(torch.device("cuda"))["shards"], kept))
    if not (torch.equal(on_mesh, loop) and torch.equal(again, loop)):
        raise AssertionError("the mesh branch of the head at (4, 1) differs "
                             "from the stacked loop")
    if not reused:
        raise AssertionError("the mesh branch copied a shard's blocks again "
                             "for an unchanged payload")
    mesh_check = {"head": [4, 1], "N": max(HEAD["N"]),
                  "bit_equal_to_loop": True, "payload_kept": reused,
                  "kept_bytes": sum(k.numel() * k.element_size()
                                    for k in kept)}
    del kept, on_mesh, again, loop
    singles = []
    for n, hidden in hiddens.items():
        b3 = hidden.transpose(1, 2).contiguous()
        singles.append({
            "case": "head single-device", "N": n,
            "b4_ms": time_ms(lambda: _planned_spmm_f32(
                hw.blocks, b3, single["rmw"], bn=128), REPS, flush),
            "b1_merge_ms": time_ms(lambda: _planned_spmm_f32(
                hw.blocks, b3, single["compact"], bn=128), REPS, flush),
            "bound_ms": bound(hw, n, single["compact"])})

    # the MLP down-projection at its train shape, forward and backward
    mw = init_sparse_linear(gen, MLP["d_in"], MLP["d_out"],
                            block_shape=MLP["block"],
                            block_density=MLP["density"])
    n_tok = TRAIN_MLP["N"][0]
    blocks = mw.blocks.detach().requires_grad_()
    w_leaf = dataclasses.replace(mw, blocks=blocks)
    x = torch.from_numpy(rng.standard_normal((1, MLP["d_in"], n_tok))
                         .astype(np.float32)).cuda().requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((1, MLP["d_out"], n_tok))
                           .astype(np.float32)).cuda()

    def fwd_bwd(plan):
        out = maple_spmm(w_leaf, x, plan=plan)
        return (out.detach(), *torch.autograd.grad(out, (blocks, x), cot))

    mlp_single = plan_spmm_vjp(mw, fused="compact")
    want = fwd_bwd(mlp_single)
    single_ms = time_ms(lambda: fwd_bwd(mlp_single), REPS, flush)
    default_plan = plan_spmm_vjp(mw)
    default_ms = time_ms(lambda: fwd_bwd(default_plan), REPS, flush)
    mlp_device = {"single_compact": device_ms(lambda: fwd_bwd(mlp_single)),
                  "single_default": device_ms(lambda: fwd_bwd(default_plan))}
    path = {k: 0 for k in counters()}
    for d_, c_ in PARTITION_MLP:
        t0 = time.perf_counter()
        # lm.sparse_mlp_plan's route; plan_spmm_vjp keeps one shard
        # single-device, so (1, 1) asks the partitioned planner itself
        tp = (plan_spmm_vjp(mw, n_shards=d_, n_col_shards=c_)
              if d_ * c_ > 1 else plan_partitioned_spmm_vjp(mw, n_shards=1))
        plan_s = time.perf_counter() - t0
        zero()
        got = fwd_bwd(tp)
        torch.cuda.synchronize()
        per_call = counters()
        if (d_, c_) != (1, 1):
            path = {k: path[k] + per_call[k] for k in path}
        again = fwd_bwd(tp)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"partitioned MLP {(d_, c_)} is not "
                                 f"bit-identical over two runs")
        if (d_, c_) == (1, 1):
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("the one-shard MLP differs from the "
                                     "single-device compact plan")
            errs = [0.0, 0.0, 0.0]
        else:
            errs = [check_close(a, b, torch.float32,
                                f"partitioned MLP {(d_, c_)} {what}")
                    for a, b, what in zip(got, want, ("out", "dA", "dB"))]
        cases.append({
            "case": "mlp fwd+bwd", "D": d_, "C": c_, "G": 1, "N": n_tok,
            "plan_s": plan_s, "padding_waste": [tp.fwd.padding_waste,
                                                tp.bwd.padding_waste],
            "shard_steps": [list(tp.fwd.shard_steps),
                            list(tp.bwd.shard_steps)],
            "launches_per_call": per_call,
            "merge_steps_per_call": (len(tp.fwd.merge_ranks)
                                     + len(tp.bwd.merge_ranks)),
            "max_abs_err_vs_compact": dict(zip(("out", "dA", "dB"), errs)),
            "ms": time_ms(lambda: fwd_bwd(tp), REPS, flush),
            "single_compact_ms": single_ms, "single_default_ms": default_ms,
            "device_ms": device_ms(lambda: fwd_bwd(tp)),
            "single_device_ms": mlp_device})
        del got, again

    # served tokens through the head at (4, 1) against the default head
    cfg = dataclasses.replace(get_config(SERVE_ARCH), sparse_mlp=True)
    params = lm.init_params(cfg, gen, device="cuda")
    prompt_len = int(rng.integers(16, 129))
    prompts = rng.integers(0, cfg.vocab_size, (4, prompt_len))
    new = 16
    base = RecordingHead(SparseLogitHead.build(hw, n_lanes=lanes))
    part = RecordingHead(heads[(4, 1)])
    want_tok = [complete_static(params, cfg, p, new,
                                sampling=SamplingConfig(), head=base)[0]
                for p in prompts]
    zero()
    got_tok = [complete_static(params, cfg, p, new,
                               sampling=SamplingConfig(), head=part)[0]
               for p in prompts]
    torch.cuda.synchronize()
    served = counters()
    path = {k: path[k] + served[k] for k in path}
    runs = sum(p.runs.shape[0] > 0 for p in heads[(4, 1)].plan.shards)
    expect = {"maple_spmm_naive": cfg.n_layers * 4 * new,
              "maple_spmm_compact": runs * 4 * new,
              "maple_spmm_planned": 0, "maple_sddmm_bsr": 0}
    if served != expect:
        raise AssertionError(f"served run through the partitioned head "
                             f"launched {served}, expected {expect}")
    steps = []
    for r, (w_t, g_t) in enumerate(zip(want_tok, got_tok)):
        steps += greedy_steps(r, w_t, g_t, base.rows[r * new:(r + 1) * new],
                              cfg.vocab_size, "the partitioned head")
    del params
    torch.cuda.empty_cache()
    n_dev = torch.cuda.device_count()
    return path, {
        "phase": "partitioned", "card": card,
        "head": HEAD["name"], "mlp": MLP["name"], "dtype": "float32",
        "device_count": n_dev,
        "mesh": ("one card: every (D, C) above 1 ran as the stacked "
                 "loop; a mesh of several cards was not run" if n_dev < 2
                 else "partition_mesh builds a private mesh where "
                 "device_count >= D·C"),
        "mesh_branch_on_one_card": mesh_check,
        "cases": cases, "single_device": singles,
        "served": {"arch": SERVE_ARCH, "requests": 4, "prompt_len":
                   prompt_len, "new_tokens": new, "head": [4, 1],
                   "tokens_equal": got_tok == want_tok,
                   "min_margin": min(s["margin"] for s in steps),
                   "steps_compared": len(steps),
                   "mismatches": [s for s in steps if not s["equal"]],
                   "launches": served}}


# --------------------------------------------------------------------------
# the autotuned plan path on the MLP and head weights
# --------------------------------------------------------------------------

def autotune(card):
    """``plan_search(measure=True, top_k=3)`` on the MLP down-projection and
    the head (the measured rung runs each finalist through ``maple_spmm``
    on the card); both layouts of the default knobs through ``maple_spmm``
    at the path's shapes (B4 against B1 + merge, bitwise); on the MLP
    only, the reordered plans (row-atomic bitwise, chunked within
    1e-5·max of the unpermuted run) and ELL and bitmap copies (bitwise
    against the BlockCSR route).  Launch counts run from zero over the
    whole phase."""
    from repro_torch.core import formats
    from repro_torch.kernels import (maple_spmm, plan_reordered_spmm,
                                     plan_search, plan_spmm, reorder_rows,
                                     spmm_knob_space)
    zero_spmm_counters()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    line = {"phase": "autotune", "card": card}
    for key, shape in (("mlp", TRAIN_MLP), ("head", TRAIN_HEAD)):
        w = sparse_weight(gen, shape, torch.float32)
        t0 = time.perf_counter()
        plan, rep = plan_search(w, measure=True, top_k=3, full=True)
        search_s = time.perf_counter() - t0
        cfgs = spmm_knob_space(w)
        b = torch.from_numpy(rng.standard_normal(
            (shape["d_in"], shape["N"][0])).astype(np.float32)).cuda()
        out = {f: maple_spmm(w, b, plan=plan_spmm(
            w, n_lanes=shape.get("n_lanes", 8), fused=f))
            for f in ("rmw", "compact")}
        torch.cuda.synchronize()
        if not torch.equal(out["rmw"], out["compact"]):
            raise AssertionError(f"{key}: rmw and compact layouts differ")
        entry = {"shape": shape["name"], "search_s": search_s,
                 "n_candidates": rep.n_candidates, "n_built": rep.n_built,
                 "winner": rep.best_config, "winner_fused": plan.fused,
                 "finalists": [{"config": cfgs[i], "fused": cfgs[i]["fused"],
                                "measured_us": us}
                               for i, us in sorted(rep.measured_us.items(),
                                                   key=lambda t: t[1])],
                 "layouts_bitwise_equal": True, "N": shape["N"][0]}
        if key == "mlp":
            t0 = time.perf_counter()
            rr = reorder_rows(w)
            entry["reorder_rows_s"] = time.perf_counter() - t0
            entry["reorder_identity"] = bool(
                (rr.perm == np.arange(rr.perm.size)).all())
            entry["reorder_blocks"] = [w.nnzb, rr.n_blocks]
            _, rrep = plan_search(w, reorder=True, full=True)
            entry["reorder_search_winner"] = rrep.best_config
            same = maple_spmm(w, b, plan=plan_reordered_spmm(
                w, rr, row_atomic=True))
            base = maple_spmm(w, b, plan=plan_spmm(w, row_atomic=True))
            if not torch.equal(same, base):
                raise AssertionError("reordered row-atomic run differs")
            entry["reorder_chunked_max_abs_err"] = check_close(
                maple_spmm(w, b, plan=plan_reordered_spmm(w, rr)),
                maple_spmm(w, b, plan=plan_spmm(w)), torch.float32,
                "reordered chunked run")
            base = maple_spmm(w, b)
            for fmt, conv in (("ell", formats.to_ell),
                              ("bitmap", formats.to_bitmap)):
                if not torch.equal(maple_spmm(conv(w), b), base):
                    raise AssertionError(f"{fmt} route differs from BSR")
            entry["ell_bitmap_bitwise_equal"] = True
        line[key] = entry
        del w, out
    torch.cuda.synchronize()
    launches = spmm_counters()
    line["launches"] = launches
    return launches, line


# --------------------------------------------------------------------------
# phase 8: the SpGEMM kernels against their plain versions
# --------------------------------------------------------------------------

def element_csr(mask, rng, dtype, pad=0):
    from repro_torch.core.csr import CSR
    d = (mask * rng.standard_normal(mask.shape)).astype(np.float32)
    c = CSR.from_dense(d, nnz_max=max(int(mask.sum()), 1) + pad,
                       device="cuda")
    return dataclasses.replace(c, value=c.value.to(dtype))


def spgemm_edge_operands(rng):
    """(name, A mask, B mask, n_lanes, at capacity): the element-pattern
    goldens, empty rows, an all-zero A, nnz exactly at capacity,
    zero-dimension operands, la = 1, lc = 1, pad steps (more lanes than
    rows), rows and panels wider than a warp (la, lb > 32), then the cases
    past each split of B5 and dB (``sparsity.spgemm_split_masks``)."""
    from repro_torch.core.sparsity import (SPGEMM_SPLIT_CASES,
                                           element_pattern_mask,
                                           spgemm_split_masks)
    cases = [(f"{kind}", element_pattern_mask(kind, rng, 40, 36),
              element_pattern_mask(kind, rng, 36, 44), 8, False)
             for kind in ("uniform", "power_law", "banded")]
    empty = rng.random((30, 20)) < 0.3
    empty[::3] = False
    one = np.zeros((24, 20), bool)
    one[np.arange(24), rng.integers(0, 20, 24)] = True
    diag = np.zeros((20, 20), bool)
    diag[np.arange(20), rng.permutation(20)] = True
    cases += [
        ("empty_rows", empty, rng.random((20, 26)) < 0.3, 3, False),
        ("all_zero_a", np.zeros((12, 10), bool), rng.random((10, 9)) < 0.5,
         2, False),
        ("at_capacity", rng.random((18, 15)) < 0.4,
         rng.random((15, 17)) < 0.4, 4, True),
        ("zero_m", np.zeros((0, 5), bool), rng.random((5, 4)) < 0.5, 8,
         False),
        ("zero_k", np.zeros((4, 0), bool), np.zeros((0, 5), bool), 8, False),
        ("zero_n", rng.random((5, 4)) < 0.5, np.zeros((4, 0), bool), 8,
         False),
        ("la_1", one, rng.random((20, 30)) < 0.3, 8, False),
        ("lc_1", diag, diag.copy(), 8, False),
        ("pad_steps", rng.random((3, 12)) < 0.5, rng.random((12, 10)) < 0.4,
         8, False),
        ("wide", rng.random((6, 80)) < 0.9, rng.random((80, 90)) < 0.9, 3,
         False)]
    # past each split of B5 and dB
    cases += [(name, *spgemm_split_masks(name, rng), 3, False)
              for name in SPGEMM_SPLIT_CASES]
    return cases


@contextlib.contextmanager
def pinned_route(route):
    """B5 on ``route`` (an index of its routes) whatever the plan: the
    edge cases are too small for the route the card would pick at
    scale."""
    mod = sys.modules["repro_torch.kernels.maple_spgemm"]
    pick = mod.numeric_route
    mod.numeric_route = lambda plan, device: route
    try:
        yield
    finally:
        mod.numeric_route = pick


def spgemm_kernels_edge():
    """B5, B6, dB and B7 against their plain versions on the edge cases,
    f32 and bf16; B5, B6 and dB twice each for bit identity."""
    from repro_torch.core.csr import grow_nnz_max
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.kernels import maple_spgemm, plan_spgemm
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                                 maple_sddmm_csr_plain)
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_db_plain,
                                                  maple_spgemm_numeric,
                                                  maple_spgemm_numeric_plain,
                                                  numeric_routes)
    from repro_torch.kernels.maple_spmspm import (maple_spmspm_ell,
                                                  maple_spmspm_ell_plain)
    rng = np.random.default_rng(SEED + 8)
    cases = bit_equal_plain = 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, am, bm, lanes, at_cap in spgemm_edge_operands(rng):
            a = element_csr(am, rng, dtype, pad=0 if at_cap else 2)
            b = element_csr(bm, rng, dtype, pad=0 if at_cap else 3)
            plan = plan_spgemm(a, b, n_lanes=lanes)
            cap = plan.nnz_c if at_cap else grow_nnz_max(plan.nnz_c)
            what = f"{name} {dtype}"
            if plan.nnz_c == 0:
                before = maple_spgemm_numeric.launches
                c = maple_spgemm(a, b, plan=plan)
                if maple_spgemm_numeric.launches != before or bool(
                        c.value.any()):
                    raise AssertionError(f"{what}: nnz(C) = 0 launched B5 "
                                         f"or gave a non-zero value")
                cases += 1
                continue
            want = maple_spgemm_numeric_plain(a.value, b.value, plan,
                                              cap=cap)
            for route, shape in enumerate(numeric_routes()):   # B5's all
                with pinned_route(route):
                    got = [maple_spgemm_numeric(a.value, b.value, plan,
                                                cap=cap) for _ in range(2)]
                torch.cuda.synchronize()
                where = f"B5 route {shape} {what}"
                if not torch.equal(got[0], got[1]):
                    raise AssertionError(f"{where}: two runs differ")
                if bool(got[0][plan.nnz_c:].any()):
                    raise AssertionError(f"{where}: non-zero capacity slot")
                check_close(got[0], want, dtype, where)
                bit_equal = bool(torch.equal(got[0], want))
                if dtype == torch.float32 and not bit_equal:
                    raise AssertionError(f"{where}: not bit-equal to plain")
                bit_equal_plain += bit_equal
            dc = torch.from_numpy(rng.standard_normal(cap).astype(
                np.float32)).cuda().to(dtype)
            for kernel, plain, other, n in (
                    (maple_sddmm_csr, maple_sddmm_csr_plain, b.value,
                     a.nnz_max),
                    (maple_spgemm_db, maple_spgemm_db_plain, a.value,
                     b.nnz_max)):
                got = [kernel(dc, other, plan, n_slots=n) for _ in range(2)]
                torch.cuda.synchronize()
                if not torch.equal(got[0], got[1]):
                    raise AssertionError(f"{kernel.__name__} {what}: two "
                                         f"runs differ")
                check_close(got[0], plain(dc, other, plan, n_slots=n),
                            dtype, f"{kernel.__name__} {what}")
            # dB on the B rows no A slot consumes: 0
            b_rows = np.repeat(np.arange(bm.shape[0]), bm.sum(axis=1))
            unused = torch.from_numpy((~am.any(axis=0))[b_rows]).cuda()
            if bool(got[0][:b.nnz][unused].any()):
                raise AssertionError(f"maple_spgemm_db {what}: non-zero on "
                                     f"a B row no slot consumes")
            values, col_ids = csr_to_ell(a)
            dense_b = b.to_dense()
            got = maple_spmspm_ell(values, col_ids, dense_b)
            torch.cuda.synchronize()
            if not torch.equal(got, maple_spmspm_ell_plain(values, col_ids,
                                                           dense_b)):
                raise AssertionError(f"B7 {what}: not bit-equal to plain")
            cases += 1
        # B7 alone: L > 32 (two tiles of slots), a row all pad, N = 1,
        # 37, 64 and 300 (scalar and 4-wide lanes, 16 and 32 lanes a row)
        mask = rng.random((40, 90)) < 0.1
        mask[7, :50] = True
        mask[3] = False
        a = element_csr(mask, rng, dtype, pad=2)
        values, col_ids = csr_to_ell(a)
        for n in (1, 37, 64, 300):
            dense_b = torch.from_numpy(rng.standard_normal((90, n)).astype(
                np.float32)).cuda().to(dtype)
            got = maple_spmspm_ell(values, col_ids, dense_b)
            torch.cuda.synchronize()
            if not torch.equal(got, maple_spmspm_ell_plain(values, col_ids,
                                                           dense_b)):
                raise AssertionError(f"B7 L={values.shape[1]} N={n} "
                                     f"{dtype}: not bit-equal to plain")
            cases += 1
    return {"phase": "spgemm_kernels", "cases": cases,
            "b5_bit_equal_to_plain": bit_equal_plain, "ok": True}


# --------------------------------------------------------------------------
# phase 9: C = A×A on the full-size cage12 clone, forward and backward
# --------------------------------------------------------------------------

SPGEMM_COUNTERS = ("maple_spgemm_numeric", "maple_sddmm_csr",
                   "maple_spgemm_db", "maple_spmspm_ell")


def spgemm_counters():
    from repro_torch.kernels.maple_sddmm import maple_sddmm_csr
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_numeric)
    from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
    return dict(zip(SPGEMM_COUNTERS, (maple_spgemm_numeric, maple_sddmm_csr,
                                      maple_spgemm_db, maple_spmspm_ell)))


def counted(fn):
    """Run ``fn`` with the SpGEMM launch counts zeroed just before; return
    its result, the counts just after and the wall ms (synchronised)."""
    fns = spgemm_counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k: f.launches for k, f in fns.items()}, ms


def scipy_csr(c):
    import scipy.sparse as sp
    nnz = c.nnz
    return sp.csr_matrix((c.value[:nnz].detach().float().cpu().numpy(),
                          c.col_id[:nnz], c.row_ptr), shape=c.shape)


def spgemm(spec, flush, card):
    """``maple_spgemm(A, A)`` on cage12 at scale 1.0, forward and backward
    of sum(C²), against scipy (pattern and values) and the plain path on
    the card; then ``maple_spmspm(A, B)`` with a dense (n, 64) B; then the
    four kernels timed at these shapes."""
    from repro_torch.core import sparsity
    from repro_torch.kernels import maple_spgemm, maple_spmspm, plan_spgemm
    from repro_torch.kernels.maple_sddmm import maple_sddmm_csr_plain
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db_plain,
                                                  maple_spgemm_numeric_plain)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a = sparsity.generate(sparsity.TABLE_I[CAGE12], scale=CAGE12_SCALE,
                          seed=SEED, device="cuda")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_spgemm(a, a)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.on_device(a.value.device)
    torch.cuda.synchronize()
    device_plan_s = time.perf_counter() - t0
    t_cpos_s = fiber_positions_s(plan, a.value.device)
    stats = spgemm_stats(a, plan)
    cap = plan.nnz_c

    value = a.value.clone().requires_grad_()
    op = dataclasses.replace(a, value=value)
    torch.cuda.reset_peak_memory_stats()
    c, fwd_launches, fwd_ms = counted(
        lambda: maple_spgemm(op, op, plan=plan, nnz_max=cap))
    _, bwd_launches, bwd_ms = counted(
        lambda: (c.value * c.value).sum().backward())
    launches = {k: fwd_launches[k] + bwd_launches[k] for k in fwd_launches}
    expect = {"maple_spgemm_numeric": 1, "maple_sddmm_csr": 1,
              "maple_spgemm_db": 1, "maple_spmspm_ell": 0}
    if launches != expect or fwd_launches["maple_sddmm_csr"]:
        raise AssertionError(f"SpGEMM launches {fwd_launches} forward, "
                             f"{bwd_launches} backward; expected {expect}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(c.value).all()):
        raise AssertionError("non-finite C")
    c_nnz = c.nnz

    # scipy's A @ A on the host: its pattern lies in the plan's, its values
    # agree at the pattern
    ref = scipy_csr(a) @ scipy_csr(a)
    ref.sort_indices()
    got = scipy_csr(c)
    n = a.shape[0]
    keys = lambda m: (np.repeat(np.arange(n, dtype=np.int64),
                                np.diff(m.indptr)) * n + m.indices)
    if not np.isin(keys(ref), keys(got)).all():
        raise AssertionError("scipy's A @ A has coordinates outside the "
                             "plan's pattern")
    scale = float(np.abs(ref.data).max())
    sci_err = float(np.abs((got - ref).data).max(initial=0.0))
    if not sci_err <= 1e-5 * scale + 1e-6:
        raise AssertionError(f"C against scipy: {sci_err} > "
                             f"{1e-5 * scale + 1e-6}")
    # the plain path on the card, on the same values
    want = maple_spgemm_numeric_plain(a.value, a.value, plan, cap=cap)
    fwd_err = check_close(c.value.detach(), want, torch.float32,
                          "C against plain")
    if not torch.equal(c.value.detach(), want):
        raise AssertionError("B5 at cage12: C not bit-equal to plain")
    dc = (2 * want).contiguous()
    want_grad = (maple_sddmm_csr_plain(dc, a.value, plan, n_slots=a.nnz_max)
                 + maple_spgemm_db_plain(dc, a.value, plan,
                                         n_slots=a.nnz_max))
    grad_err = check_close(value.grad, want_grad, torch.float32,
                           "dA + dB against plain")
    # warm end-to-end times, outside the counted run
    fwd_warm = statistics.median(counted(
        lambda: maple_spgemm(a, a, plan=plan, nnz_max=cap))[2]
        for _ in range(3))

    def fwd_bwd():
        c2 = maple_spgemm(op, op, plan=plan, nnz_max=cap)
        (c2.value * c2.value).sum().backward()
    fwd_bwd_warm = statistics.median(counted(fwd_bwd)[2] for _ in range(3))
    # the host clock above spreads between calls; the device's own time
    # over five forward + backward calls, kernel by kernel (B5 is the
    # forward).  The profiler misses the kernels of about the first 2.5
    # ms of its region: the first call's B5 is not counted.
    prof = profile(lambda: [fwd_bwd() for _ in range(5)], warmup=False)
    device = {k: prof[k] for k in ("wall_ms", "device_ms", "launches",
                                   "top")}
    del c, want, want_grad, value, op
    torch.cuda.empty_cache()

    # maple_spmspm with a dense B: the element walk (B7)
    rng = np.random.default_rng(SEED + 9)
    dense_b = torch.from_numpy(rng.standard_normal(
        (n, SPMSPM_N)).astype(np.float32)).cuda()
    out, mm_launches, mm_ms = counted(lambda: maple_spmspm(a, dense_b))
    if mm_launches != {"maple_spgemm_numeric": 0, "maple_sddmm_csr": 0,
                       "maple_spgemm_db": 0, "maple_spmspm_ell": 1}:
        raise AssertionError(f"maple_spmspm launches {mm_launches}")
    ref_mm = scipy_csr(a) @ dense_b.cpu().numpy()
    mm_err = float((out.cpu() - torch.from_numpy(ref_mm)).abs().max())
    if not mm_err <= 1e-5 * float(np.abs(ref_mm).max()) + 1e-6:
        raise AssertionError(f"maple_spmspm against scipy: {mm_err}")
    del out
    rows = spgemm_rows(CAGE12, a, plan, spec, flush, dense_b)
    del dense_b
    # the second timed shape: B5, B6 and dB on the poisson3Da clone
    p3 = sparsity.generate(sparsity.TABLE_I[POISSON], scale=1.0, seed=SEED,
                           device="cuda")
    t0 = time.perf_counter()
    p3_plan = plan_spgemm(p3, p3)
    p3_plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p3_plan.on_device(p3.value.device)
    torch.cuda.synchronize()
    p3_device_s = time.perf_counter() - t0
    p3_t_cpos_s = fiber_positions_s(p3_plan, p3.value.device)
    rows += spgemm_rows(POISSON, p3, p3_plan, spec, flush)
    line = {"phase": "spgemm", "matrix": f"{CAGE12} clone, scale "
            f"{CAGE12_SCALE}, seed {SEED}, PYTHONHASHSEED "
            f"{os.environ.get('PYTHONHASHSEED')}", **stats, "generate_s": gen_s,
            "plan_spgemm_s": plan_s,
            "on_device_s": device_plan_s, "t_cpos_s": t_cpos_s,
            "on_device_mb": device_plan_mb(plan, a.value.device),
            "poisson3Da": {**spgemm_stats(p3, p3_plan),
                           "plan_spgemm_s": p3_plan_s,
                           "on_device_s": p3_device_s,
                           "t_cpos_s": p3_t_cpos_s,
                           "on_device_mb": device_plan_mb(p3_plan,
                                                          p3.value.device)},
            "launches": launches,
            "launches_forward": fwd_launches, "forward_ms_first_call": fwd_ms,
            "backward_ms_first_call": bwd_ms, "forward_ms_warm": fwd_warm,
            "fwd_bwd_ms_warm": fwd_bwd_warm, "fwd_bwd_x5_profiled": device,
            "peak_mem_gib": peak_gib,
            "scipy_max_abs_err": sci_err, "scipy_max_abs_c": scale,
            "plain_max_abs_err": fwd_err, "b5_bit_equal_to_plain": True,
            "grad_max_abs_err": grad_err,
            "spmspm_n": SPMSPM_N, "spmspm_ms": mm_ms,
            "spmspm_scipy_max_abs_err": mm_err, "card": card}
    clones = {"cage12": (a, plan, c_nnz), "poisson3Da": (p3, p3_plan)}
    return {"spgemm": launches, "spmspm": mm_launches}, rows, line, clones


def spgemm_stats(a, plan):
    return {"n": a.shape[0], "nnz": a.nnz, "la": plan.la, "lb": plan.lb,
            "lc": plan.lc, "P": plan.stats.partial_products,
            "nnz_c": plan.nnz_c}


def fiber_positions_s(plan, device):
    """Seconds to build the plan's ``t_cpos`` (dB's fiber-ordered C
    positions) on ``device``, which the first dB launch would take."""
    t0 = time.perf_counter()
    plan.fiber_positions(device)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_plan_mb(plan, device):
    """MB of the plan's device arrays: all of them, ``t_cpos`` (the
    fiber-ordered C positions dB reads) included, and its own part."""
    mb = lambda t: t.numel() * t.element_size() / 1e6
    t_cpos = mb(plan.fiber_positions(device))
    return {"total": sum(mb(t) for t in plan.on_device(device).values())
            + t_cpos, "t_cpos": t_cpos}


def time_library(fn, flush):
    """The time of one library call, or why it could not run."""
    try:
        return time_ms(fn, max(3, REPS // 4), flush), None
    except RuntimeError as err:
        return None, str(err)[:200]


def spgemm_rows(tag, a, plan, spec, flush, dense_b=None):
    """B5, B6 and dB of C = A×A, and B7 where ``dense_b`` is given, f32:
    each held against its plain version and timed after an L2 flush beside
    its bound, the plain version and, for B5 and B7, ``torch.sparse.mm``
    (cuSPARSE)."""
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                                 maple_sddmm_csr_plain)
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_db_plain,
                                                  maple_spgemm_numeric,
                                                  maple_spgemm_numeric_plain)
    from repro_torch.kernels.maple_spmspm import (maple_spmspm_ell,
                                                  maple_spmspm_ell_plain)
    dtype, isz = torch.float32, 4
    m, n = a.shape
    cap, nnz, p = plan.nnz_c, a.nnz, plan.stats.partial_products
    k = plan.shape_b[0]
    # the plan arrays each kernel reads, in bytes.  B5: a record an output
    # row (row_meta int32 × 4, row_base int64 × 2), each slot's B row
    # (slot_b int32 × 2), one int32 position a partial.  B6: the CSR
    # pointers (int32, part_ptr / out_rptr int64), one position a partial.
    # dB: a record a B row (fiber_meta int32 × 4, fiber_base int64), each
    # fiber entry's A slot (t_perm), one int32 C slot a partial (t_cpos).
    b5_meta = 32 * m + 8 * nnz + 4 * p
    b6_meta = (4 * (m + 1) + 4 * nnz + 4 * (k + 1) + 8 * (nnz + 1) + 4 * p
               + 8 * (m + 1))
    db_meta = 24 * k + 4 * nnz + 4 * p
    crow = torch.from_numpy(a.row_ptr.astype(np.int64)).cuda()
    col = torch.from_numpy(a.col_id[:nnz].astype(np.int64)).cuda()
    a_sparse = torch.sparse_csr_tensor(crow, col, a.value[:nnz], a.shape)
    rng = np.random.default_rng(SEED + 10)
    dc = torch.from_numpy(rng.standard_normal(cap).astype(np.float32)).cuda()
    shape = f"{tag} C=A×A n={m} nnz={nnz} P={p} nnz_c={cap}"
    rows = []
    for name, kernel, plain, library, nbytes in (
            ("maple_spgemm_numeric",
             lambda: maple_spgemm_numeric(a.value, a.value, plan, cap=cap),
             lambda: maple_spgemm_numeric_plain(a.value, a.value, plan,
                                                cap=cap),
             lambda: torch.sparse.mm(a_sparse, a_sparse),
             nnz * isz + b5_meta + cap * isz),      # A's values once
            ("maple_sddmm_csr",
             lambda: maple_sddmm_csr(dc, a.value, plan, n_slots=nnz),
             lambda: maple_sddmm_csr_plain(dc, a.value, plan, n_slots=nnz),
             None, (cap + nnz) * isz + b6_meta + nnz * 4),
            ("maple_spgemm_db",
             lambda: maple_spgemm_db(dc, a.value, plan, n_slots=nnz),
             lambda: maple_spgemm_db_plain(dc, a.value, plan, n_slots=nnz),
             None, (cap + nnz) * isz + db_meta + nnz * 4)):
        rows.append(measure_sparse(
            name, kernel, plain, library, nbytes, 2 * p, dtype, spec, flush,
            shape=shape))
    if dense_b is None:
        return rows
    # B7 reads every ELL column id (to find the pads) but only the live
    # values
    values, col_ids = csr_to_ell(a)
    rows.append(measure_sparse(
        "maple_spmspm_ell", lambda: maple_spmspm_ell(values, col_ids, dense_b),
        lambda: maple_spmspm_ell_plain(values, col_ids, dense_b),
        lambda: torch.sparse.mm(a_sparse, dense_b),
        nnz * isz + col_ids.numel() * 4 + dense_b.numel() * isz
        + m * SPMSPM_N * isz,
        2 * nnz * SPMSPM_N, dtype, spec, flush,
        shape=f"{tag} A (ELL {m}x{values.shape[1]}) x dense ({n}, "
        f"{SPMSPM_N})"))
    return rows


def measure_sparse(name, kernel, plain, library, nbytes, flops, dtype, spec,
                   flush, shape):
    """Check a kernel against its plain version, then time both, the
    library call (where one exists) and the bound."""
    got = kernel()
    torch.cuda.synchronize()
    err = check_close(got, plain(), dtype, f"{name} {shape}")
    del got
    lib_ms, lib_error = (time_library(library, flush) if library
                         else (None, "no single-call equivalent"))
    t_bytes, t_ops = nbytes / spec[0] * 1e3, flops / spec[1][dtype] * 1e3
    return {"name": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": shape, "max_abs_err": err,
            "ms": time_ms(kernel, REPS, flush),
            "plain_ms": time_ms(plain, max(3, REPS // 4), flush),
            "library_ms": lib_ms, "library_note": lib_error,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --------------------------------------------------------------------------
# phase 9a: the Gustavson oracles against B5 and B7 at full Table-I size
# --------------------------------------------------------------------------

SCAN_CHUNK = 112          # divides poisson3Da's 14 000 rows


def oracle_run(fn, what):
    """``fn()`` twice with the SpGEMM launch counts zeroed before: no
    Maple kernel launched, the two results bit-equal.  Returns the result
    and the first call's synchronised wall ms."""
    first, launches, ms = counted(fn)
    again, more, _ = counted(fn)
    if any(launches.values()) or any(more.values()):
        raise AssertionError(f"{what} launched {launches}")
    if not torch.equal(first, again):
        raise AssertionError(f"{what}: a second run is not bit-equal")
    return first, ms


def gustavson(clones, card):
    """``core.gustavson`` on the card at full Table-I size, holding the
    SpGEMM kernels: ``spmm_rowwise(A, B)`` on cage12 with a dense
    (n, 64) f32 B against B7 (``maple_spmspm``) and B7's plain version;
    ``spmspm_rowwise``, ``spmspm_rowwise_scan`` and ``dense_oracle`` on
    poisson3Da against B5's C (``maple_spgemm``) densified.  Each within
    ``check_close``'s f32 limit, each oracle rerun bit-equal; B5 and B7
    launched exactly once, the oracles none."""
    from repro_torch.core import gustavson as G
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.kernels import maple_spgemm, maple_spmspm
    from repro_torch.kernels.maple_spmspm import maple_spmspm_ell_plain
    a, _, _ = clones["cage12"]
    n = a.shape[0]
    rng = np.random.default_rng(SEED + 9)
    dense_b = torch.from_numpy(rng.standard_normal(
        (n, SPMSPM_N)).astype(np.float32)).cuda()
    b7, b7_launches, b7_ms = counted(lambda: maple_spmspm(a, dense_b))
    oracle, oracle_ms = oracle_run(lambda: G.spmm_rowwise(a, dense_b),
                                   "spmm_rowwise")
    values, col_ids = csr_to_ell(a)
    plain = maple_spmspm_ell_plain(values, col_ids, dense_b)
    cage12 = {"n": n, "nnz": a.nnz, "N": SPMSPM_N,
              "b7_max_abs_err": check_close(b7, oracle, torch.float32,
                                            "B7 against spmm_rowwise"),
              "plain_max_abs_err": check_close(plain, oracle, torch.float32,
                                               "B7's plain version against "
                                               "spmm_rowwise"),
              "max_abs": float(oracle.abs().max()),
              "b7_ms_first_call": b7_ms, "spmm_rowwise_ms": oracle_ms}
    del b7, oracle, plain, dense_b
    torch.cuda.empty_cache()

    p3, p3_plan = clones["poisson3Da"]
    c, b5_launches, b5_ms = counted(lambda: maple_spgemm(
        p3, p3, plan=p3_plan, nnz_max=p3_plan.nnz_c))
    c_dense = c.to_dense()
    del c
    poisson = {"n": p3.shape[0], "nnz": p3.nnz, "nnz_c": p3_plan.nnz_c,
               "max_abs": float(c_dense.abs().max()),
               "b5_ms_first_call": b5_ms, "scan_row_chunk": SCAN_CHUNK}
    for name, fn in (
            ("spmspm_rowwise", lambda: G.spmspm_rowwise(p3, p3)),
            ("spmspm_rowwise_scan",
             lambda: G.spmspm_rowwise_scan(p3, p3, row_chunk=SCAN_CHUNK)),
            ("dense_oracle", lambda: G.dense_oracle(p3, p3))):
        got, ms = oracle_run(fn, name)
        poisson[f"{name}_max_abs_err"] = check_close(
            c_dense, got, torch.float32, f"B5's C against {name}")
        poisson[f"{name}_ms"] = ms
        del got
        torch.cuda.empty_cache()
    del c_dense
    launches = {k: b5_launches[k] + b7_launches[k] for k in b5_launches}
    expect = {k: 0 for k in SPGEMM_COUNTERS}
    expect.update(maple_spgemm_numeric=1, maple_spmspm_ell=1)
    if launches != expect:
        raise AssertionError(f"gustavson launches {launches}, expected "
                             f"{expect}")
    torch.cuda.empty_cache()
    return launches, {"phase": "gustavson", "cage12": cage12,
                      "poisson3Da": poisson, "launches": launches,
                      "bit_identical_reruns": True, "card": card}


# --------------------------------------------------------------------------
# phase 9b: the paper's accelerator model at full Table-I size
# --------------------------------------------------------------------------

def paper_tables_phase(clones, card):
    """``repro_torch.launch.paper_tables.run`` at scale 1.0 over the 14
    Table-I clones, generated on the card: each row, the two mean rows
    beside the paper's, the generate and analyze seconds of each clone.
    cage12's P and nnz(C) must equal the ``spgemm`` phase's plan and B5's
    output nnz."""
    import contextlib
    import io
    from repro_torch.launch import paper_tables
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rows = paper_tables.run(scale=1.0, seed=SEED, device="cuda")
    total_s = time.perf_counter() - t0
    lines = text.getvalue().splitlines()
    if len(rows) != 14 or len(lines) != 25:
        raise AssertionError(f"paper_tables printed {len(lines)} lines for "
                             f"{len(rows)} clones")
    table = []
    for r in rows:
        row = {k: r[k] for k in ("matrix", "n", "nnz", "P", "nnz_C",
                                 "generate_s", "analyze_s")}
        for fam, tag in (("matraptor", "MR"), ("extensor", "EX")):
            cmp = r[fam]
            row.update({f"{tag}_energy_pct": cmp.energy_benefit_pct,
                        f"{tag}_onchip_pct": cmp.onchip_energy_benefit_pct,
                        f"{tag}_speedup_pct": cmp.speedup_pct,
                        f"{tag}_area_x": cmp.area_ratio})
        if not all(np.isfinite(v) for v in row.values()
                   if isinstance(v, float)):
            raise AssertionError(f"non-finite row {row}")
        table.append(row)
    means = {}
    for fam in ("matraptor", "extensor"):
        e, oc, sp, ar = paper_tables.means(rows, fam)
        means[fam] = {"energy_pct": e, "onchip_pct": oc, "speedup_pct": sp,
                      "area_x": ar, "paper": paper_tables.PAPER[fam]}
    _, plan, c_nnz = clones["cage12"]
    cg = next(r for r in rows if r["matrix"] == CAGE12)
    model = {"P": cg["P"], "nnz_C": cg["nnz_C"]}
    spgemm_side = {"plan_P": plan.stats.partial_products,
                   "plan_nnz_c": plan.nnz_c, "b5_output_nnz": c_nnz}
    if not (model["P"] == spgemm_side["plan_P"] and model["nnz_C"]
            == spgemm_side["plan_nnz_c"] == spgemm_side["b5_output_nnz"]):
        raise AssertionError(f"cage12: the model's {model} against the "
                             f"SpGEMM's {spgemm_side}")
    return {"phase": "paper_tables", "scale": 1.0, "seed": SEED,
            "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED"),
            "rows": table, "means": means,
            "mean_lines": [ln for ln in lines if ln.startswith("MEAN_")],
            "cage12_model": model, "cage12_spgemm": spgemm_side,
            "total_s": total_s, "card": card}


# --------------------------------------------------------------------------
# phase 10: the MoE grouped GEMM (B8) against its plain version
# --------------------------------------------------------------------------

def moe_kernels_edge():
    """B8 through ``moe_expert_gemm`` against the plain version on the
    card, f32 and bf16: the reference sweep's groups at D = F = 256 and
    bt = 128 (empty groups included), and decode's bt = 8 at the smoke
    config's widths (D 64, F 32, no tiling multiple); each twice for bit
    identity."""
    from repro_torch.kernels import moe_expert_gemm
    from repro_torch.kernels.moe_gemm import moe_gemm_plain
    from repro_torch.kernels.ops import expert_of_tile
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for sizes, d, f, bt in MOE_EDGE:
            rng = np.random.default_rng(sum(sizes) + d)
            t = int(np.sum(sizes))
            x = torch.from_numpy(rng.standard_normal((t, d)).astype(
                np.float32)).cuda().to(dtype)
            w = torch.from_numpy(rng.standard_normal((len(sizes), d, f))
                                 .astype(np.float32) * 0.1).cuda().to(dtype)
            gs = torch.tensor(sizes, device="cuda")
            got = [moe_expert_gemm(x, gs, w, bt=bt) for _ in range(2)]
            torch.cuda.synchronize()
            what = f"moe_gemm {sizes} D{d} F{f} bt{bt} {dtype}"
            if not torch.equal(got[0], got[1]):
                raise AssertionError(f"{what}: two runs differ")
            err = check_close(got[0], moe_gemm_plain(
                x, expert_of_tile(gs, t // bt, bt), w, bt=bt), dtype, what)
            cases.append({"sizes": sizes, "D": d, "F": f, "bt": bt,
                          "dtype": str(dtype).replace("torch.", ""),
                          "max_abs_err": err})
    return {"phase": "moe_kernels", "cases": cases, "bit_identical": True,
            "ok": True}


# --------------------------------------------------------------------------
# phase 11: the granite-moe-3b smoke config, card against CPU
# --------------------------------------------------------------------------

def moe_reference():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve import SamplingConfig, generate
    from repro_torch.train.optimizer import tree_map
    cfg = get_smoke_config(MOE_ARCH)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (3, 11)))
    sampling = SamplingConfig(max_new_tokens=8)
    tok_cpu, _ = generate(cpu, cfg, {"tokens": prompts}, sampling)
    tok_gpu, _ = generate(gpu, cfg, {"tokens": prompts.cuda()}, sampling)
    lg_cpu, _ = lm.prefill(cpu, cfg, {"tokens": prompts})
    lg_gpu, _ = lm.prefill(gpu, cfg, {"tokens": prompts.cuda()})
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    if not torch.allclose(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"card MoE prefill logits differ from CPU: {err}")
    if not torch.equal(tok_cpu, tok_gpu.cpu()):
        raise AssertionError("card MoE greedy tokens differ from CPU")
    return {"phase": "moe_reference", "config": f"{MOE_ARCH} smoke, f32",
            "prefill_max_abs_err": err, "greedy_tokens_equal": True,
            "new_tokens": int(tok_gpu.shape[1])}


# --------------------------------------------------------------------------
# phase 12: serve granite-moe-3b at full width and depth
# --------------------------------------------------------------------------

def moe_serve(card):
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    from repro_torch.serve import SamplingConfig, generate
    from repro_torch.train.optimizer import named_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the random init's peak (each stacked leaf drawn, then scaled in
    # place); the serving peak is read from here on
    init_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(t.numel() for _, t in named_leaves(params))
    rng = np.random.default_rng(SEED)
    prompt_len = int(rng.integers(16, 129))
    prompts = rng.integers(0, cfg.vocab_size, (4, prompt_len))
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    new = 16

    moe_gemm.launches = 0
    t0 = time.perf_counter()
    tokens, _ = generate(params, cfg, batch, SamplingConfig(
        max_new_tokens=new))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"moe_gemm": moe_gemm.launches}
    # one prefill and one decode step per new token; every layer is MoE,
    # with three expert products (gate, up, down) per forward pass
    expect = {"moe_gemm": 3 * cfg.n_layers * (1 + new)}
    if launches != expect:
        raise AssertionError(f"MoE launches on the path {launches}, "
                             f"expected {expect}")
    if tokens.shape != (4, new) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(tokens.shape)} "
                             f"tokens outside the vocabulary")

    # checks and timings outside the counted run (capacity depends on the
    # batch, so a batch-1 prefill routes and drops differently: layer 0 is
    # checked instead, on its real inputs at prefill (cap 96) and at one
    # decode step (cap 8))
    (logits, state), (p0, h0) = layer0_moe_input(
        lambda: lm.prefill(params, cfg, batch, max_seq=prompt_len + new))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite MoE logits")
    layer0 = {"prefill": moe_layer_check(p0, cfg, h0, "prefill")}
    _, (p0, h0) = layer0_moe_input(
        lambda: lm.decode_step(params, cfg, state, tokens[:, :1]))
    layer0["decode"] = moe_layer_check(p0, cfg, h0, "decode")
    del p0, h0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.prefill(params, cfg, batch, max_seq=prompt_len + new)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_tok = tokens[:, :1]
    t0 = time.perf_counter()
    for _ in range(4):
        _, state = lm.decode_step(params, cfg, state, step_tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / 4
    prof = profile(lambda: lm.decode_step(params, cfg, state, step_tok))
    _, gstate = lm.prefill(params, cfg, batch, max_seq=prompt_len + 32)
    graph = replay_check(params, cfg, gstate, step_tok, "moe_serve")
    del gstate
    mcfg = lm._moe_cfg(cfg)
    line = {
        "phase": "moe_serve", "config": f"{MOE_ARCH}, f32, random weights "
        f"from seed {SEED}", "n_layers": cfg.n_layers, "depth_reduced": False,
        "d_model": cfg.d_model, "n_experts": cfg.n_experts,
        "n_experts_padded": cfg.n_experts_padded, "top_k": cfg.top_k,
        "d_expert": cfg.d_expert, "n_params": n_params, "batch": 4,
        "prompt_len": prompt_len, "new_tokens": new,
        "cap_prefill": M._capacity(4 * prompt_len, mcfg),
        "cap_decode": M._capacity(4, mcfg), "setup_s": setup_s,
        "generate_s": gen_s, "generate_tok_per_s": 4 * new / gen_s,
        "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
        "decode_step_device_ms": prof["device_ms"],
        "replayed_decode_step_ms": graph["replayed_decode_step_ms"],
        "decode_step_graph": graph,
        "launches": launches, "launches_expected": expect, "card": card,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "init_peak_mem_gib": init_peak_gib, "layer0_check": layer0,
        "profile_decode_step": prof}
    del params, state, logits
    torch.cuda.empty_cache()
    return launches, line


def layer0_moe_input(fn):
    """Run ``fn`` with ``moe.moe_layer`` wrapped; return what ``fn``
    returns and the parameters and hidden states of the wrapped function's
    first call: layer 0's MoE input in a prefill or a decode step."""
    from repro_torch.models import moe as M
    seen = []
    layer = M.moe_layer

    def record(p, mcfg, h, **kw):
        if not seen:
            seen.append((p, h.detach().clone()))
        return layer(p, mcfg, h, **kw)
    M.moe_layer = record
    try:
        result = fn()
    finally:
        M.moe_layer = layer
    return result, seen[0]


def routing_oracle(router, mcfg, xt):
    """The reference's routing recomputed on the host in float64 with
    numpy, apart from the port's code: softmax, top-k (descending, ties to
    the lower expert), renormalised gates, a stable sort of the flat
    assignments by expert, each slot's rank in its expert segment, and the
    capacity clamp.  ``margin`` is the least gap between a token's k-th
    and (k+1)-th probability: how near a tie the f32 router came."""
    k, t = mcfg.top_k, xt.shape[0]
    logits = xt.double().cpu().numpy() @ router.double().cpu().numpy()
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = z / z.sum(-1, keepdims=True)
    ranked = np.argsort(-probs, axis=-1, kind="stable")
    expert_idx = ranked[:, :k]
    gate = np.take_along_axis(probs, expert_idx, -1)
    gate = gate / np.maximum(gate.sum(-1, keepdims=True), 1e-9)
    flat_e = expert_idx.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    sorted_e = flat_e[order]
    rank = np.arange(t * k) - np.searchsorted(sorted_e, sorted_e, "left")
    c = int(t * k * mcfg.capacity_factor / mcfg.n_experts_padded)
    cap = max(8, -(-c // 8) * 8)
    p_sorted = np.take_along_axis(probs, ranked, -1)
    return {"expert_idx": expert_idx, "gate": gate, "order": order,
            "sorted_e": sorted_e, "keep": rank < cap, "cap": cap,
            "margin": float((p_sorted[:, k - 1] - p_sorted[:, k]).min())}


def moe_layer_check(p, cfg, h, what):
    """Layer 0's MoE on hidden states ``h`` at full width against an
    oracle with its own routing (:func:`routing_oracle`): the port's
    ``expert_idx``, ``order``, ``keep`` and capacity must equal it; then
    each expert's kept slots go through three ``torch.matmul`` products and
    each token's gated slots are summed, within 1e-4·max + 1e-6 of the
    layer (f32 through three chained products, summed in another order).
    Returns the error, the capacity, the dropped slots and the margin."""
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    mcfg = lm._moe_cfg(cfg)
    got = M.moe_layer(p, mcfg, h)
    xt = h.reshape(-1, cfg.d_model)
    o = routing_oracle(p["router"], mcfg, xt)
    cap = M._capacity(xt.shape[0], mcfg)
    r = M.route(p["router"], mcfg, xt, cap)
    for key in ("expert_idx", "order", "keep"):
        if not np.array_equal(r[key].cpu().numpy(), o[key]):
            raise AssertionError(f"MoE layer 0 ({what}): the port's {key} "
                                 f"differs from the float64 oracle's "
                                 f"(top-k margin {o['margin']})")
    if cap != o["cap"]:
        raise AssertionError(f"MoE layer 0 ({what}): capacity {cap}, the "
                             f"oracle's {o['cap']}")
    dev = h.device
    token = torch.from_numpy(o["order"] // cfg.top_k).to(dev)
    gate = torch.from_numpy(o["gate"].reshape(-1)[o["order"]]).float().to(dev)
    sorted_e = torch.from_numpy(o["sorted_e"]).to(dev)
    keep = torch.from_numpy(o["keep"]).to(dev)
    want = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        sel = (sorted_e == e) & keep
        xe = xt[token[sel]]
        he = torch.nn.functional.silu(xe @ p["experts_gate"][e]) * (
            xe @ p["experts_up"][e])
        want.index_add_(0, token[sel], (he @ p["experts_down"][e])
                        * gate[sel, None])
    got = got.reshape(want.shape)
    err = float((got - want).abs().max())
    limit = 1e-4 * float(want.abs().max()) + 1e-6
    if not err <= limit:
        raise AssertionError(f"MoE layer 0 ({what}) against the oracle: "
                             f"{err} > {limit}")
    return {"max_abs_err": err, "tokens": xt.shape[0], "cap": cap,
            "dropped_slots": int((~o["keep"]).sum()),
            "top_k_margin": o["margin"]}


def moe_rows(spec, flush):
    """B8 at granite-moe-3b's expert products (capacity buffers with one
    ``cap``-row tile per expert), f32 and bf16: held against the plain
    version, timed beside the bound, the plain version and ``torch.bmm``
    on (E, cap, D) × (E, D, F)."""
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
    rows = []
    e = MOE_E
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dtype).element_size()
        for name, cap, d, f in MOE_SHAPES:
            rng = np.random.default_rng(SEED + cap + d)
            t = e * cap
            x = torch.from_numpy(rng.standard_normal((t, d)).astype(
                np.float32)).cuda().to(dtype)
            w = torch.from_numpy(rng.standard_normal((e, d, f)).astype(
                np.float32) / np.sqrt(d)).cuda().to(dtype)
            eot = torch.arange(e, dtype=torch.int32, device="cuda")
            got = moe_gemm(x, eot, w, bt=cap)
            torch.cuda.synchronize()
            want = moe_gemm_plain(x, eot, w, bt=cap)
            x3 = x.view(e, cap, d)
            nbytes = (t * d + e * d * f + t * f) * isz + 4 * e
            rows.append(measure(
                "moe_gemm", got, want, dtype,
                lambda: moe_gemm(x, eot, w, bt=cap),
                lambda: moe_gemm_plain(x, eot, w, bt=cap),
                lambda: torch.bmm(x3, w), nbytes, 2 * t * d * f, spec, flush,
                REPS, shape=f"{name} E={e} cap={cap}: ({t} x {d}) -> {f}",
                bt=cap))
            del x, w, got, want, x3
    return rows


# --------------------------------------------------------------------------
# phase 12a: the continuous batcher over paged decode
# --------------------------------------------------------------------------

# the serve bench's Poisson workload (benchmarks/serve_bench.py:71-102,
# ``serve.workload``) at full-size prompt and new-token ranges; the engine
# geometry of each run
BATCH_A = dict(n_req=16, rate=0.5, prompt=(16, 128), new=(8, 32))
BATCH_B = dict(n_req=12, rate=0.5, prompt=(16, 64), new=(4, 16))
BATCH_C = dict(n_req=6, rate=0.5, prompt=(16, 64), new=(8, 8))
BATCH_GEOMETRY = dict(max_slots=8, page_size=16, max_seq=160)
SAMPLED = dict(temperature=0.8, top_k=50)
# run E: requests 0 and 1 are live when round DRAIN_ROUND's fused step
# fails once more than the retry budget allows (both finish on the static
# path); request 2 arrives after it and is served by fused steps
FALLBACK = dict(prompt=(24, 40, 16), new=(12, 8, 6), arrival=(0.0, 0.0, 4.0))
DRAIN_ROUND = 2


def drive(eng):
    """Drive ``eng`` to the end with ``ContinuousBatcher.run`` on the step
    clock, reading the wall clock and the engine's counters as each round
    starts (where ``run`` reads its clock).  Returns the wall s and, for
    each round, (wall s, fused steps, admissions).  A round that does
    device work ends in its draw's read, so its wall holds that work."""
    marks = []

    def clock():
        marks.append((time.perf_counter(), eng.steps, eng.admitted))
        return float(len(marks) - 1)

    eng.run(max_steps=10_000, clock=clock)
    rounds = [(b[0] - a[0], b[1] - a[1], b[2] - a[2])
              for a, b in zip(marks, marks[1:])]
    return marks[-1][0] - marks[0][0], rounds


def round_times(rounds):
    """From ``drive``'s rounds: the walls (s) of the rounds that ran one
    fused step and admitted nothing, after the first two of them, and the
    prefill s an admission of each admitting round after the first (whose
    fused step is the engine's first, cold): its wall less its fused step
    at that median, over its admissions."""
    fused = [w for w, s, a in rounds if s == 1 and a == 0][2:]
    step = statistics.median(fused)
    admit = [(w - s * step) / a for w, s, a in rounds if a][1:]
    return fused, admit


def recording_batcher():
    """A ``ContinuousBatcher`` that keeps on the host each request's
    logits row of every draw (prefill and fused step), keyed by the seed
    of the request's generator (``batcher.request_generator``)."""
    from repro_torch.serve import ContinuousBatcher

    class RecordingBatcher(ContinuousBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rows = {}

        def _draw(self, rows, generators):
            host = rows.float().cpu()
            for j, g in enumerate(generators):
                if g is not None:
                    self.rows.setdefault(g.initial_seed(), []).append(
                        host[j])
            return super()._draw(rows, generators)

    return RecordingBatcher


@contextlib.contextmanager
def held_against_plain(errors, where="the batcher"):
    """Inside the block every B3, B4 and B9 launch of the model path is
    held against the kernel's plain version on the same inputs
    (``check_close`` at the f32 tolerance); ``errors`` maps each (kernel,
    G, K, N) of B3 / B4 and (kernel, B, S, H, hd) of B9 seen to its
    largest error, and ``where`` names the run in a failure's message.  No
    launch is added: the kernel's own output goes on down the path.  A
    launch inside a CUDA graph's capture is not held (a check reads the
    card on the host): the step's eager warm-up ran the same shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    from repro_torch.kernels.maple_spmm import (maple_spmm_naive,
                                                maple_spmm_naive_plain,
                                                maple_spmm_planned,
                                                maple_spmm_planned_plain)

    def held(kernel, plain, operand):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            if torch.cuda.is_current_stream_capturing():
                return out      # a graph's capture: its warm-up was held
            x = args[operand]
            key = (kernel.__name__, *x.shape)
            # the plain versions take every option but the N tile
            err = check_close(out, plain(*args, **{
                k: v for k, v in kw.items() if k != "bn"}), x.dtype,
                              f"{kernel.__name__} at {tuple(x.shape)} in "
                              f"{where}")
            errors[key] = max(errors.get(key, 0.0), err)
            return out
        return call

    saved = ops.maple_spmm_naive, ops.maple_spmm_planned, ops.block_attention
    ops.maple_spmm_naive = held(maple_spmm_naive, maple_spmm_naive_plain, -1)
    ops.maple_spmm_planned = held(maple_spmm_planned,
                                  maple_spmm_planned_plain, -1)
    ops.block_attention = held(block_attention, block_attention_plain, 0)
    try:
        yield
    finally:
        (ops.maple_spmm_naive, ops.maple_spmm_planned,
         ops.block_attention) = saved


@contextlib.contextmanager
def no_replan():
    """Every planner the port has raises inside the block."""
    from repro_torch.kernels import autotune, partition, schedule
    from repro_torch.serve import engine as engine_mod

    def boom(*a, **kw):
        raise AssertionError("the engine replanned the head")

    saved = []
    for mod, names in ((schedule, ("plan_spmm", "plan_spmm_vjp")),
                       (autotune, ("plan_search", "auto_plan")),
                       (partition, ("plan_partitioned_spmm",)),
                       (engine_mod, ("plan_spmm", "plan_spmm_vjp",
                                     "auto_plan", "plan_partitioned_spmm"))):
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, boom)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def static_check(params, cfg, head, comps, reqs, what):
    """Each completion's greedy tokens against ``complete_static`` of the
    same prompt through the same head, under the margin rule
    (``greedy_steps``).  Returns (steps compared, mismatches, smallest
    margin)."""
    from repro_torch.serve import SamplingConfig, complete_static
    by_rid = {r.rid: r for r in reqs}
    steps = []
    for c in comps:
        req = by_rid[c.rid]
        rec = RecordingHead(head)
        want, reason, _ = complete_static(
            params, cfg, req.tokens, req.max_new_tokens,
            sampling=SamplingConfig(), head=rec)
        if reason != "length":
            raise AssertionError(f"{what}: complete_static of request "
                                 f"{c.rid} ended by {reason!r}")
        steps += greedy_steps(c.rid, want, c.tokens, rec.rows,
                              cfg.vocab_size, what)
    return {"steps_compared": len(steps),
            "mismatches": [s for s in steps if not s["equal"]],
            "min_margin": min(s["margin"] for s in steps)}


def host_syncs(fn) -> list:
    """``fn()`` under CUDA's sync debug mode: for each host sync it
    makes, the innermost three repo frames (a sync in autograd's backward
    thread is reported from the ``backward`` call that waited for it)."""
    import traceback
    import warnings
    syncs, stepping = [], []

    def on_warning(message, *a, **kw):
        if stepping and "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if f.filename.startswith(str(ROOT / "src"))]
            syncs.append(" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                    for f in frames[::-1][:3]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:                  # only the call's syncs: not the mode's own
            stepping.append(True)
            fn()
            stepping.clear()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return syncs


def full_step_profile(params, cfg, head, bcfg_kw):
    """Fused steps at full occupancy: ``max_slots`` requests of 128
    prompt tokens admitted at round 0, then the wall of 8 rounds with no
    admission, the host syncs of one more round (``host_syncs``), and one
    round under ``profile``."""
    from repro_torch.serve import (BatcherConfig, ContinuousBatcher, Request,
                                   RequestQueue)
    from repro_torch.serve.workload import worst_pool
    n = bcfg_kw["max_slots"]
    rng = np.random.default_rng(SEED + 1)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, 128)
                    .astype(np.int32), max_new_tokens=32, rid=i)
            for i in range(n)]
    queue = RequestQueue()
    queue.submit_all(reqs)
    bcfg = BatcherConfig(n_pages=worst_pool(reqs, n, bcfg_kw["page_size"]),
                         **bcfg_kw)
    eng = ContinuousBatcher(params, cfg, queue, bcfg, head=head)
    eng.step(0.0)
    if eng.live() != n:
        raise AssertionError(f"{eng.live()} of {n} slots live")
    walls = []
    for t in range(1, 9):
        t0 = time.perf_counter()
        eng.step(float(t))
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    syncs = host_syncs(lambda: eng.step(9.0))
    prof = profile(lambda: eng.step(10.0), totals=("run_kernel",))
    if eng.live() != n or eng.steps != 12:
        raise AssertionError("the full-occupancy rounds admitted or retired")
    return {"slots": n, "wall_ms_median": statistics.median(walls),
            "wall_ms": walls,
            "host_syncs_per_step": len(syncs), "host_syncs_at": syncs,
            "profile": prof}


def batcher(card):
    """The continuous batcher (``serve/batcher.py``) on qwen3-4b with the
    sparse MLP and head (runs A, B, D, E) and on granite-moe-3b (run C),
    f32, weights from seed 0, at full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import lm
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import (STATUSES, BatcherConfig, ContinuousBatcher,
                                   FaultSchedule, Request, RequestQueue,
                                   SamplingConfig, SparseLogitHead,
                                   apply_malformed)
    from repro_torch.serve.batcher import request_generator
    from repro_torch.serve.paged_cache import pages_for
    from repro_torch.serve.workload import poisson_requests, worst_pool
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), sparse_mlp=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    head = SparseLogitHead.build(init_sparse_linear(
        gen, cfg.d_model, cfg.vocab_padded, block_shape=(64, 64),
        block_density=0.5))
    plan0 = head.plan
    torch.cuda.synchronize()

    def engine(reqs, bcfg, cls=ContinuousBatcher, **kw):
        queue = RequestQueue()
        if queue.submit_all(reqs) != len(reqs):
            raise AssertionError("the queue rejected a request")
        return cls(params, cfg, queue, bcfg, head=head, **kw)

    # ---- run A: the slice's main path, greedy, counted ------------------
    reqs = poisson_requests(cfg.vocab_size, SEED, **BATCH_A)
    bcfg_a = BatcherConfig(n_pages=worst_pool(
        reqs, BATCH_GEOMETRY["max_slots"], BATCH_GEOMETRY["page_size"]),
        **BATCH_GEOMETRY)
    eng = engine(reqs, bcfg_a)
    torch.cuda.reset_peak_memory_stats()
    zero_spmm_counters()
    with no_replan():
        wall_s, rounds = drive(eng)
    torch.cuda.synchronize()
    launches = spmm_counters()
    passes = eng.steps + eng.admitted      # forward passes, no fallback
    expect = {"maple_spmm_naive": cfg.n_layers * passes,
              "maple_spmm_compact": 0, "maple_spmm_planned": 0}
    expect[PLANNED[head.plan.fused]] += passes
    comps = eng.completions
    mem = eng.memory_stats()
    if launches != expect:
        raise AssertionError(f"run A launched {launches}, expected {expect} "
                             f"({eng.steps} fused steps, {eng.admitted} "
                             f"admissions)")
    if head.plan is not plan0:
        raise AssertionError("the head's plan changed during the run")
    if len(comps) != len(reqs) or any(c.status != "length" for c in comps):
        raise AssertionError(f"run A statuses {[c.status for c in comps]}")
    if eng.fallbacks or not 0 < mem["peak_pages"] < \
            mem["static_equiv_pages"] or eng.allocator.in_use:
        raise AssertionError(f"run A pages {mem}, in use "
                             f"{eng.allocator.in_use}")
    fused, admit = round_times(rounds)
    tokens = sum(len(c.tokens) for c in comps)
    run_a = {
        "requests": len(reqs), "geometry": BATCH_GEOMETRY, "workload":
        BATCH_A, "n_pages": bcfg_a.n_pages, "rounds": eng.rounds,
        "fused_steps": eng.steps, "admissions": eng.admitted,
        "mean_occupancy": eng.occupancy_sum / eng.steps, "tokens": tokens,
        "wall_s": wall_s, "tok_per_s": tokens / wall_s,
        "fused_step_wall_ms_median": statistics.median(fused) * 1e3,
        "fused_step_wall_ms_p90": float(np.percentile(fused, 90)) * 1e3,
        "prefill_ms_per_admission": statistics.mean(admit) * 1e3,
        "prefill_ms_by_round": [x * 1e3 for x in admit],
        "peak_pages": mem["peak_pages"],
        "static_equiv_pages": mem["static_equiv_pages"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "launches_expected": expect,
        "head_plan_unchanged": True}
    run_a["vs_complete_static"] = static_check(params, cfg, head, comps, reqs,
                                               "run A")
    run_a["full_occupancy"] = full_step_profile(params, cfg, head,
                                                BATCH_GEOMETRY)
    run_a["fused_graph"] = fused_graph_check(
        params, cfg, head, BATCH_GEOMETRY["max_slots"],
        BATCH_GEOMETRY["page_size"])
    del eng

    # ---- run B: chaos ----------------------------------------------------
    reqs = poisson_requests(cfg.vocab_size, 7, **BATCH_B)
    faults = FaultSchedule.sample(
        7, 64, p_transient=0.1, max_burst=3, p_poison=0.08, max_slot=8,
        p_deny=0.08, n_requests=len(reqs), p_malformed=0.15)
    apply_malformed(reqs, faults, cfg.vocab_size, seed=7)
    for i, r in enumerate(reqs):
        if i % 3 == 1:
            r.deadline = r.arrival + 12.0
    page = BATCH_GEOMETRY["page_size"]
    biggest = max(pages_for(r.prompt_len + r.max_new_tokens, page)
                  for r in reqs)
    n_pages = max(biggest + 3, int(0.6 * worst_pool(reqs, 8, page)))
    max_seq = pages_for(max(r.prompt_len + r.max_new_tokens for r in reqs),
                        page) * page
    bcfg_b = BatcherConfig(max_slots=8, page_size=page, n_pages=n_pages,
                           max_seq=max_seq)
    eng = engine(reqs, bcfg_b, faults=faults)
    zero_spmm_counters()
    wall_s, _ = drive(eng)
    chaos_launches = spmm_counters()
    comps = eng.completions
    fs = eng.fault_stats()
    if len(comps) != len(reqs) or any(c.status not in STATUSES
                                      for c in comps):
        raise AssertionError(f"run B completions {comps}")
    if not (fs["quarantined"] + fs["retries"] + fs["preemptions"]
            + fs["sheds"] + fs["errors"]):
        raise AssertionError(f"the chaos did not bite: {fs}")
    if eng.allocator.in_use:
        raise AssertionError(f"run B left {eng.allocator.in_use} pages")
    run_b = {"requests": len(reqs), "n_pages": n_pages, "max_seq": max_seq,
             "rounds": eng.rounds, "fused_steps": eng.steps,
             "admissions": eng.admitted, "wall_s": wall_s,
             "fault_stats": fs,
             "statuses": {s: sum(c.status == s for c in comps)
                          for s in STATUSES},
             "launches": chaos_launches,
             "vs_complete_static": static_check(
                 params, cfg, head, [c for c in comps if c.ok], reqs,
                 "run B")}
    del eng

    # ---- run D: sampled, per-request generators; B3 and B4 held against
    # their plain versions at the engine's shapes ---------------------------
    sampling = SamplingConfig(**SAMPLED)
    Recording = recording_batcher()
    held = {}

    def sampled_run(reqs, check=False):
        eng = engine(reqs, bcfg_a, cls=Recording, sampling=sampling,
                     seed=SEED)
        zero_spmm_counters()
        with (held_against_plain(held) if check
              else contextlib.nullcontext()):
            drive(eng)
        eng.launches = spmm_counters()
        return eng

    first4 = lambda: poisson_requests(cfg.vocab_size, SEED,  # noqa: E731
                                      **BATCH_A)[:4]
    runs = [sampled_run(first4(), check=True), sampled_run(first4())]
    slots, d_ff = BATCH_GEOMETRY["max_slots"], cfg.d_ff
    shapes = {("maple_spmm_naive", slots, d_ff, 1),
              ("maple_spmm_planned", 1, cfg.d_model, slots),
              ("maple_spmm_planned", 1, cfg.d_model, 1),
              *(("maple_spmm_naive", 1, d_ff, r.prompt_len)
                for r in first4())}
    if not shapes <= set(held):
        raise AssertionError(f"run D held {sorted(held)}, not every shape "
                             f"of {sorted(shapes)}")
    if [dataclasses.asdict(c) for c in runs[0].completions] != \
            [dataclasses.asdict(c) for c in runs[1].completions]:
        raise AssertionError("two sampled runs differ")
    alone = sampled_run(first4()[:1])
    key0 = request_generator(SEED, 0, "cuda").initial_seed()
    rows_b, rows_a = runs[0].rows[key0], alone.rows[key0]
    if len(rows_a) != len(rows_b) or not all(
            torch.equal(a, b) for a, b in zip(rows_a, rows_b)):
        raise AssertionError("request 0's logits alone differ from its "
                             "logits in the batch")
    tok_b = {c.rid: c.tokens for c in runs[0].completions}
    if alone.completions[0].tokens != tok_b[0]:
        raise AssertionError("request 0 samples other tokens alone")
    run_d = {"requests": 4, "sampling": SAMPLED, "seed": SEED,
             "launches": [e.launches for e in runs + [alone]],
             "runs_equal": True, "logit_rows_bit_equal_alone": len(rows_a),
             "tokens_equal_alone": True,
             "held_against_plain": {" ".join(map(str, k)): v
                                    for k, v in sorted(held.items())},
             "distinct_tokens": len({t for c in runs[0].completions
                                     for t in c.tokens})}
    del runs, alone

    # ---- run E: retry exhaustion drains the live slots on the static path
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in FALLBACK["prompt"]]

    def drain_reqs():
        return [Request(tokens=p, max_new_tokens=m, arrival=a, rid=i)
                for i, (p, m, a) in enumerate(zip(
                    prompts, FALLBACK["new"], FALLBACK["arrival"]))]

    drain = FaultSchedule(transient={DRAIN_ROUND: bcfg_a.max_retries + 1})

    def drained(eng, what):
        drive(eng)
        done = {c.rid: c for c in eng.completions}
        if (eng.fallbacks, eng.retries) != (1, bcfg_a.max_retries) or \
                [done[i].t_done for i in (0, 1)] != [DRAIN_ROUND] * 2 or \
                done[2].t_done <= DRAIN_ROUND or eng.allocator.in_use or \
                any(c.status != "length" for c in done.values()):
            raise AssertionError(f"{what}: fallbacks {eng.fallbacks}, "
                                 f"retries {eng.retries}, completions "
                                 f"{eng.completions}")
        return done

    eng = engine(drain_reqs(), bcfg_a, faults=drain)
    done = drained(eng, "run E")
    run_e = {"requests": 3, "drain_round": DRAIN_ROUND, **FALLBACK,
             "fused_steps": eng.steps, "fault_stats": eng.fault_stats(),
             "vs_complete_static": static_check(
                 params, cfg, head, list(done.values()), drain_reqs(),
                 "run E")}
    eng = engine(drain_reqs(), bcfg_a, sampling=sampling, seed=SEED,
                 faults=drain)
    got = drained(eng, "run E sampled")
    eng = engine(drain_reqs(), bcfg_a, sampling=sampling, seed=SEED)
    drive(eng)
    want = {c.rid: c for c in eng.completions}
    if {r: c.tokens for r, c in got.items()} != \
            {r: c.tokens for r, c in want.items()}:
        raise AssertionError("run E sampled: the drained requests draw "
                             "other tokens than uninterrupted")
    run_e["sampled_tokens_equal_uninterrupted"] = sum(
        len(c.tokens) for c in got.values())
    del eng, params, head
    release_graphs()          # the static path's graphs hold the weights
    torch.cuda.empty_cache()

    # ---- run C: granite-moe-3b through the same engine --------------------
    mcfg = get_config(MOE_ARCH)
    mparams = lm.init_params(mcfg, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    reqs = poisson_requests(mcfg.vocab_size, SEED, **BATCH_C)
    max_seq = pages_for(max(r.prompt_len + r.max_new_tokens for r in reqs),
                        page) * page
    bcfg_c = BatcherConfig(max_slots=4, page_size=page, max_seq=max_seq,
                           n_pages=worst_pool(reqs, 4, page))
    queue = RequestQueue()
    queue.submit_all(reqs)
    eng = ContinuousBatcher(mparams, mcfg, queue, bcfg_c)
    moe_gemm.launches = 0
    wall_s, rounds = drive(eng)
    torch.cuda.synchronize()
    moe_launches = {"moe_gemm": moe_gemm.launches}
    moe_expect = {"moe_gemm": 3 * mcfg.n_layers * (eng.steps + eng.admitted)}
    comps = eng.completions
    if moe_launches != moe_expect:
        raise AssertionError(f"run C launched {moe_launches}, expected "
                             f"{moe_expect}")
    if len(comps) != len(reqs) or any(
            c.status != "length" or not all(0 <= t < mcfg.vocab_size
                                            for t in c.tokens)
            for c in comps) or eng.allocator.in_use:
        raise AssertionError(f"run C completions {comps}")
    fused_c, admit_c = round_times(rounds)
    run_c = {"arch": MOE_ARCH, "requests": len(reqs), "max_slots": 4,
             "max_seq": max_seq, "n_pages": bcfg_c.n_pages,
             "rounds": eng.rounds, "fused_steps": eng.steps,
             "admissions": eng.admitted,
             "mean_occupancy": eng.occupancy_sum / eng.steps,
             "wall_s": wall_s,
             "tok_per_s": sum(len(c.tokens) for c in comps) / wall_s,
             "fused_step_wall_ms_median": statistics.median(fused_c) * 1e3,
             "fused_step_wall_ms": [w * 1e3 for w in fused_c],
             "prefill_ms_per_admission": statistics.mean(admit_c) * 1e3,
             "prefill_ms_by_round": [x * 1e3 for x in admit_c],
             "launches": moe_launches, "launches_expected": moe_expect}
    del eng, mparams
    release_graphs()
    torch.cuda.empty_cache()
    return ({"batcher": launches, "batcher_moe": moe_launches}, {
        "phase": "batcher", "config": f"{SERVE_ARCH} sparse_mlp (64,64) "
        f"d=0.25, sparse head (64,64) d=0.5; {MOE_ARCH}; f32, random "
        f"weights from seed {SEED}", "n_layers": cfg.n_layers,
        "depth_reduced": False, "card": card, "A": run_a, "B": run_b,
        "C": run_c, "D": run_d, "E": run_e})

# --------------------------------------------------------------------------
# phase 13: block-sparse local attention (B9) against its plain version
# --------------------------------------------------------------------------

def block_attn_kernels_edge():
    """B9 against the plain version on the card, f32 and bf16 (bf16 also
    by ``check_rows``): the reference sweep's four shapes, bq != bk and
    hd 256; each twice for bit identity."""
    from repro_torch.kernels import local_window_kv_map
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for s, w, bq, bk, hd in ATTN_EDGE:
            rng = np.random.default_rng(s + w + bq)
            q, k, v = [torch.from_numpy(rng.standard_normal((2, s, 4, hd))
                                        .astype(np.float32)).cuda().to(dtype)
                       for _ in range(3)]
            kv_map = torch.from_numpy(local_window_kv_map(s, w, bq,
                                                          bk)).cuda()
            got = [block_attention(q, k, v, kv_map, bq=bq, bk=bk, window=w)
                   for _ in range(2)]
            torch.cuda.synchronize()
            what = f"block_attention S{s} w{w} bq{bq} bk{bk} hd{hd} {dtype}"
            if not torch.equal(got[0], got[1]):
                raise AssertionError(f"{what}: two runs differ")
            want = block_attention_plain(q, k, v, kv_map, bq=bq, bk=bk,
                                         window=w)
            case = {"S": s, "window": w, "bq": bq, "bk": bk, "hd": hd,
                    "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": check_close(got[0], want, dtype, what)}
            if dtype == torch.bfloat16:
                case["max_row_rel_err"] = check_rows(got[0], want, what)
            cases.append(case)
    return {"phase": "block_attn_kernels", "cases": cases,
            "bit_identical": True, "ok": True}


# --------------------------------------------------------------------------
# phase 14: local attention at recurrentgemma-9b's shape
# --------------------------------------------------------------------------

def local_attention(spec, flush, card):
    """``ops.local_block_attention`` at recurrentgemma-9b's local-attention
    shape (its one kv head repeated to the 16 query heads, as a model
    would), in f32 and bf16, one launch a call, each held against the
    plain version and the dense oracle (one example at a time; bf16 also
    by ``check_rows``); then each
    timed beside the bound, the plain version and
    ``scaled_dot_product_attention`` in the same dtype with a band mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import local_block_attention, local_window_kv_map
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    from repro_torch.kernels.ref import local_attention_ref
    torch.cuda.empty_cache()
    b, s, h, hd = ATTN["B"], ATTN["S"], ATTN["H"], ATTN["hd"]
    window, bq, bk = ATTN["window"], ATTN["bq"], ATTN["bk"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q32 = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    k32, v32 = [torch.randn((b, s, 1, hd), generator=gen, device="cuda")
                .expand(b, s, h, hd).contiguous() for _ in range(2)]
    kv_map_np = local_window_kv_map(s, window, bq, bk)
    kv_map = torch.from_numpy(kv_map_np).cuda()
    live = int((kv_map_np >= 0).sum())
    # the (q, k) pairs the function needs: key k is visible from query q
    # when 0 <= q - k < window; QK^T and PV take 2·hd FLOPs each a pair
    pairs = int(np.minimum(np.arange(1, s + 1), window).sum())
    flops = 4 * hd * pairs * h * b
    qpos = torch.arange(s, device="cuda")
    band = ((qpos[:, None] >= qpos[None, :])
            & (qpos[:, None] - qpos[None, :] < window))
    launches, first_ms, plain_err, dense_err, rows = {}, {}, {}, {}, []
    row_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        block_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = local_block_attention(q, k, v, window=window, bq=bq, bk=bk)
        torch.cuda.synchronize()
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = block_attention.launches
        if launches[name] != 1:
            raise AssertionError(f"local_block_attention {name} launches "
                                 f"{launches[name]}, expected one")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite attention output ({name})")
        plain = block_attention_plain(q, k, v, kv_map, bq=bq, bk=bk,
                                      window=window)
        plain_err[name] = check_close(out, plain, dtype,
                                      f"B9 {name} against plain")
        if dtype == torch.bfloat16:
            row_err["plain"] = check_rows(out, plain, "B9 bf16 against "
                                          "plain")
        del plain
        dense_err[name] = 0.0
        for i in range(b):
            what = f"B9 {name} against the dense oracle, example {i}"
            want = local_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                       window=window)
            dense_err[name] = max(dense_err[name], check_close(
                out[i:i + 1], want, dtype, what))
            if dtype == torch.bfloat16:
                row_err["dense_oracle"] = max(row_err.get(
                    "dense_oracle", 0.0), check_rows(out[i:i + 1], want,
                                                     what))
            del want
        del out
        torch.cuda.empty_cache()
        # q, k and v read once, the output written once, and kv_map
        nbytes = 4 * q.numel() * q.element_size() + kv_map_np.size * 4
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows.append(measure_sparse(
            "block_attention",
            lambda: block_attention(q, k, v, kv_map, bq=bq, bk=bk,
                                    window=window),
            lambda: block_attention_plain(q, k, v, kv_map, bq=bq, bk=bk,
                                          window=window),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=band),
            nbytes, flops, dtype, spec, flush,
            shape=f"recurrentgemma-9b local attention B={b} S={s} H={h} "
            f"hd={hd} window={window} bq={bq} bk={bk}, live tiles {live}, "
            f"visible pairs {pairs}"))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    line = {"phase": "local_attention", **ATTN, "nq": kv_map_np.shape[0],
            "max_nb": kv_map_np.shape[1], "live_tiles_per_head": live,
            "visible_pairs_per_head": pairs,
            "launches_per_call": launches, "first_call_ms": first_ms,
            "plain_max_abs_err": plain_err,
            "dense_oracle_max_abs_err": dense_err,
            "bf16_max_row_rel_err": row_err, "row_limit": ROW_LIMIT,
            "ms": {r["dtype"]: r["ms"] for r in rows}, "card": card}
    del q32, k32, v32, band
    torch.cuda.empty_cache()
    return {"block_attention": sum(launches.values())}, rows, line


# --------------------------------------------------------------------------
# phases 17 to 21: the recurrent families
# --------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-9b"
SSM_ARCH = "mamba2-2.7b"
# the long request of each serve phase, (prompt length, prefix): past
# recurrentgemma-9b's window of 2 048 (B9 skips tile 0 for the last
# q-blocks; the 8 decode steps run over a wrapped rolling cache), and
# mamba2-2.7b over two SSD chunks of 256 from a one-chunk prefix (the
# reference refuses a prompt above one chunk that is not a multiple of
# it, so the prefix is one chunk and 256 decode steps follow)
HYBRID_LONG = (2304, 2296)
SSM_LONG = (512, 256)
# the batcher smoke on the card: recurrentgemma's window-horizon case (1
# request of 8 + 40 tokens through a pool of 8 pages of 4), mamba2's
# mid-stream join (request 2 arrives at round 3)
HYBRID_SMOKE_BATCH = dict(prompt=8, new=40, page=4, n_pages=9, max_slots=2)
SSM_SMOKE_BATCH = dict(prompt=8, new=8, page=4, n_pages=32, max_slots=4)
# the encoder-decoder and vision-prefix slice: whisper-base and
# internvl2-1b at full width and depth; their kernel shapes are
# internvl's sparse down-projection (d_ff -> d_model) over the serve
# phase's 4 sequences at decode (N 1) and prefill (its 112 tokens behind
# 256 patches, N 368), and each sparse head one request at a time
ENCDEC_ARCH = "whisper-base"
VLM_ARCH = "internvl2-1b"
VLM_MLP = dict(name="internvl2-1b mlp_down 896x4864 (64,64) d=0.25",
               d_out=896, d_in=4864, block=(64, 64), density=0.25, G=4,
               N=(1, 112 + 256))
ENCDEC_HEAD = dict(name="whisper-base logit_head 53248x512 (64,64) d=0.5 "
                   "L=8", d_out=53_248, d_in=512, block=(64, 64),
                   density=0.5, n_lanes=8, G=1, N=(1,))
VLM_HEAD = dict(ENCDEC_HEAD, name="internvl2-1b logit_head 153600x896 "
                "(64,64) d=0.5 L=8", d_out=153_600, d_in=896)


def cuda_tree(tree):
    """A parameter tree's copy on the card (a sparse weight keeps its host
    pattern)."""
    from repro_torch.core.csr import BlockCSR
    if isinstance(tree, dict):
        return {k: cuda_tree(v) for k, v in tree.items()}
    if isinstance(tree, BlockCSR):
        return dataclasses.replace(tree, blocks=tree.blocks.cuda(),
                                   device_meta={})
    return tree.cuda()


def recurrent_reference(arch, phase):
    """``arch``'s smoke config (recurrentgemma-9b with a sparse MLP at
    (8, 8)) on the card against the same weights on the CPU: the logits of
    a prefill and of 24 decode steps fed the same tokens within 1e-4,
    greedy ``generate`` tokens equal, B9 once per local-attention layer in
    the card's prefill; then the batcher on the card against ``generate``
    (``recurrent_batcher_smoke``).  Returns the B9 launches and the
    line."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.block_attn import block_attention
    from repro_torch.models import lm
    from repro_torch.serve import SamplingConfig, generate
    cfg = get_smoke_config(arch)
    if cfg.ffn_kind == "dense":
        cfg = dataclasses.replace(cfg, sparse_mlp=True, sparse_block=(8, 8))
    _, n_local = model_kernels(cfg)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    gpu = cuda_tree(cpu)
    # recurrentgemma: 40 tokens, past its window of 16, so the 24 decode
    # steps wrap the rolling cache; mamba2: two SSD chunks of 32
    prompt_len = 40 if n_local else 2 * cfg.ssm_chunk
    new = 24
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, prompt_len)))
    sampling = SamplingConfig(max_new_tokens=new)
    block_attention.launches = 0
    tok_gpu, _ = generate(gpu, cfg, {"tokens": prompts.cuda()}, sampling)
    launches = {"block_attention": block_attention.launches}
    if launches["block_attention"] != n_local:
        raise AssertionError(f"{arch} smoke: B9 launched {launches}, "
                             f"expected {n_local} (one a local-attention "
                             f"layer in the prefill)")
    tok_cpu, _ = generate(cpu, cfg, {"tokens": prompts}, sampling)
    if not torch.equal(tok_cpu, tok_gpu.cpu()):
        raise AssertionError(f"{arch} smoke: card greedy tokens differ from "
                             f"the CPU's")
    rows = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        logits, state = lm.prefill(params, cfg,
                                   {"tokens": prompts.to(dev)},
                                   max_seq=prompt_len + new)
        rows[dev] = [logits.cpu()]
        for t in range(new - 1):
            logits, state = lm.decode_step(params, cfg, state,
                                           tok_cpu[:, t:t + 1].to(dev))
            rows[dev].append(logits.cpu())
    errs = [float((g - c).abs().max())
            for g, c in zip(rows["cuda"], rows["cpu"])]
    if not all(torch.allclose(g, c, rtol=1e-4, atol=1e-4)
               for g, c in zip(rows["cuda"], rows["cpu"])):
        raise AssertionError(f"{arch} smoke: card logits differ from the "
                             f"CPU's by up to {max(errs)}")
    return launches, {
        "phase": phase, "config": f"{arch} smoke"
        f"{', sparse_mlp (8,8)' if cfg.sparse_mlp else ''}, f32",
        "prompt_len": prompt_len, "decode_steps": new - 1,
        "prefill_max_abs_err": errs[0], "decode_max_abs_err": max(errs[1:]),
        "greedy_tokens_equal": True, "launches": launches,
        "batcher": recurrent_batcher_smoke(gpu, cfg, n_local)}


def recurrent_batcher_smoke(params, cfg, n_local):
    """The continuous batcher on the card at the smoke config, against
    ``generate``: recurrentgemma's window-horizon case (pages reclaimed
    behind the window, peak pages bounded by it) or mamba2's mid-stream
    join (no pages)."""
    from repro_torch.kernels.block_attn import block_attention
    from repro_torch.serve import (BatcherConfig, ContinuousBatcher, Request,
                                   RequestQueue, SamplingConfig, generate)
    from repro_torch.serve.paged_cache import pages_for
    case = HYBRID_SMOKE_BATCH if n_local else SSM_SMOKE_BATCH
    arrivals = (0.0,) if n_local else (0.0, 0.0, 3.0)
    prompts = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (len(arrivals), case["prompt"]))
    queue = RequestQueue()
    queue.submit_all([Request(tokens=prompts[i], max_new_tokens=case["new"],
                              arrival=a, rid=i)
                      for i, a in enumerate(arrivals)])
    eng = ContinuousBatcher(params, cfg, queue, BatcherConfig(
        max_slots=case["max_slots"], page_size=case["page"],
        n_pages=case["n_pages"], max_seq=case["prompt"] + case["new"]))
    block_attention.launches = 0
    comps = {c.rid: c for c in eng.run()}
    b9 = block_attention.launches

    def solo(rows):
        out, _ = generate(params, cfg, {"tokens": torch.from_numpy(
            prompts[rows]).cuda()}, SamplingConfig(max_new_tokens=case["new"]))
        return out.tolist()

    want = solo(slice(0, 1)) if n_local else solo(slice(0, 2)) +         solo(slice(2, 3))
    got = [comps[i].tokens for i in range(len(arrivals))]
    mem = eng.memory_stats()
    if got != want or any(c.status != "length" for c in comps.values()):
        raise AssertionError(f"{cfg.name} smoke batcher: tokens {got}, "
                             f"generate {want}")
    if b9 != n_local * eng.admitted or eng.allocator.in_use:
        raise AssertionError(f"{cfg.name} smoke batcher: B9 {b9} over "
                             f"{eng.admitted} admissions, pages in use "
                             f"{eng.allocator.in_use}")
    if n_local and not (mem["reclaimed"] > 0 and mem["peak_pages"] <=
                        pages_for(cfg.window, case["page"]) + 2):
        raise AssertionError(f"{cfg.name} smoke batcher: pages {mem}")
    if not n_local and eng.allocator.total_allocs:
        raise AssertionError("a pure-recurrent model allocated KV pages")
    return {**case, "requests": len(arrivals), "rounds": eng.rounds,
            "fused_steps": eng.steps, "admissions": eng.admitted,
            "b9_launches": b9, "tokens_equal_generate": True, **mem}


def hybrid_batcher(card):
    """recurrentgemma-9b at full width and depth with the sparse MLP and
    head through the continuous batcher: the serve bench's workload at run
    C's shape (6 greedy requests), 4 slots, pages of 16.  Launches exactly
    B9 12 × admissions, B3 38 × (fused steps + admissions), B4 fused steps
    + admissions; every request ends by length with the tokens of
    ``complete_static`` through the same head (the margin rule)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.block_attn import block_attention
    from repro_torch.models import lm
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import (BatcherConfig, ContinuousBatcher,
                                   RequestQueue, SparseLogitHead)
    from repro_torch.serve.paged_cache import pages_for
    from repro_torch.serve.workload import poisson_requests, worst_pool
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), sparse_mlp=True)
    n_mlp, n_local = model_kernels(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    head = SparseLogitHead.build(init_sparse_linear(
        gen, cfg.d_model, cfg.vocab_padded, block_shape=(64, 64),
        block_density=0.5))
    reqs = poisson_requests(cfg.vocab_size, SEED, **BATCH_C)
    page = BATCH_GEOMETRY["page_size"]
    max_seq = pages_for(max(r.prompt_len + r.max_new_tokens for r in reqs),
                        page) * page
    bcfg = BatcherConfig(max_slots=4, page_size=page, max_seq=max_seq,
                         n_pages=worst_pool(reqs, 4, page))
    queue = RequestQueue()
    queue.submit_all(reqs)
    eng = ContinuousBatcher(params, cfg, queue, bcfg, head=head)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_spmm_counters()
    block_attention.launches = 0
    with no_replan():
        wall_s, rounds = drive(eng)
    torch.cuda.synchronize()
    launches = {**spmm_counters(),
                "block_attention": block_attention.launches}
    passes = eng.steps + eng.admitted
    expect = {"maple_spmm_naive": n_mlp * passes, "maple_spmm_compact": 0,
              "maple_spmm_planned": 0,
              "block_attention": n_local * eng.admitted}
    expect[PLANNED[head.plan.fused]] += passes
    comps = eng.completions
    if launches != expect:
        raise AssertionError(f"hybrid_batcher launched {launches}, expected "
                             f"{expect} ({eng.steps} fused steps, "
                             f"{eng.admitted} admissions)")
    if len(comps) != len(reqs) or any(c.status != "length" for c in comps) \
            or eng.allocator.in_use or eng.fallbacks:
        raise AssertionError(f"hybrid_batcher completions {comps}")
    fused, admit = round_times(rounds)
    tokens = sum(len(c.tokens) for c in comps)
    mem = eng.memory_stats()
    line = {
        "phase": "hybrid_batcher", "config": f"{HYBRID_ARCH} sparse_mlp "
        f"(64,64) d=0.25, sparse head (64,64) d=0.5, f32, random weights "
        f"from seed {SEED}", "n_layers": cfg.n_layers,
        "depth_reduced": False, "workload": BATCH_C, "requests": len(reqs),
        "max_slots": 4, "page_size": page, "max_seq": max_seq,
        "n_pages": bcfg.n_pages, "rounds": eng.rounds,
        "fused_steps": eng.steps, "admissions": eng.admitted,
        "mean_occupancy": eng.occupancy_sum / eng.steps, "tokens": tokens,
        "wall_s": wall_s, "tok_per_s": tokens / wall_s,
        "fused_step_wall_ms_median": statistics.median(fused) * 1e3,
        "fused_step_wall_ms": [w * 1e3 for w in fused],
        "prefill_ms_per_admission": statistics.mean(admit) * 1e3,
        "peak_pages": mem["peak_pages"],
        "static_equiv_pages": mem["static_equiv_pages"],
        "reclaimed": mem["reclaimed"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "launches_expected": expect, "card": card}
    line["vs_complete_static"] = static_check(params, cfg, head, comps, reqs,
                                              "hybrid_batcher")
    del eng
    line["fused_graph"] = fused_graph_check(params, cfg, head, 4, page)
    del params, head
    release_graphs()
    torch.cuda.empty_cache()
    return launches, line


def hybrid_attention_rows(spec, flush):
    """B9 at recurrentgemma-9b's two prefill shapes on the serve path (4
    prompts of 112 tokens padded to 128, and the long request of 2 304),
    f32, its one kv head repeated to 16 as the model does: timed beside
    the bound, the plain version and SDPA with a band mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import local_window_kv_map
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    h, hd, window = ATTN["H"], ATTN["hd"], ATTN["window"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for b, s in ((4, pad_block(112)), (1, HYBRID_LONG[0])):
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
        k, v = [torch.randn((b, s, 1, hd), generator=gen, device="cuda")
                .expand(b, s, h, hd).contiguous() for _ in range(2)]
        kv_map_np = local_window_kv_map(s, window, 128, 128)
        kv_map = torch.from_numpy(kv_map_np).cuda()
        pairs = int(np.minimum(np.arange(1, s + 1), window).sum())
        qpos = torch.arange(s, device="cuda")
        band = ((qpos[:, None] >= qpos[None, :])
                & (qpos[:, None] - qpos[None, :] < window))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows.append(measure_sparse(
            "block_attention",
            lambda: block_attention(q, k, v, kv_map, window=window),
            lambda: block_attention_plain(q, k, v, kv_map, window=window),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=band),
            4 * q.numel() * 4 + kv_map_np.size * 4, 4 * hd * pairs * h * b,
            torch.float32, spec, flush,
            shape=f"recurrentgemma-9b prefill B={b} S={s} H={h} hd={hd} "
            f"window={window}, visible pairs {pairs}"))
    return rows


def extras_reference(arch, phase):
    """``arch``'s smoke config (internvl2-1b with a sparse MLP at (8, 8))
    with every bias drawn non-zero (``draw_biases``: layer norms, GELU
    MLPs, QKV) on the card against the same weights on the CPU: greedy
    ``generate`` tokens equal; the logits of a prefill and of 8 decode
    steps fed the same tokens within 1e-4; one request through an (8, 8)
    sparse head by ``head_route``, tokens equal.  Whisper also fills an
    ``init_decode_state`` by ``prefill_cross_kv``, which must equal the
    prefill's cross caches within the f32 tolerance.  Launches are
    counted over the card's runs (B3 one a layer a forward pass, B4 one
    a head call).  Returns them and the line."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.layers import GATED, init_sparse_linear
    from repro_torch.serve import SamplingConfig, SparseLogitHead, generate
    cfg = get_smoke_config(arch)
    if cfg.activation in GATED:
        cfg = dataclasses.replace(cfg, sparse_mlp=True, sparse_block=(8, 8))
    n_mlp, _ = model_kernels(cfg)
    cpu_gen = torch.Generator().manual_seed(SEED)
    cpu = lm.init_params(cfg, cpu_gen, device="cpu")
    draw_biases(cpu, torch.Generator().manual_seed(SEED + 5))
    gpu = cuda_tree(cpu)
    w = init_sparse_linear(torch.Generator().manual_seed(SEED + 7),
                           cfg.d_model, cfg.vocab_padded, block_shape=(8, 8),
                           block_density=0.5)
    heads = {"cpu": SparseLogitHead.build(w),
             "cuda": SparseLogitHead.build(cuda_tree({"w": w})["w"])}
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 9)))
    extra = extra_inputs(cfg, 2, torch.Generator().manual_seed(SEED + 3))
    batch = {"cpu": {"tokens": prompts, **extra},
             "cuda": {"tokens": prompts.cuda(),
                      **{k: v.cuda() for k, v in extra.items()}}}
    params = {"cpu": cpu, "cuda": gpu}
    new, steps, route_new = 8, 8, 5
    seq = prompts.shape[1] + cfg.n_patches
    sampling = SamplingConfig(max_new_tokens=new)
    zero_spmm_counters()
    toks = {dev: generate(params[dev], cfg, batch[dev], sampling)[0].cpu()
            for dev in ("cuda", "cpu")}
    if not torch.equal(toks["cpu"], toks["cuda"]):
        raise AssertionError(f"{arch} smoke: card greedy tokens differ from "
                             f"the CPU's")
    rows = {}
    for dev in ("cuda", "cpu"):
        logits, state = lm.prefill(params[dev], cfg, batch[dev],
                                   max_seq=seq + steps)
        rows[dev] = [logits.cpu()]
        for t in range(steps):
            logits, state = lm.decode_step(params[dev], cfg, state,
                                           toks["cpu"][:, t:t + 1].to(dev))
            rows[dev].append(logits.cpu())
        if dev == "cuda":
            card_state = state
    errs = [float((g - c).abs().max())
            for g, c in zip(rows["cuda"], rows["cpu"])]
    if not all(torch.allclose(g, c, rtol=1e-4, atol=1e-4)
               for g, c in zip(rows["cuda"], rows["cpu"])):
        raise AssertionError(f"{arch} smoke: card logits differ from the "
                             f"CPU's by up to {max(errs)}")
    routed = {dev: head_route(params[dev], cfg, heads[dev],
                              prompts[0].numpy(),
                              {k: v[:1] for k, v in batch[dev].items()
                               if k != "tokens"}, route_new)[0]
              for dev in ("cuda", "cpu")}
    launches = spmm_counters()
    passes = (1 + new) + (1 + steps) + route_new
    expect = {"maple_spmm_naive": n_mlp * passes, "maple_spmm_compact": 0,
              "maple_spmm_planned": 0}
    expect[PLANNED[heads["cuda"].plan.fused]] += route_new
    if launches != expect:
        raise AssertionError(f"{arch} smoke: launches {launches}, expected "
                             f"{expect}")
    if routed["cpu"] != routed["cuda"]:
        raise AssertionError(f"{arch} smoke: card sparse-head tokens "
                             f"{routed['cuda']} differ from the CPU's "
                             f"{routed['cpu']}")
    cross_err = None
    if cfg.n_enc_layers:
        filled = lm.prefill_cross_kv(
            gpu, cfg, lm.init_decode_state(cfg, 2, seq + steps),
            batch["cuda"]["enc_frames"])
        cross_err = max(check_close(
            filled[key][b][name], card_state[key][b][name], torch.float32,
            f"{arch} smoke prefill_cross_kv {key}/{b}/{name}")
            for key in ("groups", "tail") if key in filled
            for b in filled[key] for name in ("cross_k", "cross_v"))
    return launches, {
        "phase": phase, "config": f"{arch} smoke"
        f"{', sparse_mlp (8,8)' if cfg.sparse_mlp else ''}, sparse head "
        f"(8,8) d=0.5, biases drawn, f32", "norm": cfg.norm,
        "activation": cfg.activation, "n_enc_layers": cfg.n_enc_layers,
        "n_patches": cfg.n_patches, "prompt_len": prompts.shape[1],
        "prefill_len": seq, "decode_steps": steps,
        "prefill_max_abs_err": errs[0], "decode_max_abs_err": max(errs[1:]),
        "greedy_tokens_equal": True, "head_route_tokens_equal": True,
        "prefill_cross_kv_max_abs_err": cross_err, "launches": launches}


def extras_rows(spec, flush):
    """B3 at internvl2-1b's sparse down-projection (896 × 4 864, (64, 64),
    d 0.25) over the serve phase's 4 sequences at decode (N 1) and prefill
    (112 tokens behind 256 patches: N 368), and B4 on both models' heads
    (whisper-base 53 248 × 512, internvl2-1b 153 600 × 896; (64, 64), d
    0.5, 8 lanes) at N 1, f32: each held against its plain version, then
    timed beside its bound, the plain version and ``torch.matmul``."""
    from repro_torch.kernels.maple_spmm import (maple_spmm_naive,
                                                maple_spmm_naive_plain)
    from repro_torch.kernels.schedule import plan_spmm
    rng = np.random.default_rng(SEED + 13)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    dtype, isz, rows = torch.float32, 4, []
    mlp = sparse_weight(gen, VLM_MLP, dtype)
    dense = mlp.to_dense()
    for n in VLM_MLP["N"]:
        g = VLM_MLP["G"]
        got, want, args, b3 = run_naive_case(mlp, g, n, dtype, 128, rng)
        nbytes, flops = spmm_cost(
            mlp, g, n, isz, out_bytes=g * mlp.shape[0] * n * isz,
            meta_bytes=4 * (mlp.n_block_rows + 1 + mlp.nnzb))
        rows.append(measure(
            "maple_spmm_naive", got, want, dtype,
            lambda: maple_spmm_naive(*args, bn=128),
            lambda: maple_spmm_naive_plain(*args),
            lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush,
            REPS, G=g, N=n, shape=VLM_MLP["name"]))
    del dense, mlp
    for shape in (ENCDEC_HEAD, VLM_HEAD):
        head = sparse_weight(gen, shape, dtype)
        plan = plan_spmm(head, n_lanes=shape["n_lanes"])
        for n in shape["N"]:
            rows.append(planned_row(head, plan, shape["G"], n, dtype, isz,
                                    spec, flush, rng, shape["name"]))
        del head, plan
    return rows


# --------------------------------------------------------------------------
# phases 27 to 31: training the audio, vlm, MoE and SSM families
# --------------------------------------------------------------------------

# (expert of each tile, E, D, F, bt): bt 8, 16, 56, 96 and 216 (two
# pieces of dx; dW's last stage past the tile), several tiles an expert,
# adjacent or not, experts with no tile (their dW is zero), D and F off
# multiples of 16 (72 × 40: TMA in both dtypes; 70 × 44: the producer's
# copies in both; 100 × 36 and 200 × 300: TMA in f32, the copies in
# bf16), granite-moe-3b's training tile (56 rows)
MOE_BACKWARD_EDGE = (([0, 0, 2], 3, 256, 128, 8),
                     ([1, 1, 3, 3], 4, 72, 40, 16),
                     ([0, 2, 2], 3, 70, 44, 96), ([1, 1], 3, 64, 48, 216),
                     ([0, 0, 0, 2, 2], 4, 1536, 512, 56),
                     ([3, 1, 3, 0, 3], 5, 72, 40, 56),
                     ([2, 0, 2, 1, 2], 4, 70, 44, 8),
                     ([0, 1, 0], 2, 100, 36, 216),
                     ([1, 0, 1], 3, 200, 300, 96))
# one train step of each smoke config, card against CPU: (arch, config
# overrides, tokens an example, microbatches of the step); recurrentgemma's
# 48 tokens are three of its windows of 16, qwen3-moe-235b's 2 layers one
# run of its two-level remat (chunk 2), and its 2 microbatches run the
# bf16 gradient accumulator
TRAIN_FAMILY_SMOKE = ((ENCDEC_ARCH, {}, 16, (2,)),
                      (VLM_ARCH, dict(sparse_mlp=True, sparse_block=(8, 8)),
                       16, (2,)),
                      (MOE_ARCH, {}, 16, (2,)), (SSM_ARCH, {}, 64, (2,)),
                      (HYBRID_ARCH, {}, 48, (2,)),
                      (HYBRID_ARCH, dict(sparse_mlp=True,
                                         sparse_block=(8, 8)), 48, (2,)),
                      ("qwen2-72b", {}, 16, (2,)),
                      ("qwen3-moe-235b-a22b", {}, 16, (1, 2)))
# each family at full width and depth through launch/train.main: AdamW
# steps of 256 tokens an example, f32, remat per layer, seed 0 (granite-
# moe-3b takes its config's 8 microbatches, the others their 4)
# (phase, arch, argv, held against the eager step)
TRAIN_FAMILIES = (
    ("train_encdec", ENCDEC_ARCH, ["--global-batch", "4"], True),
    ("train_vlm", VLM_ARCH, ["--sparse-mlp", "--global-batch", "4"], False),
    ("train_moe", MOE_ARCH, ["--global-batch", "8"], True),
    ("train_ssm", SSM_ARCH, ["--global-batch", "4"], False))
# 4 steps: the warm-up, the capture, then two steps replayed alone
TRAIN_FAMILY_ARGV = ["--steps", "4", "--seq-len", "256", "--seed", "0",
                     "--device", "cuda"]
# recurrentgemma-9b trained at full width: f32 with the sparse MLP at
# (64, 64) d 0.25, 8 sequences of 2 304 tokens (longer than its window of
# 2 048) in the config's own 8 microbatches, 3 steps; depth cut to the
# deepest 3u + 2 layers whose reckoned peak leaves HYBRID_TRAIN_FREE free.
# The reckoning is the eager step's; the captured step's pool holds more
# (a capture cannot give cached blocks back to retry an allocation): 11
# layers, 71.9 GiB reckoned and 72.88 measured eager, ran out of the card's
# 79.18 in the capture, 8 fit (34.1 GiB of pool), so the margin is 12 GiB
HYBRID_TRAIN = dict(steps=3, seq_len=2304, global_batch=8, seed=SEED,
                    device="cuda")
HYBRID_TRAIN_FREE = 12 * 2**30
# chunked_attention beside one SDPA call: train_hybrid's local attention
# (one microbatch) and a global causal qwen3-4b layer at 4 096 tokens
CHUNKED_SHAPES = (("recurrentgemma-9b local, train_hybrid",
                   dict(B=1, S=2304, H=16, KVH=1, hd=256, window=2048)),
                  ("qwen3-4b global causal",
                   dict(B=1, S=4096, H=32, KVH=8, hd=128, window=None)))
# granite-moe-3b's expert products in a training microbatch (1 × 256
# tokens: capacity 56), E = 48
MOE_TRAIN_CAP = 56
# the earlier kernels' ms at those shapes, (pass, product, dtype), as
# moe_train_rows measured them on an NVIDIA H100 80GB HBM3 at 700 W with
# dx on the producer's transposing copy and dW on a CTA a 64 × 64 tile
# fed by its own threads; printed as "was_ms" beside each new time
MOE_TRAIN_WAS_MS = {
    ("forward", "gate", "float32"): 0.1596,
    ("forward", "down", "float32"): 0.1593,
    ("forward", "gate", "bfloat16"): 0.0701,
    ("forward", "down", "bfloat16"): 0.0450,
    ("dx", "gate", "float32"): 0.3168, ("dx", "down", "float32"): 0.3211,
    ("dx", "gate", "bfloat16"): 0.0467, ("dx", "down", "bfloat16"): 0.0447,
    ("dW", "gate", "float32"): 0.2434, ("dW", "down", "float32"): 0.2443,
    ("dW", "gate", "bfloat16"): 0.2438, ("dW", "down", "bfloat16"): 0.2451}


def maple_counters():
    """Every Maple kernel wrapper that counts its launches, by name."""
    from repro_torch.kernels import launch_counters
    return launch_counters()


def moe_backward_kernels_edge():
    """B8's dx (its transposed-weight mode) and ``moe_dw_kernel`` against
    their plain versions on the card, f32 and bf16, over
    ``MOE_BACKWARD_EDGE``: each twice bit for bit, an expert with no tile
    a zero dW."""
    from repro_torch.kernels.moe_gemm import (moe_dw_route, moe_gemm_dw,
                                              moe_gemm_dw_plain, moe_gemm_dx,
                                              moe_gemm_dx_plain, moe_route)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for eot, e, d, f, bt in MOE_BACKWARD_EDGE:
            rng = np.random.default_rng(d + bt)
            t = len(eot) * bt
            x, dy = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(dtype) for shape in ((t, d), (t, f)))
            w = torch.from_numpy((rng.standard_normal((e, d, f)) * 0.1)
                                 .astype(np.float32)).cuda().to(dtype)
            eot_t = torch.tensor(eot, dtype=torch.int32, device="cuda")
            dx = [moe_gemm_dx(dy, eot_t, w, bt=bt) for _ in range(2)]
            dw = [moe_gemm_dw(x, dy, eot_t, e, bt=bt) for _ in range(2)]
            torch.cuda.synchronize()
            what = f"{eot} E{e} D{d} F{f} bt{bt} {dtype}"
            if not (torch.equal(dx[0], dx[1]) and torch.equal(dw[0], dw[1])):
                raise AssertionError(f"moe backward {what}: two runs differ")
            unused = sorted(set(range(e)) - set(eot))
            if unused and bool(dw[0][unused].any()):
                raise AssertionError(f"moe_gemm_dw {what}: an expert with no "
                                     f"tile has a non-zero dW")
            cases.append({
                "experts_of_tiles": eot, "E": e, "D": d, "F": f, "bt": bt,
                "dtype": str(dtype).replace("torch.", ""),
                "dx_copy": moe_route(dtype, t, d, f, bt,
                                     transposed=True)["copy"],
                "dw_copy": moe_dw_route(dtype, t, d, f, bt)["copy"],
                "dx_max_abs_err": check_close(
                    dx[0], moe_gemm_dx_plain(dy, eot_t, w, bt=bt), dtype,
                    f"moe_gemm_dx {what}"),
                "dw_max_abs_err": check_close(
                    dw[0], moe_gemm_dw_plain(x, dy, eot_t, e, bt=bt), dtype,
                    f"moe_gemm_dw {what}")})
    return {"phase": "moe_backward_kernels", "cases": cases,
            "bit_identical": True, "ok": True}


def train_families_reference():
    """One train step of each ``TRAIN_FAMILY_SMOKE`` smoke config (biases
    drawn non-zero), card against CPU as ``train_reference``: the loss
    within 1e-5 relative, every gradient within ``grads_close``, the
    parameters after one AdamW step within 2·lr."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import lm
    out = []
    for arch, over, seq, micros in TRAIN_FAMILY_SMOKE:
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        gen = torch.Generator().manual_seed(SEED)
        stacked = lm.init_params(cfg, gen, device="cpu")
        draw_biases(stacked, gen)
        cpu = lm.unstack_layers(stacked)
        extra = {}
        if cfg.n_enc_layers:
            extra["enc_frames"] = (4, cfg.enc_seq, cfg.d_model)
        if cfg.n_patches:
            extra["vision_embeds"] = (4, cfg.n_patches, cfg.d_model)
        batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=4,
                                       seed=SEED), 0, extra)
        for n_micro in micros:
            losses, grad_err, n_grads, param_err, lr = train_against_cpu(
                cfg, batch, cpu, n_micro)
            out.append({
                "config": f"{arch} smoke" + (", sparse_mlp (8,8)"
                                             if cfg.sparse_mlp else ""),
                "tokens": f"4 x {seq}, {n_micro} microbatches",
                "grad_accum_dtype": cfg.grad_accum_dtype if n_micro > 1
                else None,
                "two_level_remat": cfg.scan_remat_chunk > 1
                and cfg.n_layers % cfg.scan_remat_chunk == 0,
                "loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"],
                "grad_max_abs_err": grad_err, "n_grads": n_grads,
                "param_max_abs_err_after_step": param_err, "lr": lr})
    return {"phase": "train_families_reference", "models": out, "ok": True}


def train_family(card, phase, arch, argv, cfg=None, mesh=None, held=False):
    """``launch/train.main`` on ``arch`` at full width and depth
    (``TRAIN_FAMILY_ARGV``), or, given ``cfg`` (a depth cut, or a config
    run under ``mesh``), ``launch/train.run`` on it with ``argv`` its
    keywords: every Maple kernel's launches zeroed just before and read
    just after, against the count the path implies (sparse MLP:
    ``train``'s formula; MoE: per layer and microbatch 9 B8 launches, 3
    forward, 3 recomputed, 3 dx, and 3 ``moe_dw_kernel``, each once a
    ``model`` peer of an expert-parallel ``mesh``; 0 otherwise, B9 among
    them: attention trains on ``chunked_attention``); finite losses and
    grad norms; the captured step (``train_graph``: the warm-up, capture
    and replayed steps' walls, tokens/s, a replayed step's host syncs),
    the peak GiB; one more step profiled (under ``mesh`` too).  With
    ``held``, the run is then held against the same steps run eagerly
    (``held_against_eager``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import synth_batch
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.train.optimizer import named_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fns = maple_counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    if cfg is None:
        argv = ["--arch", arch, *argv, *TRAIN_FAMILY_ARGV]
        run = launch_train.main(argv)
    else:
        with use_mesh(mesh):
            run = launch_train.run(cfg, **argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg, steps = run.cfg, len(run.history)
    micro = cfg.train_microbatches
    per_layer = micro * cfg.n_layers * steps
    expect = dict.fromkeys(fns, 0)
    plan = lm.sparse_mlp_plan(run.params)
    if plan is not None:
        add_sparse_train_launches(expect, cfg, plan, steps)
    if cfg.ffn_kind == "moe":
        peers = ep_peers(mesh, cfg)
        expect["moe_gemm"] = 3 * (3 if cfg.remat else 2) * per_layer * peers
        expect["moe_gemm_dw"] = 3 * per_layer * peers
    if launches != expect:
        raise AssertionError(f"{phase}: kernel launches {launches}, "
                             f"expected {expect}")
    for rec in run.history:
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
            raise AssertionError(f"{phase}: non-finite step {rec}")
    tokens = run.data.global_batch * run.data.seq_len
    n_params = sum(t.numel() for _, t in named_leaves(run.params))
    captured = host_leaves(run.params) if held else None
    batch = {k: v.cuda() for k, v in synth_batch(run.data, steps,
                                                 run.extra).items()}
    graph = train_graph(run, batch, mesh)
    totals = ("run_kernel", "sddmm_kernel", "moe_kernel", "moe_dw_kernel")
    t0 = time.perf_counter()
    with use_mesh(mesh):
        prof = profile(lambda: run.step_fn(run.params, run.opt, batch),
                       warmup=False, totals=totals)
    prof["profile_s"] = time.perf_counter() - t0
    spec = without_state(run)
    del run, batch, plan
    torch.cuda.empty_cache()
    line = {
        "phase": phase, "config": f"{arch}" + (" sparse_mlp (64,64) d=0.25"
                                               if cfg.sparse_mlp else "")
        + ", f32, AdamW, remat per layer", "argv": argv,
        "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
        "depth_reduced": cfg.n_layers < get_config(arch).n_layers,
        "n_layers_full": get_config(arch).n_layers, "d_model": cfg.d_model,
        "n_params": n_params,
        "microbatches": micro, "tokens_per_step": tokens,
        "positions_per_step": spec.data.global_batch * (spec.data.seq_len
                                                        + cfg.n_patches),
        "extra_inputs": spec.extra,
        "loss": [rec["loss"] for rec in spec.history],
        "grad_norm": [rec["grad_norm"] for rec in spec.history],
        "finite": True,
        "step_ms": [rec["step_s"] * 1e3 for rec in spec.history],
        "graph": graph, "tok_per_s_replayed": [
            tokens / (ms / 1e3) for ms in graph["step_ms_replayed"]],
        "run_s": total_s, "peak_mem_gib": peak_gib, "launches": launches,
        "launches_expected": expect, "card": card, "profile": prof}
    if held:
        line["held_against_eager"] = held_against_eager(spec, captured,
                                                        phase, totals)
    return launches, line


def reckon_train_peak(cfg, micro_tokens):
    """Bytes a train step of ``cfg`` is reckoned to peak at, f32 with
    AdamW: 16 a parameter (the weight, its gradient, two moments), then
    the larger of the optimizer's per-leaf f32 temporaries (2.5 of the
    largest leaf, the embedding or head: the clipped gradient, the update
    and its denominator, the norm's square) and the loss's (three copies
    of a microbatch's f32 logits, and the head's gradient before it is
    added to ``.grad``).  The sparse MLP stores its density of the
    down-projection."""
    n = cfg.param_count()
    if cfg.sparse_mlp:
        ffn_layers = sum(k != "ssm" for k in cfg.block_kinds())
        n -= int(ffn_layers * cfg.d_ff * cfg.d_model
                 * (1 - cfg.sparse_density))
    leaf = 4 * cfg.vocab_padded * cfg.d_model
    logits = 4 * micro_tokens * cfg.vocab_padded
    return 16 * n + max(int(2.5 * leaf), 3 * logits + leaf), n


def hybrid_train_config():
    """recurrentgemma-9b at full width with the sparse MLP, at the
    deepest ``3u + 2`` layers (the unit (rglru, rglru, local_attn) ``u``
    times, then the tail of two RG-LRU layers) whose
    :func:`reckon_train_peak` leaves ``HYBRID_TRAIN_FREE`` of the card's
    free memory; (config, reckoning)."""
    from repro_torch.configs import get_config
    full = dataclasses.replace(get_config(HYBRID_ARCH), sparse_mlp=True)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    micro = HYBRID_TRAIN["global_batch"] // full.train_microbatches \
        * HYBRID_TRAIN["seq_len"]
    for units in range((full.n_layers - 2) // 3, 0, -1):
        cfg = dataclasses.replace(full, n_layers=3 * units + 2)
        peak, n = reckon_train_peak(cfg, micro)
        if peak + HYBRID_TRAIN_FREE <= free:
            return cfg, {"n_layers": cfg.n_layers, "units": units,
                         "n_layers_full": full.n_layers,
                         "params_reckoned": n,
                         "peak_reckoned_gib": peak / 2**30,
                         "free_before_gib": free / 2**30,
                         "card_gib": total / 2**30}
    raise AssertionError(f"not even 5 layers of {HYBRID_ARCH} fit in "
                         f"{free / 2**30:.1f} GiB free")


def train_hybrid(card):
    """``train_family`` on recurrentgemma-9b at full width (d_model 4 096,
    16 heads over 1 KV head, hd 256, d_ff 12 288, window 2 048, vocab
    256 000) and the depth of :func:`hybrid_train_config`: B4 and B2 by
    ``add_sparse_train_launches``, B9 0 (local attention trains on
    ``chunked_attention``, the reference's route)."""
    cfg, reckoned = hybrid_train_config()
    launches, line = train_family(card, "train_hybrid", HYBRID_ARCH,
                                  HYBRID_TRAIN, cfg=cfg)
    if not line["depth_reduced"] or launches["block_attention"]:
        raise AssertionError(f"train_hybrid: {line['n_layers']} layers, "
                             f"B9 {launches['block_attention']}")
    line.update(reckoned=reckoned, window=cfg.window,
                lru_width=cfg.lru_width, d_ff=cfg.d_ff,
                vocab_size=cfg.vocab_size,
                depth_cut_for_the_capture="HYBRID_TRAIN_FREE 12 GiB, not 4: "
                "at 11 layers the captured step ran out of the card")
    return launches, line


def chunked_attention_rows(spec, flush):
    """``layers.chunked_attention`` (no TPU kernel: the reference's
    jnp flash attention) at ``CHUNKED_SHAPES``, f32, forward and forward
    + backward: held against the plain masked softmax over the whole
    score matrix (and its autograd backward), then each timed after the
    L2 flush beside that plain version, one
    ``scaled_dot_product_attention`` call with the same mask (K/V
    repeated over the head groups outside the timing) and the bound:
    the visible (query, key) pairs' products, 2 in the forward (QKᵀ, PV)
    and 7 with the backward (the recomputed QKᵀ, dV, dP, dQ, dK) at 2
    FLOPs a multiply-add, against q, k, v, (dout) read and out, (dq, dk,
    dv) written once.  Recorded, not gated."""
    import torch.nn.functional as F
    from repro_torch.models.layers import chunked_attention
    rows = []
    for name, sh in CHUNKED_SHAPES:
        b, s, h, kvh, hd, window = (sh[k] for k in ("B", "S", "H", "KVH",
                                                     "hd", "window"))
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q = torch.randn((b, s, h, hd), generator=g, device="cuda")
        k, v = (torch.randn((b, s, kvh, hd), generator=g, device="cuda")
                for _ in range(2))
        dout = torch.randn_like(q)
        pos = torch.arange(s, device="cuda")
        mask = pos[:, None] >= pos[None, :]
        if window is not None:
            mask &= (pos[:, None] - pos[None, :]) < window
        kr, vr = (t.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        qt = q.transpose(1, 2).contiguous()

        def plain(q, k, v):
            att = torch.matmul(q.transpose(1, 2) / hd ** 0.5,
                               k.repeat_interleave(h // kvh, 2)
                               .permute(0, 2, 3, 1))
            att = torch.softmax(att.masked_fill(~mask, float("-inf")), -1)
            return torch.matmul(att, v.repeat_interleave(h // kvh, 2)
                                .transpose(1, 2)).transpose(1, 2)

        def library(q, k, v):
            if window is None:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        def fwd_bwd(fn, *ops):
            ops = [t.detach().requires_grad_() for t in ops]
            out = fn(*ops)
            grads = torch.autograd.grad(out, ops, dout if out.shape ==
                                        dout.shape else dout.transpose(1, 2))
            return out, grads

        pairs = int(mask.sum())
        isz = 4
        fwd_bytes = (2 * b * s * h * hd + 2 * b * s * kvh * hd) * isz
        cases = (("forward", 2, fwd_bytes,
                  lambda: chunked_attention(q, k, v, True, window),
                  lambda: plain(q, k, v), lambda: library(qt, kr, vr)),
                 ("forward + backward", 7, 2 * fwd_bytes,
                  lambda: fwd_bwd(lambda *o: chunked_attention(
                      *o, True, window), q, k, v),
                  lambda: fwd_bwd(plain, q, k, v),
                  lambda: fwd_bwd(library, qt, kr, vr)))
        for what, products, nbytes, mine, ref, lib in cases:
            with torch.no_grad() if what == "forward" else \
                    contextlib.nullcontext():
                got, want = mine(), ref()
            if what == "forward":
                err = check_close(got, want, torch.float32, f"{name} {what}")
            else:
                err = max(check_close(a, w, torch.float32,
                                      f"{name} {what} d{n}")
                          for n, a, w in zip("qkv", got[1], want[1]))
                err = max(err, check_close(got[0], want[0], torch.float32,
                                           f"{name} {what} out"))
            del got, want
            flops = products * 2 * b * h * pairs * hd
            t_bytes = nbytes / spec[0] * 1e3
            t_ops = flops / spec[1][torch.float32] * 1e3
            ms = time_ms(mine, 5, flush)
            rows.append({
                "name": "chunked_attention", "not_a_tpu_kernel": True,
                "shape": f"{name}: B {b}, S {s}, H {h} over {kvh} KV, hd "
                f"{hd}, window {window}", "pass": what, "dtype": "float32",
                "max_abs_err": err, "ms": ms,
                "plain_ms": time_ms(ref, 3, flush),
                "library_ms": time_ms(lib, 5, flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_share": max(t_bytes, t_ops) / ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "visible_pairs": pairs})
        del q, k, v, dout, kr, vr, qt, mask
        torch.cuda.empty_cache()
    return rows


def moe_train_rows(spec, flush):
    """B8 forward and dx and ``moe_dw_kernel`` at granite-moe-3b's
    training shapes (a microbatch of 1 × 256 tokens: capacity 56, one
    tile an expert, E 48; gate/up and down), f32 and bf16: each held
    against its plain version, then timed beside its bound, the plain
    version and one ``torch.bmm`` of the same product, with the earlier
    kernel's time (``MOE_TRAIN_WAS_MS``) as ``was_ms``."""
    from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_dw,
                                              moe_gemm_dw_plain, moe_gemm_dx,
                                              moe_gemm_dx_plain,
                                              moe_gemm_plain)
    rows, e, cap = [], MOE_E, MOE_TRAIN_CAP
    t = e * cap
    eot = torch.arange(e, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dtype).element_size()
        for name, d, f in (("gate", 1536, 512), ("down", 512, 1536)):
            rng = np.random.default_rng(SEED + d)
            x, dy = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(dtype) for shape in ((t, d), (t, f)))
            w = torch.from_numpy((rng.standard_normal((e, d, f)) / np.sqrt(d))
                                 .astype(np.float32)).cuda().to(dtype)
            x3, dy3 = x.view(e, cap, d), dy.view(e, cap, f)
            nbytes = (t * d + e * d * f + t * f) * isz + 4 * e
            flops = 2 * t * d * f
            shape = f"train {name} E={e} cap={cap}"
            rows.append(measure(
                "moe_gemm", moe_gemm(x, eot, w, bt=cap),
                moe_gemm_plain(x, eot, w, bt=cap), dtype,
                lambda: moe_gemm(x, eot, w, bt=cap),
                lambda: moe_gemm_plain(x, eot, w, bt=cap),
                lambda: torch.bmm(x3, w), nbytes, flops, spec, flush, REPS,
                shape=f"{shape}: forward ({t} x {d}) -> {f}", bt=cap))
            rows.append(measure(
                "moe_gemm", moe_gemm_dx(dy, eot, w, bt=cap),
                moe_gemm_dx_plain(dy, eot, w, bt=cap), dtype,
                lambda: moe_gemm_dx(dy, eot, w, bt=cap),
                lambda: moe_gemm_dx_plain(dy, eot, w, bt=cap),
                lambda: torch.bmm(dy3, w.transpose(1, 2)), nbytes, flops,
                spec, flush, REPS,
                shape=f"{shape}: dx ({t} x {f}) -> {d}, w transposed",
                bt=cap))
            rows.append(measure(
                "moe_gemm_dw", moe_gemm_dw(x, dy, eot, e, bt=cap),
                moe_gemm_dw_plain(x, dy, eot, e, bt=cap), dtype,
                lambda: moe_gemm_dw(x, dy, eot, e, bt=cap),
                lambda: moe_gemm_dw_plain(x, dy, eot, e, bt=cap),
                lambda: torch.bmm(x3.transpose(1, 2), dy3), nbytes, flops,
                spec, flush, REPS,
                shape=f"{shape}: dW ({t} x {d})^T ({t} x {f}) -> "
                f"({e}, {d}, {f})", bt=cap))
            for row, what in zip(rows[-3:], ("forward", "dx", "dW")):
                row["was_ms"] = MOE_TRAIN_WAS_MS[what, name, row["dtype"]]
            del x, dy, w, x3, dy3
    return rows


# --------------------------------------------------------------------------
# phases 28 to 32: expert parallelism on one card's mesh; checkpoint and
# resume
# --------------------------------------------------------------------------

# the expert-parallel phases' mesh: ("data", "model") = (1, 4), every
# coordinate on the one card (granite: e_loc 12; qwen3-moe: e_loc 32); a
# mesh of several cards is not run
EP_MESH = (1, 4)
EP_NOTE = ("one card's mesh: (data, model) = (1, 4) of 'cuda' entries, every "
           "peer's work on the one card; moe_ep_cards runs a mesh of cards")
QWEN3_MOE_ARCH = "qwen3-moe-235b-a22b"
# qwen3-moe at full width, cut to the deepest stack whose reckoned f32
# serving peak leaves EP_FREE of the card free
EP_FREE = 4 * 2**30
# whisper-base trained through the CLI for the resume check: run A 4 steps,
# run B 2 steps with a checkpoint, then resumed to 4
RESUME_ARCH = ENCDEC_ARCH
RESUME_ARGV = ["--arch", RESUME_ARCH, "--seq-len", "256", "--global-batch",
               "4", "--seed", str(SEED), "--device", "cuda"]
RESUME_DIR = ROOT / "build" / "smoke_ckpt"
# train_moe_ep's microbatch: 8 × 256 tokens in 8 microbatches
EP_TRAIN_SEQ = 256


def ep_mesh(device):
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(EP_MESH, device=device)


def ep_peers(mesh, cfg) -> int:
    """B8 launches a product per MoE call: one a ``model`` peer where
    ``cfg`` takes the expert-parallel path on ``mesh``, else one."""
    if mesh is None or cfg.moe_impl != "ep_a2a":
        return 1
    return mesh.shape["model"]


def moe_ep_reference():
    """granite-moe-3b's smoke config with ``moe_impl="ep_a2a"`` at
    capacity 1.25, the same weights under a card mesh and a CPU mesh of
    the same shape: prefill logits within 1e-4, greedy tokens equal, and
    one microbatch's loss and every gradient (``train_against_cpu``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_dw
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    from repro_torch.serve import SamplingConfig, generate
    from repro_torch.train.optimizer import tree_map
    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH),
                              moe_impl="ep_a2a", moe_capacity_factor=1.25)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (3, 11)))
    sampling = SamplingConfig(max_new_tokens=8)
    with use_mesh(ep_mesh("cpu")):
        tok_cpu, _ = generate(cpu, cfg, {"tokens": prompts}, sampling)
        lg_cpu, _ = lm.prefill(cpu, cfg, {"tokens": prompts})
    moe_gemm.launches = 0
    with use_mesh(ep_mesh("cuda")):
        tok_gpu, _ = generate(gpu, cfg, {"tokens": prompts.cuda()}, sampling)
        lg_gpu, _ = lm.prefill(gpu, cfg, {"tokens": prompts.cuda()})
        (_, _), (p0, h0) = layer0_moe_input(
            lambda: lm.prefill(gpu, cfg, {"tokens": prompts.cuda()}))
        drops = M.ep_dropped_slots(p0, lm._moe_cfg(cfg), h0)
    launches = {"moe_gemm": moe_gemm.launches}
    # generate's prefill and 8 decode steps, then two prefills
    expect = 3 * EP_MESH[1] * cfg.n_layers * (1 + sampling.max_new_tokens + 2)
    if launches["moe_gemm"] != expect:
        raise AssertionError(f"moe_ep_reference: B8 {launches}, expected "
                             f"{expect}")
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    if not torch.allclose(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"EP prefill logits, card against CPU: {err}")
    if not torch.equal(tok_cpu, tok_gpu.cpu()):
        raise AssertionError("EP greedy tokens, card against CPU, differ")
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=SEED), 0, {})
    moe_gemm.launches = moe_gemm_dw.launches = 0
    losses, grad_err, n_grads, param_err, lr = train_against_cpu(
        cfg, batch, lm.unstack_layers(cpu), n_micro=1,
        meshes={"cpu": ep_mesh("cpu"), "cuda": ep_mesh("cuda")})
    line = {"phase": "moe_ep_reference", "config": f"{MOE_ARCH} smoke, "
            "moe_impl ep_a2a, capacity 1.25, f32", "mesh": EP_NOTE,
            "prefill_max_abs_err": err, "greedy_tokens_equal": True,
            "new_tokens": int(tok_gpu.shape[1]),
            "layer0_prefill_dropped_slots": drops,
            "train_microbatches": 1, "loss_cpu": losses["cpu"],
            "loss_cuda": losses["cuda"], "grad_max_abs_err": grad_err,
            "n_grads": n_grads, "param_max_abs_err_after_step": param_err,
            "lr": lr, "train_launches": {"moe_gemm": moe_gemm.launches,
                                         "moe_gemm_dw": moe_gemm_dw.launches},
            "ok": True}
    return launches, line


def ep_drops_over_layers(fn):
    """Run ``fn`` with ``moe.moe_layer_ep`` wrapped: what ``fn`` returns,
    and the slots dropped at each level summed over every EP call."""
    from repro_torch.models import moe as M
    total = {"first_level": 0, "second_level": 0, "calls": 0}
    ep = M.moe_layer_ep

    def record(p, mcfg, x):
        for k, v in M.ep_dropped_slots(p, mcfg, x).items():
            total[k] += v
        total["calls"] += 1
        return ep(p, mcfg, x)
    M.moe_layer_ep = record
    try:
        out = fn()
    finally:
        M.moe_layer_ep = ep
    return out, total


def ep_layer_checks(p0, h0, cfg):
    """Layer 0's MoE on its prefill input: card EP against CPU EP on the
    same input, then, at capacity 8.0 where neither path drops a slot, EP
    against the sort path, each within 1e-5·max + 1e-6; then the forward
    and backward at the training shapes (:func:`ep_train_shape_check`)."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    mcfg = lm._moe_cfg(cfg)
    with use_mesh(ep_mesh("cuda")):
        card = M.moe_layer(p0, mcfg, h0)
    with use_mesh(ep_mesh("cpu")):
        cpu = M.moe_layer({k: v.cpu() for k, v in p0.items()}, mcfg,
                          h0.cpu())
    out = {"card_vs_cpu_max_abs_err": check_close(
        card.cpu(), cpu, torch.float32, "layer-0 EP, card against CPU")}
    wide = dataclasses.replace(mcfg, capacity_factor=8.0)
    with use_mesh(ep_mesh("cuda")):
        ep = M.moe_layer(p0, wide, h0)
        drops = M.ep_dropped_slots(p0, wide, h0)
    sort = M.moe_layer(p0, dataclasses.replace(wide, impl="gspmd"), h0)
    xt = h0.reshape(-1, cfg.d_model)
    kept = M.route(p0["router"], wide, xt, M._capacity(xt.shape[0], wide))
    if any(drops.values()) or not bool(kept["keep"].all()):
        raise AssertionError(f"capacity 8.0 drops slots: EP {drops}")
    out["ep_vs_sort_cf8_max_abs_err"] = check_close(
        ep, sort, torch.float32, "layer-0 EP against the sort path, cf 8")
    out["train_shape"] = ep_train_shape_check(p0, h0, cfg)
    return out


def ep_train_shape_check(p0, h0, cfg):
    """Layer 0's MoE forward and backward at ``train_moe_ep``'s shapes: a
    1 × ``EP_TRAIN_SEQ`` microbatch (granite: e_loc 12, cap_exp 272 rows
    a peer's expert) of the layer's prefill input, under the card mesh
    and under a CPU mesh of the same shape, of the loss ``sum(y·R)``
    (R drawn from the seed): y, dx and every expert and router gradient,
    card against CPU, within 1e-5·max + 1e-6 (B8's forward, dx mode and
    ``moe_dw_kernel`` against their plain versions in place)."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    mcfg = lm._moe_cfg(cfg)
    xt = h0.reshape(-1, cfg.d_model)
    if xt.shape[0] < EP_TRAIN_SEQ:
        raise AssertionError(f"the prefill has {xt.shape[0]} tokens, fewer "
                             f"than a training microbatch's {EP_TRAIN_SEQ}")
    x = xt[:EP_TRAIN_SEQ].reshape(1, EP_TRAIN_SEQ, cfg.d_model)
    r = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        x.shape).astype(np.float32))
    got = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.detach().to(dev).clone().requires_grad_(True)
             for k, v in p0.items()}
        xd = x.detach().to(dev).clone().requires_grad_(True)
        with use_mesh(ep_mesh(dev)):
            y = M.moe_layer(p, mcfg, xd)
            drops = M.ep_dropped_slots(p, mcfg, xd.detach())
        (y * r.to(dev)).sum().backward()
        got[dev] = {"y": y.detach().cpu(), "dx": xd.grad.cpu(),
                    **{"d" + k: t.grad.cpu() for k, t in p.items()}}
        del p, xd, y
    errs = {k: check_close(got["cuda"][k], want, torch.float32,
                           f"EP train shape {k}, card against CPU")
            for k, want in got["cpu"].items()}
    return {"sizes": M.ep_sizes(ep_mesh("cpu"), mcfg, 1, EP_TRAIN_SEQ),
            "dropped_slots": drops, "max_abs_err": errs,
            "tolerance": "1e-5·max + 1e-6", "loss": "sum(y·R)"}


def moe_ep_serve(card, arch=MOE_ARCH, phase="moe_ep_serve"):
    """``generate`` on ``arch`` at full width (``EP_MESH``, its own config:
    EP, capacity 1.25), f32, random weights from seed 0: 4 prompts, 16
    greedy tokens; B8 launches zeroed just before and read just after,
    3 products × 4 peers × layers a forward pass.  granite at full depth,
    with layer 0 held card EP against CPU EP and, at capacity 8.0, EP
    against the sort path; qwen3-moe at the depth of
    :func:`qwen3_moe_config`.  Prints tokens/s, prefill and decode-step
    wall and device ms (profiled), the peak GiB and the slots dropped at
    each level over a prefill's layers."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    from repro_torch.serve import SamplingConfig, generate
    from repro_torch.train.optimizer import named_leaves
    torch.cuda.empty_cache()
    reckoned = None
    if arch == QWEN3_MOE_ARCH:
        cfg, reckoned = qwen3_moe_config()
    else:
        cfg = get_config(arch)
    if cfg.moe_impl != "ep_a2a":
        raise AssertionError(f"{arch} does not ask for expert parallelism")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(t.numel() for _, t in named_leaves(params))
    rng = np.random.default_rng(SEED)
    prompt_len = int(rng.integers(16, 129))
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, prompt_len))).cuda()}
    new = 16
    mesh = ep_mesh("cuda")
    peers = ep_peers(mesh, cfg)
    with use_mesh(mesh):
        moe_gemm.launches = 0
        t0 = time.perf_counter()
        tokens, _ = generate(params, cfg, batch,
                             SamplingConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = {"moe_gemm": moe_gemm.launches}
        expect = {"moe_gemm": 3 * peers * cfg.n_layers * (1 + new)}
        if launches != expect:
            raise AssertionError(f"{phase}: B8 launches {launches}, "
                                 f"expected {expect}")
        if tokens.shape != (4, new) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"{phase}: generate returned "
                                 f"{tuple(tokens.shape)} tokens outside the "
                                 f"vocabulary")
        max_seq = prompt_len + new
        ((logits, state), (p0, h0)), drops = ep_drops_over_layers(
            lambda: layer0_moe_input(lambda: lm.prefill(
                params, cfg, batch, max_seq=max_seq)))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{phase}: non-finite logits")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(params, cfg, batch, max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_tok = tokens[:, :1]
        t0 = time.perf_counter()
        for _ in range(4):
            _, state = lm.decode_step(params, cfg, state, step_tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / 4
        totals = ("moe_kernel",)
        prof_prefill = profile(lambda: lm.prefill(params, cfg, batch,
                                                  max_seq=max_seq),
                               warmup=False, totals=totals)
        prof_decode = profile(lambda: lm.decode_step(params, cfg, state,
                                                     step_tok),
                              totals=totals, cross_check=arch == MOE_ARCH)
        _, gstate = lm.prefill(params, cfg, batch, max_seq=prompt_len + 32)
        graph = replay_check(params, cfg, gstate, step_tok, phase)
        del gstate
    z = M.ep_sizes(mesh, lm._moe_cfg(cfg), 4, prompt_len)
    line = {
        "phase": phase, "config": f"{arch}, its own config (moe_impl "
        f"{cfg.moe_impl}, capacity {cfg.moe_capacity_factor}), f32, random "
        f"weights from seed {SEED}", "mesh": EP_NOTE,
        "n_layers": cfg.n_layers, "n_layers_full": get_config(arch).n_layers,
        "depth_reduced": cfg.n_layers < get_config(arch).n_layers,
        "reckoned": reckoned, "d_model": cfg.d_model,
        "n_experts": cfg.n_experts, "n_experts_padded": cfg.n_experts_padded,
        "top_k": cfg.top_k, "d_expert": cfg.d_expert, "e_loc": z["e_loc"],
        "n_params": n_params, "batch": 4, "prompt_len": prompt_len,
        "new_tokens": new, "prefill_sizes": z,
        "decode_sizes": M.ep_sizes(mesh, lm._moe_cfg(cfg), 4, 1),
        "prefill_dropped_slots": drops, "setup_s": setup_s,
        "generate_s": gen_s, "generate_tok_per_s": 4 * new / gen_s,
        "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
        "decode_step_device_ms": prof_decode["device_ms"],
        "replayed_decode_step_ms": graph["replayed_decode_step_ms"],
        "decode_step_graph": graph,
        "launches": launches, "launches_expected": expect, "card": card,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "init_peak_mem_gib": init_peak_gib,
        "profile_prefill": prof_prefill, "profile_decode_step": prof_decode}
    if arch == MOE_ARCH:
        line["layer0_check"] = ep_layer_checks(p0, h0, cfg)
    del params, state, logits, p0, h0
    torch.cuda.empty_cache()
    return launches, line


def qwen3_moe_config():
    """qwen3-moe-235b-a22b at full width (d_model 4 096, 128 experts,
    top-8, d_expert 1 536) at the deepest stack whose reckoned f32 serving
    peak leaves ``EP_FREE`` of the card's free memory: 4 bytes a parameter
    (the init scales each leaf in place) and 1 GiB of activations, KV and
    EP buffers; (config, reckoning)."""
    from repro_torch.configs import get_config
    full = get_config(QWEN3_MOE_ARCH)
    free, total = torch.cuda.mem_get_info()
    for n_layers in range(full.n_layers, 0, -1):
        cfg = dataclasses.replace(full, n_layers=n_layers)
        n = cfg.param_count()
        peak = 4 * n + 2**30
        if peak + EP_FREE <= free:
            return cfg, {"n_layers": n_layers, "n_layers_full": full.n_layers,
                         "params_reckoned": n,
                         "peak_reckoned_gib": peak / 2**30,
                         "free_before_gib": free / 2**30,
                         "card_gib": total / 2**30}
    raise AssertionError(f"not one layer of {QWEN3_MOE_ARCH} fits in "
                         f"{free / 2**30:.1f} GiB free")


def train_moe_ep(card):
    """``train_family`` on granite-moe-3b at full width and depth, its own
    config (EP, capacity 1.25), 8 × 256 tokens in its 8 microbatches, 3
    steps through ``launch.train.run`` under ``EP_MESH``: B8 forward,
    remat and dx, and ``moe_dw_kernel``, each × 4 peers.  The kernels are
    held against their plain versions at these shapes by
    :func:`ep_train_shape_check` (in ``moe_ep_serve``)."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    launches, line = train_family(
        card, "train_moe_ep", MOE_ARCH,
        dict(steps=3, seq_len=EP_TRAIN_SEQ, global_batch=8, seed=SEED,
             device="cuda"), cfg=cfg, mesh=ep_mesh("cuda"))
    line.update(mesh=EP_NOTE, moe_impl=cfg.moe_impl,
                capacity_factor=cfg.moe_capacity_factor,
                kernels_held_at_these_shapes="moe_ep_serve: layer0_check."
                "train_shape")
    return launches, line


def tree_max_diff(a, b) -> dict:
    """Per leaf of two trees of tensors the largest |a - b| (as f64),
    only where they differ."""
    from repro_torch.train.optimizer import named_leaves
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    if la.keys() != lb.keys():
        raise AssertionError("the trees' leaves differ")
    return {k: float((la[k].double() - lb[k].double()).abs().max())
            for k in la if not torch.equal(la[k], lb[k])}


def train_resume(card):
    """whisper-base at full width and depth through ``launch/train.py``'s
    CLI, f32, seed 0: run A, 4 steps (twice: is the step deterministic on
    the card?); run B, 2 steps with ``--ckpt-dir``, then 4 from the same
    directory, which resumes from 2.  B's parameters and optimizer state
    against A's: bit for bit, or, where A's two runs differ, within that
    difference.  Then ``launch/serve.py --ckpt-dir`` serves B's checkpoint:
    the same greedy tokens as ``generate`` on B's parameters in memory.
    Prints save and load seconds and bytes on disk."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.serve import SamplingConfig, generate
    from repro_torch.train.optimizer import named_leaves
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    runs = [launch_train.main([*RESUME_ARGV, "--steps", "4"])
            for _ in range(2)]
    a_diff = {**tree_max_diff(runs[0].params, runs[1].params),
              **tree_max_diff(runs[0].opt._asdict(), runs[1].opt._asdict())}
    first = launch_train.main([*RESUME_ARGV, "--steps", "2", "--ckpt-dir",
                               str(RESUME_DIR)])
    if ckpt.latest_step(str(RESUME_DIR)) != 2:
        raise AssertionError("run B saved no step-2 checkpoint")
    resumed = launch_train.main([*RESUME_ARGV, "--steps", "4", "--ckpt-dir",
                                 str(RESUME_DIR)])
    if [r["step"] for r in resumed.history] != [2, 3]:
        raise AssertionError(f"run B did not resume from step 2: "
                             f"{[r['step'] for r in resumed.history]}")
    # every run warms up, captures its second step and replays after it;
    # the resumed run on the checkpoint's tensors too
    graphs = {name: (r.step_fn.graph.captures, r.step_fn.graph.replays)
              for name, r in (("run_a", runs[0]), ("run_a_again", runs[1]),
                              ("run_b", first), ("run_b_resumed", resumed))}
    if graphs != {"run_a": (1, 3), "run_a_again": (1, 3), "run_b": (1, 1),
                  "run_b_resumed": (1, 1)}:
        raise AssertionError(f"train_resume: (captures, replays) {graphs}")
    b_diff = {**tree_max_diff(resumed.params, runs[0].params),
              **tree_max_diff(resumed.opt._asdict(), runs[0].opt._asdict())}
    if a_diff:
        over = {k: v for k, v in b_diff.items() if v > a_diff.get(k, 0.0)}
        if over:
            raise AssertionError(f"resumed run B past run A's own spread: "
                                 f"{dict(list(over.items())[:5])}")
    elif b_diff:
        raise AssertionError(f"resumed run B differs from run A: "
                             f"{dict(list(b_diff.items())[:5])}")
    state = {"params": resumed.params, "opt": resumed.opt}
    timing_dir = RESUME_DIR / "timing"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save(str(timing_dir), 4, state)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    t0 = time.perf_counter()
    _, back = ckpt.load(str(timing_dir), state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if tree_max_diff(back["params"], state["params"]):
        raise AssertionError("a checkpoint load changed the parameters")
    del back
    shutil.rmtree(timing_dir)

    new = 16
    argv = ["--arch", RESUME_ARCH, "--batch", "4", "--prompt-len", "112",
            "--max-new", str(new), "--seed", str(SEED), "--device", "cuda"]
    served = launch_serve.main([*argv, "--ckpt-dir", str(RESUME_DIR)])
    cfg = get_config(RESUME_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lm.init_params(cfg, gen, device="cuda")     # the CLI's draws, in order
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 112),
                                     generator=gen, device="cuda"),
             "enc_frames": torch.randn((4, cfg.enc_seq, cfg.d_model),
                                       generator=gen, device="cuda")}
    with torch.no_grad():
        want, _ = generate(lm.stack_layers(resumed.params), cfg, batch,
                           SamplingConfig(max_new_tokens=new), gen)
    if not torch.equal(served, want):
        raise AssertionError("serve --ckpt-dir tokens differ from generate "
                             "on the resumed parameters")
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    line = {"phase": "train_resume", "config": f"{RESUME_ARCH}, f32, "
            f"AdamW, seed {SEED}, 4 x 256 tokens a step", "card": card,
            "argv": RESUME_ARGV, "run_a_steps": 4,
            "run_b": "--steps 2 --ckpt-dir D, then --steps 4 --ckpt-dir D",
            "graph_captures_replays": graphs,
            "run_a_twice_max_diff": a_diff,
            "bit_identical": not b_diff, "run_b_max_diff": b_diff,
            "loss_a": [r["loss"] for r in runs[0].history],
            "loss_b": [r["loss"] for r in first.history + resumed.history],
            "n_params": sum(t.numel() for _, t in
                            named_leaves(resumed.params)),
            "checkpoint_bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "serve_ckpt_tokens_equal": True, "serve_new_tokens": new,
            "ok": True}
    del runs, first, resumed, state
    torch.cuda.empty_cache()
    return line


# --------------------------------------------------------------------------
# phase 33: the GPipe pipeline on one card's pod mesh
# --------------------------------------------------------------------------

# qwen3-4b at full width and depth with the train phase's sparse MLP,
# pipelined over 4 stages of 9 blocks, 4 microbatches of a 4 × 256 batch
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = 4, 4, 4, 256


def error_and_share(got, want):
    """max|got - want| and its share of the 1e-5·max|want| + 1e-6 limit
    (the kernels' f32 rule)."""
    err = float((got.float() - want.float().to(got.device)).abs().max())
    return err, err / (1e-5 * float(want.float().abs().max()) + 1e-6)


def close_within(got, want, what):
    """Within 1e-5·max|want| + 1e-6; returns the error and its share of
    the limit."""
    err, part = error_and_share(got, want)
    if not part <= 1.0:
        raise AssertionError(f"{what}: max|got - want| = {err} is {part} "
                             f"of the limit 1e-5·max|want| + 1e-6")
    return err, part


def pipe_grads(layers, fn, x, r):
    """``fn(x)`` and the gradients of ``sum(fn(x)·r)`` for every leaf of
    ``layers`` (the leaves' ``.grad`` cleared after) and for x."""
    from repro_torch.train.optimizer import named_leaves
    leaves = [t for _, t in named_leaves(layers)]
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    xg = x.detach().clone().requires_grad_(True)
    y = fn(xg)
    (y * r).sum().backward()
    grads = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    return y.detach(), grads, xg.grad


def pipe_expected(plan, blocks):
    """The Maple launches of ``blocks`` block-microbatches of a pipelined
    forward and backward: the MLP forward and its recompute in the forward
    plan's layout, dB in the transpose-side plan's, dA on B2."""
    expect = {"maple_spmm_naive": 0, "maple_spmm_compact": 0,
              "maple_spmm_planned": 0, "maple_sddmm_bsr": blocks}
    expect[PLANNED[plan.fwd.fused]] += 2 * blocks
    expect[PLANNED[plan.bwd.fused]] += blocks
    return expect


def pipe_launches():
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
    return {**spmm_counters(), "maple_sddmm_bsr": maple_sddmm_bsr.launches}


def zero_pipe_launches():
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
    zero_spmm_counters()
    maple_sddmm_bsr.launches = 0


def pipe_stage_fn(cfg, plan):
    from repro_torch.models import lm
    return lambda stage, h: lm.apply_layers(stage, cfg, h, mlp_plan=plan)


def pipeline_smoke_against_cpu(arch="qwen3-4b"):
    """``arch``'s smoke config (8 layers, sparse MLP at (8, 8), f32, its
    biases drawn by :func:`draw_biases`: none in qwen3-4b, QKV in
    qwen2-72b) through ``pipeline_apply`` over (4,) pod meshes of
    ``"cuda"`` and of ``"cpu"`` entries: output, dx and every gradient
    card against CPU within 1e-4·max + 1e-6."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=8,
                              sparse_mlp=True, sparse_block=(8, 8))
    gen = torch.Generator().manual_seed(SEED)
    cpu = lm.unstack_layers(lm.init_params(cfg, gen, device="cpu"))[
        "groups"]["b0"]
    for layer in cpu:
        draw_biases(layer, gen)
    card = [cuda_tree(layer) for layer in cpu]
    g = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((4, 16, cfg.d_model), generator=g)
    r = torch.randn(x.shape, generator=g)
    out = {}
    for dev, layers in (("cpu", cpu), ("cuda", card)):
        mesh = make_debug_mesh((PIPE_STAGES,), ("pod",), device=dev)
        fn = pipe_stage_fn(cfg, lm.sparse_mlp_plan(layers))
        out[dev] = pipe_grads(
            layers, lambda h: pipeline_apply(fn, mesh, PIPE_MICRO, layers,
                                             h), x.to(dev), r.to(dev))
    y_err = grads_close(out["cuda"][0], out["cpu"][0], "smoke output")
    g_err = max(grads_close(a, b, f"smoke grad {i}") for i, (a, b) in
                enumerate(zip(out["cuda"][1], out["cpu"][1])))
    return {"config": f"{arch} smoke, 8 layers, sparse_mlp (8,8), "
            "4 x 16 tokens", "y_max_abs_err": y_err,
            "grad_max_abs_err": g_err,
            "dx_max_abs_err": grads_close(out["cuda"][2], out["cpu"][2],
                                          "smoke dx")}


def pipeline_phase(card, train_device_ms):
    """qwen3-4b at full width and depth (36 layers, f32, the train phase's
    sparse MLP) through ``pipeline_apply`` over one card's ``("pod",)``
    mesh of 4, 4 microbatches of a 4 × 256 batch of embedded tokens, each
    stage's 9 blocks by ``lm.apply_layers`` (remat per block) on the
    shared MLP plan; the gradients of ``sum(y·R)`` for a fixed R.  Held
    against the same blocks run in order on each microbatch: y, dx and
    every gradient within 1e-5·max + 1e-6, and the same against the whole
    batch through the blocks at once.  Launches zeroed just before the
    pipelined forward and backward and read just after: per block and microbatch the MLP
    forward and its recompute in the forward plan's layout, dB in the
    transpose-side plan's, dA on B2."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.train.optimizer import named_leaves
    smoke = pipeline_smoke_against_cpu()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen3-4b"), sparse_mlp=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ),
                           generator=gen, device="cuda")
    x = params["embed_tokens"][tokens]
    layers = lm.unstack_layers({"groups": params["groups"]})["groups"]["b0"]
    del params
    torch.cuda.empty_cache()
    r = torch.randn(x.shape, generator=gen, device="cuda")
    plan = lm.sparse_mlp_plan(layers)
    stage_fn = pipe_stage_fn(cfg, plan)
    mesh = make_debug_mesh((PIPE_STAGES,), ("pod",), device="cuda")
    piped = lambda h: pipeline_apply(stage_fn, mesh, PIPE_MICRO, layers, h)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_pipe_launches()
    t0 = time.perf_counter()
    y_pipe, g_pipe, dx_pipe = pipe_grads(layers, piped, x, r)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = pipe_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    blocks = PIPE_MICRO * cfg.n_layers      # P·M stage calls of L/P blocks
    expect = pipe_expected(plan, blocks)
    if launches != expect:
        raise AssertionError(f"pipeline launches {launches}, expected "
                             f"{expect}")

    # the same blocks in order, microbatch by microbatch (the products
    # at the pipeline's shapes, so on the same kernels)
    sequential = lambda h: torch.cat(
        [stage_fn(layers, mb) for mb in h.chunk(PIPE_MICRO)])
    y_seq, g_seq, dx_seq = pipe_grads(layers, sequential, x, r)
    y_err = close_within(y_pipe, y_seq, "pipelined output")
    dx_err = close_within(dx_pipe, dx_seq, "pipelined dx")
    g_errs = [close_within(a, b, f"pipelined grad {i}")
              for i, (a, b) in enumerate(zip(g_pipe, g_seq))]
    del g_seq, y_seq, dx_seq
    # and the whole batch through the blocks at once, whose products run
    # at 4× the rows on other GEMM tiles: within the same limit
    y_all, g_all, dx_all = pipe_grads(layers,
                                      lambda h: stage_fn(layers, h), x, r)
    whole = [close_within(y_pipe, y_all, "pipelined output, whole batch"),
             close_within(dx_pipe, dx_all, "pipelined dx, whole batch")] + [
        close_within(a, b, f"pipelined grad {i}, whole batch")
        for i, (a, b) in enumerate(zip(g_pipe, g_all))]
    del y_all, g_all, dx_all

    leaves = [t for _, t in named_leaves(layers)]

    def fwd_bwd():
        (piped(x) * r).sum().backward()
        for t in leaves:
            t.grad = None
    prof = profile(fwd_bwd, warmup=False,
                   totals=("run_kernel", "sddmm_kernel"))
    line = {"phase": "pipeline", "config": "qwen3-4b sparse_mlp (64,64) "
            "d=0.25, f32, remat per block", "n_layers": cfg.n_layers,
            "depth_reduced": False, "mesh": {"pod": PIPE_STAGES},
            "devices": "one card at every coordinate",
            "microbatches": PIPE_MICRO, "tokens": [PIPE_BATCH, PIPE_SEQ],
            "stage_calls": PIPE_STAGES * PIPE_MICRO,
            "launches": launches, "launches_expected": expect,
            "plan_fused": [plan.fwd.fused, plan.bwd.fused],
            "y_max_abs_err": y_err[0], "dx_max_abs_err": dx_err[0],
            "grad_max_abs_err": max(e for e, _ in g_errs),
            "worst_share_of_limit": max([y_err[1], dx_err[1]]
                                        + [s for _, s in g_errs]),
            "whole_batch_max_abs_err": max(e for e, _ in whole),
            "whole_batch_worst_share": max(p for _, p in whole),
            "n_grads": len(g_errs), "wall_ms": wall_ms,
            "device_ms": prof["device_ms"],
            "train_step_device_ms": train_device_ms,
            "peak_mem_gib": peak_gib, "smoke_card_vs_cpu": smoke,
            "card": card, "profile": prof}
    del layers, leaves, g_pipe, x, r
    torch.cuda.empty_cache()
    return launches, line


# --------------------------------------------------------------------------
# phase 34: the dry run over the grid, and its walk tied to the card
# --------------------------------------------------------------------------

def dryrun_tie(card):
    """Dense qwen3-4b with bf16 parameters on a (1, 1) mesh at shapes one
    card holds: the walker's counts of each step on ``meta`` against its
    counts of the same step on the card (equal: one op stream), then the
    reckoned memory and roofline step time (``dryrun.cell_report`` on the
    (1, 1) mesh) against the card's peak bytes and device ms, as ratios
    (recorded, not gated)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    import repro_torch.roofline.jaxpr_cost as walk
    cfg = get_config("qwen3-4b")
    rows = []
    for shape in (ShapeSpec("train_card", 256, 4, "train"),
                  ShapeSpec("decode_card", 4096, 4, "decode")):
        train = shape.kind == "train"
        ocfg = dryrun.optimizer_config(cfg) if train else None
        micro = cfg.train_microbatches if train else 1
        t0 = time.perf_counter()
        with use_mesh_rules(make_debug_mesh((1, 1), device="meta")):
            meta = walk.jaxpr_cost(dryrun.step_call(cfg, shape, ocfg,
                                                    micro))
        meta_s = time.perf_counter() - t0
        reckoned = dryrun.cell_report(
            cfg, shape, make_debug_mesh((1, 1), device="meta"),
            hbm=torch.cuda.get_device_properties(0).total_memory)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with use_mesh_rules(make_debug_mesh((1, 1), device="cuda")):
            run = dryrun.step_call(cfg, shape, ocfg, micro, device="cuda",
                                   generator=gen)
            t0 = time.perf_counter()
            on_card = walk.jaxpr_cost(run)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            prof = profile(run, warmup=False)
        counts = {k: [getattr(meta, k), getattr(on_card, k)]
                  for k in ("flops", "bytes", "dot_flops", "ops")}
        if any(a != b for a, b in counts.values()):
            raise AssertionError(f"{shape.name}: the walk on meta and on "
                                 f"the card differ: {counts}")
        total = reckoned["memory"]["total_hbm_bytes"]
        step_s = reckoned["roofline"]["step_time_s"]
        rows.append({
            "shape": dataclasses.asdict(shape), "microbatches": micro,
            "counts_meta_card": counts, "peak_live_meta_card": [
                meta.peak_bytes, on_card.peak_bytes],
            "walk_s_meta": meta_s, "walk_s_card": card_s,
            "reckoned": reckoned["memory"],
            "max_memory_allocated": peak,
            "reckoned_over_peak": total / peak,
            "roofline": reckoned["roofline"],
            "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
            "launches": prof["launches"],
            "device_ms_over_roofline_ms": prof["device_ms"]
            / (step_s * 1e3)})
        del run
        torch.cuda.empty_cache()
    return rows


def dryrun_phase(card):
    """The port's dry run (``repro_torch.launch.dryrun``) over every arch ×
    shape cell on both production meshes, walked on ``meta`` by worker
    processes (host only): each cell's status, per-device GiB, dominant
    term and roofline step time, the host seconds and the counts; any
    ``FAILED`` cell fails the phase.  :func:`dryrun_tie` runs meanwhile
    (its wall ms share the host with the grid's workers).  The workers are
    spawned and re-import the main module, so a script that calls this
    runs nothing at import: an unguarded one has each worker rerun it,
    on the card too."""
    import concurrent.futures
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun

    def grid():
        t0 = time.perf_counter()
        out = dryrun.run_grid(sorted(ARCHS), sorted(SHAPES), [False, True],
                              log=lambda line: None)
        return out, time.perf_counter() - t0
    # the grid's worker processes walk on the host while the tie runs the
    # card from this one
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        walking = ex.submit(grid)
        tie = dryrun_tie(card)
        results, host_s = walking.result()
    failed = [r for r in results if r["status"] == "FAILED"]
    if failed:
        raise AssertionError(f"dry run: {len(failed)} cells FAILED: "
                             + "; ".join(f"{r['arch']}|{r['shape']}|"
                                         f"{r['mesh']}: {r['error']}"
                                         for r in failed))
    cells = []
    for r in results:
        cell = {"cell": f"{r['arch']}|{r['shape']}|{r['mesh']}",
                "status": r["status"]}
        if r["status"] == "ok":
            cell.update(hbm_gib_per_chip=r["hbm_gib_per_chip"],
                        fits_hbm=r["fits_hbm"],
                        dominant=r["roofline"]["dominant"],
                        step_time_s=r["roofline"]["step_time_s"],
                        trace_s=r["trace_s"])
        cells.append(cell)
    return {"phase": "dryrun", "meshes": ["16x16", "2x16x16"],
            "workers": min(len(results), max(1, (os.cpu_count() or 1) - 1)),
            "host_s": host_s,
            "summary": dryrun.summary_line(results),
            "counts": {s: sum(r["status"] == s for r in results)
                       for s in ("ok", "skipped", "FAILED")},
            "cells": cells, "tie": tie, "card": card}


# --------------------------------------------------------------------------
# phase 35: the reference's four examples on the card
# --------------------------------------------------------------------------

EXAMPLE_SIM_ARGV = ["--scale", "0.1", "--matrices", "wg", "sc", "fb",
                    "--spgemm", "--events"]
EXAMPLE_CKPT = ROOT / "build" / "examples" / "train_lm"
EXAMPLE_TRAIN_ARGV = ["--sparse-mlp", "--steps", "50", "--ckpt-dir",
                      str(EXAMPLE_CKPT)]
EXAMPLE_SMALL_ARGV = ["--sparse-mlp", "--seq-len", "32", "--global-batch",
                      "2", "--steps", "3"]
EXAMPLE_PART_ARGV = ["--sparse-mlp", "--partition", "2", "--steps", "3"]


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its printed text kept off the smoke's
    output (an example returns what it prints)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def counted_launches(fn):
    """``fn()`` with every kernel's launch count zeroed just before and
    read just after: (its result, the counts that are not 0)."""
    counters = maple_counters()
    for f in counters.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counters.items() if f.launches}


def exact_launches(got, expect, what):
    """``got`` (``counted_launches``' counts) must be ``expect`` exactly,
    every other kernel launched no time."""
    want = {k: v for k, v in expect.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def relative_close(got, want, rtol, what):
    """Each of ``got`` within ``rtol`` relative of ``want``'s; the largest
    relative gap."""
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    if len(got) != len(want) or not max(gaps) <= rtol:
        raise AssertionError(f"{what}: {got} against {want} (rtol {rtol})")
    return max(gaps)


def example_quickstart():
    """quickstart on the card against the same run on the CPU: layer A's
    text equal, layer B's product within 1e-5·max + 1e-6 of the plain
    version's (one B4 launch, the only launch of the run), layer C's
    losses within 1e-4 relative and its greedy tokens equal, its step
    captured once and replayed after the warm-up."""
    from repro_torch.examples import quickstart
    cpu = quiet(quickstart.main, ["--device", "cpu"])
    card, launches = counted_launches(lambda: quiet(quickstart.main, []))
    exact_launches(launches, {"maple_spmm_planned": 1}, "quickstart")
    if card["layer_a"]["lines"] != cpu["layer_a"]["lines"]:
        raise AssertionError("quickstart layer A's text differs from the "
                             "CPU's")
    got, want = card["layer_b"]["out"].cpu(), cpu["layer_b"]["out"]
    err = float((got - want).abs().max())
    limit = 1e-5 * float(want.abs().max()) + 1e-6
    if not err <= limit or card["layer_b"]["blocks"] != 5:
        raise AssertionError(f"quickstart layer B: max|card - plain| = {err}"
                             f" > {limit}")
    gap = relative_close(card["layer_c"]["losses"], cpu["layer_c"]["losses"],
                         1e-4, "quickstart layer C losses")
    if card["layer_c"]["tokens"] != cpu["layer_c"]["tokens"]:
        raise AssertionError("quickstart layer C's greedy tokens differ from "
                             "the CPU's")
    graph = card["layer_c"]["step_fn"].graph
    if (graph.captures, graph.replays) != (1, 2):
        raise AssertionError(f"quickstart layer C: {graph.captures} "
                             f"captures, {graph.replays} replays")
    graph.release()
    return launches, {
        "lines": card["layer_a"]["lines"] + card["layer_b"]["lines"]
        + card["layer_c"]["lines"],
        "layer_b_max_abs_err_vs_plain": err,
        "layer_b_max_abs_err_vs_dense": card["layer_b"]["err"],
        "layer_c_losses": card["layer_c"]["losses"],
        "layer_c_losses_cpu": cpu["layer_c"]["losses"],
        "layer_c_loss_rel_gap": gap,
        "layer_c_tokens_equal": True, "launches": launches}


def example_accelerator_sim():
    """accelerator_sim at the reference's defaults with ``--spgemm
    --events`` on the card against the CPU: the text equal apart from the
    ``max|dC|=`` field (at most 1e-5 on both), 3 B5 launches (one a
    pattern of the sweep) and no other."""
    import re
    from repro_torch.examples import accelerator_sim
    dc = re.compile(r"max\|dC\|=(\S+)")
    cpu = quiet(accelerator_sim.main, [*EXAMPLE_SIM_ARGV, "--device", "cpu"])
    t0 = time.perf_counter()
    card, launches = counted_launches(
        lambda: quiet(accelerator_sim.main, EXAMPLE_SIM_ARGV))
    card_s = time.perf_counter() - t0
    exact_launches(launches, {"maple_spgemm_numeric": 3}, "accelerator_sim")
    if [dc.sub("", x) for x in card["lines"]] != \
            [dc.sub("", x) for x in cpu["lines"]]:
        raise AssertionError("accelerator_sim's text differs from the CPU's")
    errors = [float(m) for run in (card, cpu) for x in run["lines"]
              for m in dc.findall(x)]
    if len(errors) != 6 or not max(errors) <= 1e-5:
        raise AssertionError(f"accelerator_sim max|dC| {errors}")
    return launches, {
        "argv": EXAMPLE_SIM_ARGV, "lines_equal": True,
        "n_lines": len(card["lines"]),
        "sweep_lines": card["lines"][:4], "max_dC": errors[:3],
        "max_dC_cpu": errors[3:], "card_s": card_s, "launches": launches}


@contextlib.contextmanager
def round_syncs(rounds):
    """While open, every ``ContinuousBatcher.step`` whose fused step was
    already captured runs under ``host_syncs``: for each such round,
    (host syncs, fused steps, admissions) go to ``rounds``."""
    from repro_torch.serve import ContinuousBatcher
    step = ContinuousBatcher.step

    def counted(self, now=0.0):
        if not self.graph.captured:
            return step(self, now)
        before = (self.steps, self.admitted)
        out = []
        syncs = host_syncs(lambda: out.append(step(self, now)))
        rounds.append((syncs, self.steps - before[0],
                       self.admitted - before[1]))
        return out[0]

    ContinuousBatcher.step = counted
    try:
        yield
    finally:
        ContinuousBatcher.step = step


def example_serve_lm():
    """serve_lm on the card against the CPU: the T=0 tokens equal; every
    completion's rid, status, ``finished_by`` and tokens, the fused
    steps, ``memory_stats()`` and ``fault_stats()`` of both engines
    equal; B9 once a local-attention layer a prefill (the static prefill,
    the two ``generate`` prefills, every admission) and nothing else; one
    host sync a round of one fused step and no admission once the fused
    step is captured."""
    from repro_torch.examples import serve_lm
    cpu = quiet(serve_lm.main, ["--device", "cpu"])
    rounds = []
    with round_syncs(rounds):
        card, launches = counted_launches(lambda: quiet(serve_lm.main, []))
    cfg = card["cfg"]
    _, n_local = model_kernels(cfg)
    engines = ("engine", "failure")
    if any(card[e].fallbacks for e in engines):
        raise AssertionError("serve_lm fell back to the static path")
    prefills = 3 + sum(card[e].admitted for e in engines)
    exact_launches(launches, {"block_attention": n_local * prefills},
                   "serve_lm")
    sig = lambda eng: [(c.rid, c.status, c.finished_by, list(c.tokens))
                       for c in eng.completions]
    for e in engines:
        a, b = card[e], cpu[e]
        if (sig(a), a.steps, a.memory_stats(), a.fault_stats()) != \
                (sig(b), b.steps, b.memory_stats(), b.fault_stats()):
            raise AssertionError(f"serve_lm {e}: the card's engine differs "
                                 f"from the CPU's")
    if not torch.equal(card["static"]["tokens"][0.0],
                       cpu["static"]["tokens"][0.0]):
        raise AssertionError("serve_lm T=0 tokens differ from the CPU's")
    err = float((card["static"]["logits"].cpu()
                 - cpu["static"]["logits"]).abs().max())
    plain = [len(s) for s, n, a in rounds if n == 1 and a == 0]
    if not plain or set(plain) != {1}:
        raise AssertionError(f"serve_lm: host syncs a fused step {plain}")
    for e in engines:
        card[e].graph.release()
    release_graphs()
    return launches, {
        "arch": serve_lm.ARCH, "lines": card["lines"],
        "prefill_max_abs_err_vs_cpu": err, "t0_tokens_equal": True,
        "engines_equal": True, "prefills": prefills,
        "fused_steps": [card[e].steps for e in engines],
        "fault_stats": card["failure"].fault_stats(),
        "host_syncs_per_fused_step": 1,
        "rounds_checked": len(plain), "launches": launches}


def example_train_lm(card):
    """train_lm on the card: run 1, ``--sparse-mlp --steps 50 --ckpt-dir``
    at the example's widths and depth (B4 and B2 launches by the plan, the
    step-50 checkpoint loading back bit-equal, the captured step's numbers
    and one replayed step profiled); run 2, 3 steps at 2 × 32 tokens card
    against CPU (losses 1e-4 relative); run 3, ``--partition 2``, the
    stacked loop on one card (B1 and B2 launches per shard, losses 1e-5
    relative of run 1's, the replays bit-equal to the same run eager)."""
    import shutil
    from repro_torch.data import synth_batch
    from repro_torch.examples import train_lm
    from repro_torch.ft import checkpoint as ckpt

    def expected(run):
        expect = dict.fromkeys(maple_counters(), 0)
        add_sparse_train_launches(expect, run.cfg, run.mlp_plan,
                                  len(run.history), micro=2)
        return expect

    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run, launches = counted_launches(
        lambda: quiet(train_lm.main, EXAMPLE_TRAIN_ARGV))
    run_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    exact_launches(launches, expected(run), "train_lm")
    losses = [r["loss"] for r in run.history]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_lm losses {losses}")
    step, back = ckpt.load(str(EXAMPLE_CKPT), {"params": run.params,
                                               "opt": run.opt})
    bad = {**tree_max_diff(back["params"], run.params),
           **tree_max_diff(back["opt"]._asdict(), run.opt._asdict())}
    if step != 50 or bad or not torch.equal(back["opt"].step, run.opt.step):
        raise AssertionError(f"train_lm checkpoint at step {step}: "
                             f"{dict(list(bad.items())[:5])} differ")
    del back
    tokens = 256 * 8
    batch = {k: v.cuda() for k, v in synth_batch(run.data, 50).items()}
    graph = train_graph(run, batch)
    prof = profile(lambda: run.step_fn(run.params, run.opt, batch),
                   warmup=False, totals=("run_kernel", "sddmm_kernel"))
    replayed = statistics.median(graph["step_ms_replayed"])
    run.step_fn.graph.release()
    first = {"argv": EXAMPLE_TRAIN_ARGV, "config": run.cfg.name,
             "params": run.cfg.param_count(), "n_layers": run.cfg.n_layers,
             "depth_reduced": False, "tokens_per_step": tokens,
             "plan": run.lines[1], "plan_fused": [run.mlp_plan.fwd.fused,
                                                  run.mlp_plan.bwd.fused],
             "loss_step0": losses[0], "loss_step49": losses[-1],
             "step_ms_warm_up": graph["step_ms_warm_up"],
             "step_ms_capture": graph["step_ms_capture"],
             "step_ms_replayed_median": replayed,
             "tok_per_s_replayed": tokens / (replayed / 1e3),
             "peak_mem_gib": peak_gib, "run_s": run_s,
             "checkpoint": {"step": step, "bit_equal": True},
             "graph": {k: v for k, v in graph.items()
                       if k != "step_ms_replayed"},
             "profile_replayed_step": prof, "launches": launches}
    del run, batch

    # run 2: card against CPU on the same weights
    small_cpu = quiet(train_lm.main, [*EXAMPLE_SMALL_ARGV, "--device", "cpu"])
    small = quiet(train_lm.main, EXAMPLE_SMALL_ARGV)
    small.step_fn.graph.release()
    gap = relative_close([r["loss"] for r in small.history],
                         [r["loss"] for r in small_cpu.history], 1e-4,
                         "train_lm card against CPU")
    second = {"argv": EXAMPLE_SMALL_ARGV,
              "loss": [r["loss"] for r in small.history],
              "loss_cpu": [r["loss"] for r in small_cpu.history],
              "loss_rel_gap": gap}
    del small, small_cpu

    # run 3: two shards, one after another on the card, against run 1's
    # first steps and against the same steps eager
    part, part_launches = counted_launches(
        lambda: quiet(train_lm.main, EXAMPLE_PART_ARGV))
    exact_launches(part_launches, expected(part), "train_lm --partition 2")
    graph = part.step_fn.graph
    if part.n_shards != 2 or (graph.captures, graph.replays) != (1, 2):
        raise AssertionError(f"train_lm --partition 2: {part.n_shards} "
                             f"shards, {graph.captures} captures, "
                             f"{graph.replays} replays")
    graph.release()
    part_gap = relative_close([r["loss"] for r in part.history],
                              losses[:3], 1e-5,
                              "train_lm --partition 2 against --partition 1")
    # the same run with the step left eager
    compiled = train_lm.jitted_train_step
    train_lm.jitted_train_step = lambda step, device: step
    try:
        eager = quiet(train_lm.main, EXAMPLE_PART_ARGV)
    finally:
        train_lm.jitted_train_step = compiled
    metrics = lambda r: [(h["loss"], h["grad_norm"]) for h in r.history]
    differ = {**tree_max_diff(part.params, eager.params),
              **tree_max_diff(part.opt._asdict(), eager.opt._asdict())}
    if metrics(part) != metrics(eager) or differ:
        raise AssertionError(f"train_lm --partition 2: replays differ from "
                             f"the eager steps: {metrics(part)} against "
                             f"{metrics(eager)}, "
                             f"{dict(list(differ.items())[:5])}")
    third = {"argv": EXAMPLE_PART_ARGV, "n_shards": part.n_shards,
             "shard_runs": [[int(s.runs.shape[0]) for s in p.shards]
                            for p in (part.mlp_plan.fwd, part.mlp_plan.bwd)],
             "device_count": torch.cuda.device_count(),
             "loss": [r["loss"] for r in part.history],
             "loss_rel_gap_vs_partition_1": part_gap,
             "replays_bit_equal_to_eager": True,
             "step_ms": [r["step_s"] * 1e3 for r in part.history],
             "launches": part_launches}
    del part, eager
    torch.cuda.empty_cache()
    return ({"examples_train_lm": launches,
             "examples_train_lm_partitioned": part_launches},
            {"run": first, "card_against_cpu": second, "partition_2": third,
             "card": card})


def examples_phase(card):
    """The reference's four examples (``repro_torch.examples``), each
    driven by its ``main`` on the card and held against the same example
    run on the CPU in this process from the same weights (module
    docstring, phase 35)."""
    t0 = time.perf_counter()
    launches, line = {}, {"phase": "examples", "card": card}
    for name, fn in (("quickstart", example_quickstart),
                     ("accelerator_sim", example_accelerator_sim),
                     ("serve_lm", example_serve_lm)):
        t1 = time.perf_counter()
        launches[f"examples_{name}"], line[name] = fn()
        line[name]["s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    train_launches, line["train_lm"] = example_train_lm(card)
    line["train_lm"]["s"] = time.perf_counter() - t1
    launches.update(train_launches)
    line["phase_s"] = time.perf_counter() - t0
    return launches, line


# --------------------------------------------------------------------------
# expert-parallel serving across cards (phase 36)
# --------------------------------------------------------------------------

EP_CARDS = 4             # the model peers of moe_ep_cards' mesh
EP_CARDS_NEW = 16        # generate's new tokens in moe_ep_cards
# the partitioned head across cards: (D, C) at N = 1 and 4
PARTITION_CARDS = ((4, 1), (2, 2))


def cards_mesh():
    """``moe_ep_cards``' ``(data=1, model=4)`` mesh over the cards this
    process sees: ``cuda:0`` to ``cuda:3`` where there are four, else four
    ``cuda:0`` entries (each peer's slices and products on the one card,
    through the same per-peer code)."""
    from repro_torch.distributed.sharding import Mesh
    several = torch.cuda.device_count() >= EP_CARDS
    names = [f"cuda:{i}" if several else "cuda:0" for i in range(EP_CARDS)]
    return Mesh([names], ("data", "model"))


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def card_bytes() -> list:
    """``memory_allocated`` of every card, after a collection and the
    allocator's cache given back."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return [torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())]


@contextlib.contextmanager
def launches_by_card(source, *fn_names):
    """Count the launches of ``csrc`` launchers (``fn_names`` of the
    library built from ``source``, summed) by the card current at each
    launch, which ``kernels._build.launch`` makes the operands' card
    (also on autograd's worker thread of each card: the count is
    locked)."""
    import collections
    import threading
    from repro_torch.kernels import _build
    lib = _build.library(source)
    launchers = {name: getattr(lib, name) for name in fn_names}
    counts = collections.Counter()
    lock = threading.Lock()

    def counter(launcher):
        def counted(*args):
            with lock:
                counts[torch.cuda.current_device()] += 1
            return launcher(*args)
        return counted
    for name, launcher in launchers.items():
        setattr(lib, name, counter(launcher))
    try:
        yield counts
    finally:
        for name, launcher in launchers.items():
            setattr(lib, name, launcher)


def by_card(counts, batch) -> dict:
    """B8 launches by card of a ``generate`` under the bound mesh: the
    launcher's counts where decode steps run eagerly; where they replay a
    graph (one card's mesh) the launcher runs only at the warm-up and the
    capture, so the card's count is ``moe_gemm.launches``, which adds the
    graph's launches on every replay."""
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.serve.engine import captured
    if not captured(batch["tokens"].device):
        return dict(counts)
    if set(counts) != {0}:
        raise AssertionError(f"one card's mesh launched B8 on {dict(counts)}")
    return {0: moe_gemm.launches}


def recorded_generate(params, cfg, batch, new):
    """``generate``'s greedy tokens (host), the logits of every step it
    samples from (the prefill's, then each decode step's but the last;
    host copies) and its wall seconds, every card synchronised."""
    from repro_torch.serve import SamplingConfig, engine
    seen = []
    sample = engine.sample_token

    def record(logits, *args, **kw):
        seen.append(logits.cpu())
        return sample(logits, *args, **kw)
    engine.sample_token = record
    try:
        sync_all()
        t0 = time.perf_counter()
        tokens, _ = engine.generate(params, cfg, batch,
                                    SamplingConfig(max_new_tokens=new))
        sync_all()
        wall = time.perf_counter() - t0
    finally:
        engine.sample_token = sample
    return tokens.cpu(), seen, wall


def device_ms_by_card(fn, warmup: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler (after one outside it with
    ``warmup``): its wall ms (every card synchronised) and, by card, the
    device ms of its kernels (B8's and ``moe_dw_kernel``'s apart) and of
    its copies and sets (the copies between cards apart)."""
    from torch.profiler import ProfilerActivity
    if warmup:
        fn()
    sync_all()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"wall_ms": wall_ms,
            "by_card": events_by_card(prof.profiler.kineto_results.events())}


def events_by_card(events) -> dict:
    """A profile's device events summed by card: kernel ms and launches
    (B8's and ``moe_dw_kernel``'s apart), copies and sets (the copies
    between cards apart)."""
    import collections
    by = collections.defaultdict(lambda: {"kernel_ms": 0.0, "launches": 0,
                                          "b8_ms": 0.0, "b8_launches": 0,
                                          "dw_ms": 0.0, "dw_launches": 0,
                                          "copy_ms": 0.0, "copies": 0,
                                          "peer_copy_ms": 0.0,
                                          "peer_copies": 0})
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        row, ms, name = by[e.device_index()], e.duration_ns() / 1e6, e.name()
        if name.startswith(("Memcpy", "Memset")):
            row["copy_ms"] += ms
            row["copies"] += 1
            if "PtoP" in name:
                row["peer_copy_ms"] += ms
                row["peer_copies"] += 1
            continue
        row["kernel_ms"] += ms
        row["launches"] += 1
        for kernel, key in (("moe_kernel", "b8"), ("moe_dw_kernel", "dw")):
            if kernel in name:
                row[f"{key}_ms"] += ms
                row[f"{key}_launches"] += 1
    return {f"cuda:{i}": by[i] for i in sorted(by)}


def placed_bytes(tree) -> dict:
    """The bytes each card holds of a placed parameter tree (each
    tensor's size rounded up to the allocator's 512-byte blocks)."""
    from repro_torch.distributed.sharding import PeerSlices, leaves_with_path
    held = {}
    for _, leaf in leaves_with_path(tree):
        parts = leaf.parts if isinstance(leaf, PeerSlices) else (leaf,)
        for t in parts:
            if torch.is_tensor(t):
                n = -(-t.numel() * t.element_size() // 512) * 512
                held[t.device.index] = held.get(t.device.index, 0) + n
    return held


def held_against_reckoning(before, tree, what):
    """Each card's ``memory_allocated`` since ``before`` against the
    bytes of ``tree`` placed there; within 256 MiB (the decode callables'
    graphs released; the libraries' workspaces are the rest)."""
    now, want = card_bytes(), placed_bytes(tree)
    out = {}
    for i in range(len(now)):
        got, reck = now[i] - before[i], want.get(i, 0)
        out[f"cuda:{i}"] = {"allocated_gib": got / 2**30,
                            "reckoned_gib": reck / 2**30}
        if abs(got - reck) > 256 * 2**20:
            raise AssertionError(f"{what}: cuda:{i} holds {got} bytes of "
                                 f"the placed tree, reckoned {reck}")
    return out


def walls_ms(fn, calls: int = 3) -> list:
    """The host wall ms of ``calls`` calls of ``fn``, each ended by a
    synchronisation of every card."""
    out = []
    for _ in range(calls):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def ep_timings(params, cfg, batch, max_seq):
    """Prefill and one eager decode step under the bound mesh: the walls
    of 3 calls each (:func:`walls_ms`), then one profiled by card
    (:func:`device_ms_by_card`; its wall carries the profiler's cost)."""
    from repro_torch.models import lm
    _, state = lm.prefill(params, cfg, batch, max_seq=max_seq)
    tok = batch["tokens"][:, :1]
    calls = {"prefill": lambda: lm.prefill(params, cfg, batch,
                                           max_seq=max_seq),
             "decode_step": lambda: lm.decode_step(params, cfg, state, tok)}
    return {name: {"wall_ms": walls_ms(fn), "profile": device_ms_by_card(fn)}
            for name, fn in calls.items()}


def ep_cards_compare(cfg, mesh, label):
    """``cfg`` at full width, f32, random weights from the seed, drawn
    whole on ``cuda:0``: ``generate`` (4 prompts, ``EP_CARDS_NEW`` greedy
    tokens) under one card's ``(1, 4)`` mesh on the whole tree, then
    under ``mesh`` on the tree placed by ``device_put_params`` (the whole
    tree dropped first): the prefill's and every decode step's logits and
    the tokens bit for bit; B8 launches by card, 3 a peer a layer a
    forward pass, each peer's on its card; each card's
    ``memory_allocated`` against the placed tree's bytes there; prefill
    and eager decode-step wall and device ms by card and tokens/s on both
    meshes.  Where the slices placed on ``cuda:0`` would not fit beside
    the whole tree, its expert leaves wait on the other cards, from where
    they are cut."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (EXPERT_LEAVES,
                                                  device_put_params,
                                                  mesh_devices, same_device,
                                                  use_mesh)
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import lm
    from repro_torch.serve import engine
    from repro_torch.train.optimizer import named_leaves
    release_graphs()
    torch.cuda.empty_cache()
    before = card_bytes()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda:0")
                            .manual_seed(SEED), device="cuda:0")
    sync_all()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompt_len = int(rng.integers(16, 129))
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, prompt_len))).to("cuda:0")}
    new, max_seq = EP_CARDS_NEW, prompt_len + EP_CARDS_NEW
    forwards = cfg.n_layers * (1 + new)
    runs = {}
    with use_mesh(ep_mesh("cuda")):
        moe_gemm.launches = 0
        with launches_by_card("moe_gemm", "maple_moe_gemm") as counts:
            tok, logits, wall = recorded_generate(params, cfg, batch, new)
        runs["one_card"] = {"launches": moe_gemm.launches,
                            "by_card": by_card(counts, batch),
                            "generate_s": wall,
                            "tok_per_s": 4 * new / wall,
                            "decode": ("captured" if engine.captured(
                                batch["tokens"].device) else "eager"),
                            **ep_timings(params, cfg, batch, max_seq)}
        release_graphs()
    experts = sum(t.numel() * t.element_size()
                  for k, t in named_leaves(params)
                  if any(n in k for n in EXPERT_LEAVES))
    # the slices placed beside the whole tree on cuda:0
    on_home = sum(same_device(mesh.device_at(model=pe),
                              torch.device("cuda", 0))
                  for pe in range(EP_CARDS))
    parked = {}
    t0 = time.perf_counter()
    if torch.cuda.mem_get_info(0)[0] < experts * on_home // EP_CARDS \
            + EP_FREE:
        # too little room on cuda:0: each whole expert leaf waits on
        # another card, from where device_put_params cuts it
        others = [d for d in mesh_devices(mesh) if d.index != 0]
        if not others:
            raise AssertionError(f"{label}: the slices do not fit beside "
                                 f"the whole tree on one card")
        for j, name in enumerate(EXPERT_LEAVES):
            dev = others[j % len(others)]
            moe = params["groups"]["b0"]["moe"]
            moe[name] = moe[name].to(dev)
            parked[name] = str(dev)
        del moe
        torch.cuda.empty_cache()
    placed = device_put_params(params, mesh)
    params = None
    sync_all()
    place_s = time.perf_counter() - t0
    memory = held_against_reckoning(before, placed, label)
    several = len(mesh_devices(mesh)) > 1
    peers = {mesh.device_at(model=pe).index for pe in range(EP_CARDS)}
    with use_mesh(mesh):
        moe_gemm.launches = 0
        with launches_by_card("moe_gemm", "maple_moe_gemm") as counts:
            tok4, logits4, wall4 = recorded_generate(placed, cfg, batch, new)
        runs["cards"] = {"launches": moe_gemm.launches,
                         "by_card": by_card(counts, batch),
                         "generate_s": wall4,
                         "tok_per_s": 4 * new / wall4,
                         "decode": ("captured" if engine.captured(
                             batch["tokens"].device) else "eager"),
                         **ep_timings(placed, cfg, batch, max_seq)}
        release_graphs()
    # the main path's run is generate's: the timings after it launch more
    launches = {"moe_gemm": runs["cards"]["launches"]}
    want = {i: 3 * forwards * EP_CARDS // len(peers) for i in peers}
    for run in runs.values():
        if run["launches"] != 3 * EP_CARDS * forwards:
            raise AssertionError(f"{label}: B8 {run['launches']}, expected "
                                 f"{3 * EP_CARDS * forwards}")
    if runs["cards"]["by_card"] != want:
        raise AssertionError(f"{label}: B8 by card "
                             f"{runs['cards']['by_card']}, expected {want}")
    if not torch.equal(tok, tok4) or len(logits) != len(logits4) or not all(
            torch.equal(a, b) for a, b in zip(logits, logits4)):
        raise AssertionError(f"{label}: the placed tree on {mesh.devices} "
                             f"differs from the one-card mesh's whole tree")
    if not all(bool(torch.isfinite(lg).all()) for lg in logits4):
        raise AssertionError(f"{label}: non-finite logits")
    if several and any(v["allocated_gib"] * 2**30 >= experts
                       for v in memory.values()):
        raise AssertionError(f"{label}: a card holds the whole expert "
                             f"stack: {memory}")
    line = {"config": f"{cfg.name}, {cfg.n_layers} of "
            f"{get_config(cfg.name).n_layers} layers, full width, f32, "
            f"moe_impl {cfg.moe_impl}, capacity {cfg.moe_capacity_factor}, "
            f"seed {SEED}", "mesh": [str(d) for d in mesh.devices.flat],
            "batch": 4, "prompt_len": prompt_len, "new_tokens": new,
            "init_s": init_s, "experts_parked_on": parked,
            "place_s": place_s, "expert_gib": experts / 2**30,
            "memory_by_card": memory, "bit_equal": True,
            "steps_compared": len(logits), "runs": runs,
            "launches_expected_by_card": want}
    del placed
    torch.cuda.empty_cache()
    return launches, line


def deep_moe_reckoning(full, frees):
    """The deepest stack of ``full`` (qwen3-moe) that four cards hold
    placed, f32, drawn a layer at a time on the last peer's card: card 0
    holds the embedding, head and final norm, every layer's attention,
    norms and router and peer 0's experts; each other card its peer's
    experts; the last card also one layer drawn whole and its slice; one
    placed layer beside the stack; 1 GiB of activations and ``EP_FREE``
    kept free on each.  (config, reckoning)."""
    from repro_torch.distributed.sharding import (EXPERT_LEAVES,
                                                  leaves_with_path, path_str)
    from repro_torch.models import lm
    one = lm.init_params(dataclasses.replace(full, n_layers=1), None,
                         device="meta")
    top = other = expert = 0
    for path, t in leaves_with_path(one):
        name = path_str(path, "str")
        if not name.startswith("['groups']"):
            top += t.numel()
        elif any(k in name for k in EXPERT_LEAVES):
            expert += t.numel()
        else:
            other += t.numel()
    share = expert // EP_CARDS
    act = 2**30 + EP_FREE

    def peaks(n):
        return [4 * (top + (n + 1) * (other + share)) + act,
                *[4 * (n + 1) * share + act] * (EP_CARDS - 2),
                4 * ((n + 1) * share + expert + other) + act]
    for n in range(full.n_layers, 0, -1):
        if all(p <= f for p, f in zip(peaks(n), frees)):
            return dataclasses.replace(full, n_layers=n), {
                "n_layers": n, "n_layers_full": full.n_layers,
                "params_top": top, "params_layer_other": other,
                "params_layer_experts": expert,
                "peak_reckoned_gib": [p / 2**30 for p in peaks(n)],
                "free_before_gib": [f / 2**30 for f in frees]}
    raise AssertionError(f"not one placed layer of {full.name} fits")


def deep_placed_params(cfg, mesh):
    """``cfg``'s parameters drawn a layer at a time on the last peer's
    card (the seed's generator there) and placed by ``device_put_params``
    into stacks allocated once: no card ever holds a layer's experts whole
    but the one that draws them, and card 0 never does."""
    from repro_torch.distributed.sharding import (PeerSlices,
                                                  device_put_params)
    from repro_torch.models import lm
    (key, kinds, _), = lm._stacks(cfg)
    draw = mesh.device_at(model=EP_CARDS - 1)
    gen = torch.Generator(device=draw).manual_seed(SEED)
    params = device_put_params(lm.init_params(
        dataclasses.replace(cfg, n_layers=1), gen, device=draw), mesh)
    n = cfg.n_layers

    def grow(leaf):
        if isinstance(leaf, dict):
            return {k: grow(v) for k, v in leaf.items()}
        if isinstance(leaf, PeerSlices):
            return PeerSlices(tuple(grow(t) for t in leaf.parts),
                              leaf.axis, (n, *leaf.shape[1:]))
        out = torch.empty((n, *leaf.shape[1:]), dtype=leaf.dtype,
                          device=leaf.device)
        out[0].copy_(leaf[0])
        return out

    def fill(stack, layer, i):
        if isinstance(stack, dict):
            for k in stack:
                fill(stack[k], layer[k], i)
        elif isinstance(stack, PeerSlices):
            for big, t in zip(stack.parts, layer.parts):
                big[i].copy_(t[0])
        else:
            stack[i].copy_(layer[0])
    stack = grow(params[key]["b0"])
    params[key]["b0"] = stack
    for i in range(1, n):
        layer = device_put_params(lm._init_block(
            gen, cfg, kinds[0], stack=(1,), dtype=torch.float32), mesh)
        fill(stack, layer, i)
        del layer
    return params


def ep_cards_deep(mesh):
    """qwen3-moe-235b at full width and the deepest stack the four cards
    hold (:func:`deep_moe_reckoning`), drawn and placed layer by layer
    (:func:`deep_placed_params`): ``generate`` twice (greedy tokens
    equal, logits finite), B8 by card, layer 0's MoE on its prefill input
    against the CPU mesh's on the whole layer within 1e-5·max + 1e-6,
    each card's bytes against the reckoning, timings by card."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import PeerSlices, use_mesh
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    release_graphs()
    torch.cuda.empty_cache()
    frees = [torch.cuda.mem_get_info(i)[0] for i in range(EP_CARDS)]
    cfg, reckoned = deep_moe_reckoning(get_config(QWEN3_MOE_ARCH), frees)
    before = card_bytes()
    for i in range(EP_CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    params = deep_placed_params(cfg, mesh)
    sync_all()
    init_s = time.perf_counter() - t0
    memory = held_against_reckoning(before, params, "deep qwen3-moe")
    rng = np.random.default_rng(SEED)
    prompt_len = int(rng.integers(16, 129))
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, prompt_len))).to("cuda:0")}
    new = EP_CARDS_NEW
    with use_mesh(mesh):
        moe_gemm.launches = 0
        with launches_by_card("moe_gemm", "maple_moe_gemm") as counts:
            tok, logits, wall = recorded_generate(params, cfg, batch, new)
        launches = {"moe_gemm": moe_gemm.launches}
        tok2, _, wall2 = recorded_generate(params, cfg, batch, new)
        (_, (p0, h0)) = layer0_moe_input(lambda: lm.prefill(
            params, cfg, batch, max_seq=prompt_len + new))
        mcfg = lm._moe_cfg(cfg)
        card = M.moe_layer(p0, mcfg, h0).cpu()
        timings = ep_timings(params, cfg, batch, prompt_len + new)
    whole = {k: v.whole("cpu") if isinstance(v, PeerSlices) else v.cpu()
             for k, v in p0.items()}
    with use_mesh(ep_mesh("cpu")):
        cpu = M.moe_layer(whole, mcfg, h0.cpu())
    err = check_close(card, cpu, torch.float32,
                      "deep qwen3-moe layer-0 EP, four cards against CPU")
    expect = 3 * cfg.n_layers * (1 + new)
    if dict(counts) != {i: expect for i in range(EP_CARDS)}:
        raise AssertionError(f"deep qwen3-moe: B8 by card {dict(counts)}, "
                             f"expected {expect} on each")
    if not torch.equal(tok, tok2):
        raise AssertionError("deep qwen3-moe: two generate calls' greedy "
                             "tokens differ")
    if not all(bool(torch.isfinite(lg).all()) for lg in logits):
        raise AssertionError("deep qwen3-moe: non-finite logits")
    line = {"config": f"{cfg.name} at full width, {cfg.n_layers} of "
            f"{reckoned['n_layers_full']} layers, f32, seed {SEED}",
            "reckoned": reckoned, "init_s": init_s,
            "memory_by_card": memory,
            "peak_gib_by_card": [torch.cuda.max_memory_allocated(i) / 2**30
                                 for i in range(EP_CARDS)],
            "batch": 4, "prompt_len": prompt_len, "new_tokens": new,
            "launches_by_card": dict(counts), "generate_s": [wall, wall2],
            "tok_per_s": 4 * new / wall2, "tokens_repeat": True,
            "layer0_card_vs_cpu_max_abs_err": err,
            "layer0_tolerance": "1e-5·max + 1e-6", **timings}
    del params, p0, h0
    torch.cuda.empty_cache()
    return launches, line


def partitioned_cards():
    """The partitioned logit head (phase 7a's weight, f32) at each (D, C)
    of :data:`PARTITION_CARDS` on ``partition_mesh``'s private mesh of
    D·C cards, N = 1 and 4: bit for bit against the stacked loop on one
    card (``local_partition_execution``), B1 launches by card (each
    shard's on its mesh card)."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels.maple_spmm import maple_spmm_compact
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import SparseLogitHead
    gen = torch.Generator(device="cuda:0").manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    hw = init_sparse_linear(gen, HEAD["d_in"], HEAD["d_out"],
                            block_shape=HEAD["block"],
                            block_density=HEAD["density"])
    cases = []
    for d_, c_ in PARTITION_CARDS:
        head = SparseLogitHead.build(hw, n_lanes=HEAD["n_lanes"],
                                     n_shards=d_, n_col_shards=c_)
        mesh, _ = sharding.partition_mesh(d_, c_)
        if mesh is None or len(sharding.mesh_devices(mesh)) != d_ * c_:
            raise AssertionError(f"partition_mesh({d_}, {c_}) gave "
                                 f"{mesh and mesh.devices} on "
                                 f"{torch.cuda.device_count()} cards")
        for n in HEAD["N"]:
            hidden = torch.from_numpy(rng.standard_normal(
                (1, n, HEAD["d_in"])).astype(np.float32)).to("cuda:0")
            before = maple_spmm_compact.launches
            with launches_by_card("maple_spmm", "maple_spmm_compact") as by:
                got = head(hidden)
                sync_all()
            mesh_launches = maple_spmm_compact.launches - before
            with sharding.local_partition_execution():
                want = head(hidden)
            if not torch.equal(got, want) or not torch.equal(head(hidden),
                                                             got):
                raise AssertionError(f"partitioned head {(d_, c_)} N={n}: "
                                     f"the mesh of cards differs from the "
                                     f"stacked loop")
            cases.append({"D": d_, "C": c_, "N": n,
                          "mesh": [str(d) for d in mesh.devices.flat],
                          "b1_launches": mesh_launches,
                          "b1_by_card": dict(by), "bit_equal": True,
                          "mesh_ms": device_ms_by_card(lambda: head(hidden)),
                          })
    return cases


# --------------------------------------------------------------------------
# expert-parallel training across cards (phase 36's train part)
# --------------------------------------------------------------------------

EP_TRAIN_STEPS = 3        # the bit-for-bit run's eager steps
EP_CHECK_LAYERS = 2       # the placed-training check's depth (every run)
EP_CHECK_STEPS = 2
# the resume's checkpoint (parameters and both moments, f32) stays under
# this many bytes on disk: granite cut to the deepest stack that does
EP_RESUME_BYTES = 5e9
EP_RESUME_DIR = ROOT / "build" / "smoke_ep_ckpt"


def ep_train_data(cfg):
    """``train_moe_ep``'s optimizer and data: ``launch.train.run``'s AdamW
    for 3 steps and 8 × ``EP_TRAIN_SEQ`` tokens a step from the seed, in
    the config's microbatches."""
    from repro_torch.data import DataConfig
    from repro_torch.train import OptimizerConfig
    return (OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=10),
            DataConfig(vocab_size=cfg.vocab_size, seq_len=EP_TRAIN_SEQ,
                       global_batch=8, seed=SEED))


def ep_train_state(cfg, mesh, ocfg):
    """``cfg``'s per-layer tree drawn from the seed on ``cuda:0`` as
    ``launch.train.run`` draws it, placed on ``mesh`` by
    ``device_put_params`` unless ``mesh`` is None (the whole tree dropped
    first), and AdamW's state on it."""
    from repro_torch.distributed.sharding import device_put_params
    from repro_torch.models import lm
    from repro_torch.train import init_opt_state
    gen = torch.Generator(device="cuda:0").manual_seed(SEED)
    params = lm.unstack_layers(lm.init_params(cfg, gen, device="cuda:0"))
    if mesh is not None:
        params = device_put_params(params, mesh)
    return params, init_opt_state(ocfg, params)


def ep_train_steps(params, opt, step_fn, dcfg, steps, mesh, before=None):
    """``steps`` eager steps of ``step_fn`` under ``mesh``, each timed to
    every card's end: loss, grad norm, wall ms, B8 (forward, remat, dx)
    and ``moe_dw_kernel`` launches by card, and with ``before`` (every
    card's bytes before the tree was drawn) each card's
    ``memory_allocated`` after the step against the placed state's
    bytes there (:func:`placed_bytes`)."""
    from repro_torch.data import synth_batch
    from repro_torch.distributed.sharding import use_mesh
    out = []
    for step in range(steps):
        batch = {k: v.to("cuda:0")
                 for k, v in synth_batch(dcfg, step, {}).items()}
        sync_all()
        t0 = time.perf_counter()
        with launches_by_card("moe_gemm", "maple_moe_gemm",
                              "maple_moe_gemm_dx") as b8, \
                launches_by_card("moe_gemm", "maple_moe_dw") as dw, \
                use_mesh(mesh):
            params, opt, metrics = step_fn(params, opt, batch)
            sync_all()
        rec = {"step": step, "wall_ms": (time.perf_counter() - t0) * 1e3,
               "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "b8_by_card": dict(b8), "dw_by_card": dict(dw)}
        if before is not None:
            now = card_bytes()
            want = placed_bytes({"params": params, "opt": opt})
            rec["allocated_gib_by_card"] = [
                (now[i] - before[i]) / 2**30 for i in range(len(now))]
            rec["reckoned_gib_by_card"] = [want.get(i, 0) / 2**30
                                           for i in range(len(now))]
        out.append(rec)
    return out


def state_on_host(params, opt) -> dict:
    """Host copies of every tensor of the parameters and both moments,
    by path (a placed leaf's slices in peer order)."""
    from repro_torch.train.optimizer import named_leaves, parts
    return {f"{tag}/{k}": [t.detach().cpu() for t in parts(leaf)]
            for tag, tree in (("params", params), ("m", opt.m), ("v", opt.v))
            for k, leaf in named_leaves(tree)}


def state_differs(host, params, opt) -> dict:
    """The leaves of the state on the cards whose bits differ from
    ``host`` (:func:`state_on_host`): path → largest |a - b|, each leaf
    brought to the host one at a time."""
    from repro_torch.train.optimizer import named_leaves, parts
    diff, seen = {}, 0
    for tag, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        for k, leaf in named_leaves(tree):
            key, seen = f"{tag}/{k}", seen + 1
            want = host[key]
            got = [t.detach().cpu() for t in parts(leaf)]
            if len(got) != len(want):
                diff[key] = float("inf")
            elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                diff[key] = max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(got, want))
    if seen != len(host):
        raise AssertionError(f"{seen} leaves against {len(host)} kept")
    return diff


def ep_placed_train_check():
    """Every run: granite cut to ``EP_CHECK_LAYERS`` at full width,
    ``EP_CHECK_STEPS`` eager steps of ``train_moe_ep``'s batch, the tree
    placed on four ``cuda:0`` entries against the whole tree under one
    card's ``(1, 4)`` mesh (the same per-peer code, the norm summed in
    another order): losses and grad norms within 1e-5 relative, every
    parameter within 1e-6 of the tree's largest |parameter| (each leaf's
    error against its own max printed); B8 and ``moe_dw_kernel`` launches
    of the placed run zeroed just before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, PeerSlices
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_dw
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import named_leaves
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=EP_CHECK_LAYERS)
    ocfg, dcfg = ep_train_data(cfg)
    step_fn = make_train_step(cfg, ocfg)
    runs = {}
    for name, mesh, placed in (
            ("whole", ep_mesh("cuda"), None),
            ("placed", Mesh([["cuda:0"] * EP_CARDS], ("data", "model")),
             True)):
        torch.cuda.empty_cache()
        params, opt = ep_train_state(cfg, mesh if placed else None, ocfg)
        moe_gemm.launches = moe_gemm_dw.launches = 0
        recs = ep_train_steps(params, opt, step_fn, dcfg, EP_CHECK_STEPS,
                              mesh)
        launches = {"moe_gemm": moe_gemm.launches,
                    "moe_gemm_dw": moe_gemm_dw.launches}
        runs[name] = (recs, launches,
                      {k: (v.whole("cpu") if isinstance(v, PeerSlices)
                           else v.cpu()).detach()
                       for k, v in named_leaves(params)})
        del params, opt
    micro = cfg.train_microbatches * cfg.n_layers * EP_CHECK_STEPS * EP_CARDS
    expect = {"moe_gemm": 9 * micro, "moe_gemm_dw": 3 * micro}
    (whole, n_whole, p_whole), (placed, n_placed, p_placed) = \
        runs["whole"], runs["placed"]
    if n_whole != expect or n_placed != expect:
        raise AssertionError(f"placed training check: launches {n_whole} / "
                             f"{n_placed}, expected {expect}")
    for a, b in zip(whole, placed):
        for key in ("loss", "grad_norm"):
            if not (np.isfinite(b[key]) and abs(b[key] - a[key])
                    <= 1e-5 * abs(a[key])):
                raise AssertionError(f"placed training check step "
                                     f"{a['step']}: {key} {b[key]} against "
                                     f"the whole tree's {a[key]}")
    # the tree's largest |parameter| scales the limit: a zero-centred norm
    # scale is two updates of lr's size, whose own max would hold its
    # step-2 gradient (from step-1 weights an ulp apart) to 1e-6 of lr
    limit = 1e-6 * max(float(w.abs().max()) for w in p_whole.values())
    errs = {k: float((p_placed[k] - want).abs().max())
            for k, want in p_whole.items()}
    worst = max(errs, key=errs.get)
    if errs[worst] > limit:
        raise AssertionError(f"placed training check: {worst} "
                             f"{errs[worst]} > {limit}")
    own = {k: e / float(p_whole[k].abs().max()) for k, e in errs.items()}
    torch.cuda.empty_cache()
    return n_placed, {
        "config": f"{MOE_ARCH}, {EP_CHECK_LAYERS} of 32 layers, full width, "
        f"f32, seed {SEED}, {EP_CHECK_STEPS} eager steps of 8 x "
        f"{EP_TRAIN_SEQ} tokens in {cfg.train_microbatches} microbatches",
        "meshes": "placed on four cuda:0 entries against the whole tree on "
        "one card's (1, 4) mesh",
        "loss_whole": [r["loss"] for r in whole],
        "loss_placed": [r["loss"] for r in placed],
        "grad_norm_whole": [r["grad_norm"] for r in whole],
        "grad_norm_placed": [r["grad_norm"] for r in placed],
        "param_max_abs_err": errs[worst], "param_limit": limit,
        "param_err_of_own_max": {k: own[k] for k in sorted(
            own, key=own.get)[-3:]}, "launches": n_placed,
        "tolerance": "loss and grad norm 1e-5 relative, parameters 1e-6 · "
        "the tree's largest |parameter|", "check_s": time.perf_counter() - t0}


def ep_cards_train_shape_check(params, cfg, mesh, dcfg):
    """Layer 0's MoE forward and backward at ``train_moe_ep``'s shapes (its
    input in the first microbatch of step 0, from a forward of the placed
    tree under ``mesh``) of ``sum(y·R)``: the placed slices on the cards
    against the whole layer on a CPU mesh of the same shape, y, dx and
    every expert and router gradient within 1e-5·max + 1e-6 (B8's
    forward and dx and ``moe_dw_kernel`` on each card against their plain
    versions); B8 and dW launches by card."""
    from repro_torch.data import synth_batch
    from repro_torch.distributed.sharding import PeerSlices, use_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    mcfg = lm._moe_cfg(cfg)
    batch = synth_batch(dcfg, 0, {})
    mb = {k: v[:dcfg.global_batch // cfg.train_microbatches].to("cuda:0")
          for k, v in batch.items()}
    with torch.no_grad(), use_mesh(mesh):
        _, (p0, h0) = layer0_moe_input(lambda: lm.forward(
            params, cfg, mb, remat=False))
    r = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        tuple(h0.shape)).astype(np.float32))
    fresh = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    got = {}
    for where in ("cards", "cpu"):
        if where == "cards":
            p = {k: v.map(fresh) if isinstance(v, PeerSlices) else fresh(v)
                 for k, v in p0.items()}
            x, m, rr = fresh(h0), mesh, r.to("cuda:0")
        else:
            p = {k: fresh(v.whole("cpu") if isinstance(v, PeerSlices)
                          else v.cpu()) for k, v in p0.items()}
            x, m, rr = fresh(h0.cpu()), ep_mesh("cpu"), r
        with launches_by_card("moe_gemm", "maple_moe_gemm",
                              "maple_moe_gemm_dx") as b8, \
                launches_by_card("moe_gemm", "maple_moe_dw") as dw:
            with use_mesh(m):
                y = M.moe_layer(p, mcfg, x)
                drops = M.ep_dropped_slots(p, mcfg, x.detach())
            (y * rr).sum().backward()
            sync_all()
        grads = {"d" + k: (v.map(lambda t: t.grad).whole("cpu")
                           if isinstance(v, PeerSlices) else v.grad.cpu())
                 for k, v in p.items()}
        got[where] = {"y": y.detach().cpu(), "dx": x.grad.cpu(), **grads}
        if where == "cards":
            by = {"b8_by_card": dict(b8), "dw_by_card": dict(dw)}
    peers = {i: 6 for i in range(EP_CARDS)}
    if by != {"b8_by_card": peers,
              "dw_by_card": {i: 3 for i in range(EP_CARDS)}}:
        raise AssertionError(f"layer-0 train shape on the cards: {by}")
    errs = {k: check_close(got["cards"][k], want, torch.float32,
                           f"layer-0 EP train shape {k}, cards against CPU")
            for k, want in got["cpu"].items()}
    return {"sizes": M.ep_sizes(mesh, mcfg, *h0.shape[:2]),
            "dropped_slots": drops, "max_abs_err": errs, **by,
            "tolerance": "1e-5·max + 1e-6", "loss": "sum(y·R)"}


def ep_resume_config():
    """granite at full width cut to the deepest stack whose checkpoint
    (every stored parameter and both moments, f32: 12 bytes a parameter,
    the padded experts counted) stays under ``EP_RESUME_BYTES``; (config,
    reckoning beside ``param_count``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import leaves_with_path
    from repro_torch.models import lm
    full = get_config(MOE_ARCH)
    for n in range(full.n_layers, 0, -1):
        cfg = dataclasses.replace(full, n_layers=n)
        stored = sum(t.numel() for _, t in leaves_with_path(
            lm.init_params(cfg, None, device="meta")) if torch.is_tensor(t))
        if 12 * stored <= EP_RESUME_BYTES:
            return cfg, {"n_layers": n, "param_count": cfg.param_count(),
                         "stored_params": stored,
                         "checkpoint_bytes_reckoned": 12 * stored}
    raise AssertionError("not one granite layer's checkpoint fits")


@contextlib.contextmanager
def timed_checkpoints():
    """``ft.checkpoint.save`` and ``load`` wrapped: each call's seconds
    (every card synchronised after it), by function, in call order."""
    from repro_torch.ft import checkpoint as ckpt
    seconds = {"save": [], "load": []}
    kept = {name: getattr(ckpt, name) for name in seconds}

    def timer(name):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = kept[name](*args, **kw)
            sync_all()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return timed
    for name in seconds:
        setattr(ckpt, name, timer(name))
    try:
        yield seconds
    finally:
        for name, fn in kept.items():
            setattr(ckpt, name, fn)


def ep_cards_resume(mesh):
    """``launch.train.run`` under ``mesh`` (four cards: the launcher
    places the tree, the step runs eagerly) on granite cut by
    :func:`ep_resume_config`, ``train_moe_ep``'s batch: 4 straight steps
    against 2 steps with ``ckpt_dir``, then 4 from the same directory
    (resumed from 2): losses, parameters and both moments bit for bit;
    save and load seconds and the checkpoint's bytes on disk."""
    import shutil
    from repro_torch.distributed.sharding import PeerSlices, use_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_step import CapturedTrainStep
    shutil.rmtree(EP_RESUME_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    cfg, reckoned = ep_resume_config()
    kw = dict(seq_len=EP_TRAIN_SEQ, global_batch=8, seed=SEED,
              device="cuda")
    d = str(EP_RESUME_DIR)
    with use_mesh(mesh):
        straight = launch_train.run(cfg, steps=4, **kw)
        kept = state_on_host(straight.params, straight.opt)
        losses = [r["loss"] for r in straight.history]
        del straight
        torch.cuda.empty_cache()
        with timed_checkpoints() as seconds:
            first = launch_train.run(cfg, steps=2, ckpt_dir=d, **kw)
            nbytes = sum(f.stat().st_size
                         for f in (EP_RESUME_DIR / "step_00000002").iterdir())
            del first
            torch.cuda.empty_cache()
            resumed = launch_train.run(cfg, steps=4, ckpt_dir=d, **kw)
    up = resumed.params["groups"]["b0"][0]["moe"]["experts_up"]
    if not isinstance(up, PeerSlices) or [t.device.index for t in up.parts]             != [mesh.device_at(model=pe).index for pe in range(EP_CARDS)]:
        raise AssertionError("the resumed run's experts are not placed on "
                             "their peers' cards")
    if isinstance(resumed.step_fn, CapturedTrainStep):
        raise AssertionError("a run across cards captured its step")
    if [r["step"] for r in resumed.history] != [2, 3]:
        raise AssertionError(f"the run did not resume from step 2: "
                             f"{[r['step'] for r in resumed.history]}")
    diff = state_differs(kept, resumed.params, resumed.opt)
    if diff or [r["loss"] for r in resumed.history] != losses[2:]:
        raise AssertionError(f"the resumed run differs from the straight "
                             f"one: {dict(list(diff.items())[:5])}")
    del resumed, kept
    shutil.rmtree(EP_RESUME_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"config": f"{MOE_ARCH}, {cfg.n_layers} of 32 layers, full "
            f"width, f32, seed {SEED}, 8 x {EP_TRAIN_SEQ} tokens a step in "
            f"{cfg.train_microbatches} microbatches", "reckoned": reckoned,
            "run": "4 straight steps against 2 with ckpt_dir, then 4 from "
            "it (resumed from 2)", "bit_identical": True, "loss": losses,
            "checkpoint_bytes": nbytes, "save_s": seconds["save"],
            "load_s": seconds["load"]}


def ep_cards_train(mesh):
    """The four-card part's training (module docstring, phase 36):
    granite at full width and depth, ``EP_TRAIN_STEPS`` eager steps of
    ``train_moe_ep``'s batch with the placed tree on four ``cuda:0``
    entries (host copies of the parameters and moments kept), then on the
    four cards: every step's loss and grad norm and the state after the
    last bit for bit; B8 and ``moe_dw_kernel`` launches by card a step;
    each card's bytes after a step against the placed state's; one
    profiled step by card; layer 0's forward and backward against the
    CPU mesh; the resume through ``launch.train.run``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_dw
    from repro_torch.train import make_train_step
    cfg = get_config(MOE_ARCH)
    ocfg, dcfg = ep_train_data(cfg)
    step_fn = make_train_step(cfg, ocfg)
    release_graphs()
    one = Mesh([["cuda:0"] * EP_CARDS], ("data", "model"))
    t0 = start = time.perf_counter()
    params, opt = ep_train_state(cfg, one, ocfg)
    one_card = ep_train_steps(params, opt, step_fn, dcfg, EP_TRAIN_STEPS,
                              one)
    peak_one = torch.cuda.max_memory_allocated(0) / 2**30
    kept = state_on_host(params, opt)
    del params, opt
    one_card_s = time.perf_counter() - t0
    before = card_bytes()
    for i in range(EP_CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    params, opt = ep_train_state(cfg, mesh, ocfg)
    moe_gemm.launches = moe_gemm_dw.launches = 0
    cards = ep_train_steps(params, opt, step_fn, dcfg, EP_TRAIN_STEPS, mesh,
                           before)
    launches = {"moe_gemm": moe_gemm.launches,
                "moe_gemm_dw": moe_gemm_dw.launches}
    peaks = [torch.cuda.max_memory_allocated(i) / 2**30
             for i in range(EP_CARDS)]
    t0 = time.perf_counter()
    diff = state_differs(kept, params, opt)
    compare_s = time.perf_counter() - t0
    del kept
    per_card = cfg.train_microbatches * cfg.n_layers
    want = {"b8_by_card": {i: 9 * per_card for i in range(EP_CARDS)},
            "dw_by_card": {i: 3 * per_card for i in range(EP_CARDS)}}
    for rec in cards:
        got = {k: rec[k] for k in want}
        if got != want:
            raise AssertionError(f"EP training on four cards, step "
                                 f"{rec['step']}: {got}, expected {want}")
        for i, (a, r) in enumerate(zip(rec["allocated_gib_by_card"],
                                       rec["reckoned_gib_by_card"])):
            if abs(a - r) > 1.0:
                raise AssertionError(f"EP training on four cards: cuda:{i} "
                                     f"holds {a} GiB after step "
                                     f"{rec['step']}, reckoned {r}")
    if launches != {"moe_gemm": 9 * per_card * EP_CARDS * EP_TRAIN_STEPS,
                    "moe_gemm_dw": 3 * per_card * EP_CARDS * EP_TRAIN_STEPS}:
        raise AssertionError(f"EP training on four cards: {launches}")
    bits = [(a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
            for a, b in zip(one_card, cards)]
    if not all(bits) or diff:
        raise AssertionError(f"EP training on four cards differs from four "
                             f"cuda:0 entries: steps {bits}, leaves "
                             f"{dict(list(diff.items())[:5])}")
    step = {"n": EP_TRAIN_STEPS}

    def one_step():
        from repro_torch.data import synth_batch
        from repro_torch.distributed.sharding import use_mesh
        batch = {k: v.to("cuda:0")
                 for k, v in synth_batch(dcfg, step["n"], {}).items()}
        step["n"] += 1
        with use_mesh(mesh):
            step_fn(params, opt, batch)
    profiled = device_ms_by_card(one_step, warmup=False)
    check = ep_cards_train_shape_check(params, cfg, mesh, dcfg)
    del params, opt
    torch.cuda.empty_cache()
    resume = ep_cards_resume(mesh)
    return launches, {
        "config": f"{MOE_ARCH}, {cfg.n_layers} layers, full width, f32, its "
        f"own config "
        f"(moe_impl {cfg.moe_impl}, capacity {cfg.moe_capacity_factor}), "
        f"seed {SEED}, 8 x {EP_TRAIN_SEQ} tokens a step in "
        f"{cfg.train_microbatches} microbatches, eager",
        "compared": "host copies of every parameter and both moments after "
        f"step {EP_TRAIN_STEPS}, and every step's loss and grad norm",
        "bit_identical": True, "one_card_mesh": one_card,
        "one_card_peak_gib": peak_one, "one_card_s": one_card_s,
        "cards": cards, "peak_gib_by_card": peaks, "compare_s": compare_s,
        "launches": launches, "launches_expected_by_card_a_step": want,
        "walls_ms_steps_2_3": [r["wall_ms"] for r in cards[1:]],
        "profile_step": profiled, "layer0_train_shape": check,
        "resume": resume, "train_s": time.perf_counter() - start}


def moe_ep_cards(card):
    """Expert parallelism with each peer's experts on its own card (module
    docstring, phase 36) on :func:`cards_mesh`: granite-moe-3b serving at
    full width and depth on the cards the process sees, and the placed
    training check on four ``cuda:0`` entries; with four cards also
    qwen3-moe-235b at phase 31's depth, its deepest placed stack, the
    partitioned head across cards and granite's training across cards.
    Returns the launches of each path (serving, and the placed training:
    the check's on one card, the four-card run's on four) and the line."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    mesh = cards_mesh()
    n_cards = torch.cuda.device_count()
    several = n_cards >= EP_CARDS
    launches, granite = ep_cards_compare(get_config(MOE_ARCH), mesh,
                                         "moe_ep_cards granite")
    paths = {"moe_ep_cards": launches}
    paths["moe_ep_cards_train"], check = ep_placed_train_check()
    line = {"phase": "moe_ep_cards", "card": card, "cards": n_cards,
            "launches": launches, "placed_train_check": check,
            "device_names": [torch.cuda.get_device_name(i)
                             for i in range(n_cards)],
            "decode_steps": ("eager: a mesh of several cards is not "
                             "captured" if several else "captured: one "
                             "card's mesh"),
            "granite": granite}
    if not several:
        line["four_cards"] = (f"not run: this process sees {n_cards} "
                              f"card(s); the four-card part needs four")
        line["train"] = "not run: needs four cards"
    else:
        paths["moe_ep_cards_train"], line["train"] = ep_cards_train(mesh)
        qwen_cfg, reckoned = qwen3_moe_config()
        _, line["qwen3_moe"] = ep_cards_compare(
            qwen_cfg, mesh, "moe_ep_cards qwen3-moe")
        line["qwen3_moe"]["one_card_depth_reckoned"] = reckoned
        _, line["qwen3_moe_deep"] = ep_cards_deep(mesh)
        line["partitioned_head"] = partitioned_cards()
    line["launches_by_path"] = paths
    line["phase_s"] = time.perf_counter() - t0
    return paths, line


# --------------------------------------------------------------------------
# phase 37: the GPipe pipeline across cards
# --------------------------------------------------------------------------

# qwen2-72b (QKV biases) with bf16 parameters and its sparse MLP at
# (64, 64) blocks, density 0.25, pipelined over 4 stages: the config's
# train_microbatches (8) microbatches of 1 × 1 024 embedded tokens; one
# card runs it cut to 8 layers (2 a stage), four cards at all 80 (20 a
# card)
PIPE_CARDS_ARCH, PIPE_CARDS_SEQ, PIPE_CARDS_CUT = "qwen2-72b", 1024, 8
PIPE_CARDS = 4


def pipe_cards_config(n_layers=None):
    """qwen2-72b with its sparse MLP, at ``n_layers`` (default: all)."""
    from repro_torch.configs import get_config
    cfg = get_config(PIPE_CARDS_ARCH)
    return dataclasses.replace(cfg, sparse_mlp=True,
                               n_layers=n_layers or cfg.n_layers)


def pipe_cards_layer(cfg, gen):
    """One block of ``cfg`` in the trainer's per-layer layout, bf16,
    drawn from ``gen`` on its card, its QKV biases drawn
    (:func:`draw_biases`)."""
    from repro_torch.models import lm
    layer = lm._init_block(gen, cfg, "attn", stack=(), dtype=torch.bfloat16)
    draw_biases(layer, gen)
    return layer


def share_pattern(layers):
    """Every layer's sparse down-projection on layer 0's host pattern
    arrays and per-device metadata (each layer drew the same pattern from
    ``cfg.sparse_mask_seed``), so that one ``sparse_mlp_plan`` serves
    every card."""
    first = layers[0]["mlp"]["w_down"]
    for layer in layers:
        w = layer["mlp"]["w_down"]
        if not all(np.array_equal(getattr(w, f), getattr(first, f))
                   for f in ("block_col", "block_row", "row_ptr")):
            raise AssertionError("the layers drew different sparse patterns")
        layer["mlp"]["w_down"] = dataclasses.replace(first, blocks=w.blocks)
    return layers


def pipe_cards_inputs(cfg, gen):
    """``train_microbatches`` sequences of ``PIPE_CARDS_SEQ`` tokens
    embedded by a table drawn from ``gen`` (bf16, on its card; used and
    dropped), and R for ``sum(y·R)``."""
    from repro_torch.models import layers as L
    embed = L.dense_init(gen, (cfg.vocab_padded, cfg.d_model), cfg.d_model,
                         torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size,
                           (cfg.train_microbatches, PIPE_CARDS_SEQ),
                           generator=gen, device=gen.device)
    x = embed[tokens]
    del embed
    torch.cuda.empty_cache()
    r = torch.randn(x.shape, generator=gen, device=gen.device).to(x.dtype)
    return x, r


def sequential_blocks(stage_fn, stages, n_micro):
    """``h`` through the stages' blocks in order, microbatch by
    microbatch, each stage on its layers' card; the output on ``h``'s
    card."""
    def run(h):
        outs = []
        for mb in h.chunk(n_micro):
            for layers in stages:
                mb = stage_fn(layers, mb.to(layers[0]["attn"]["wq"].device))
            outs.append(mb.to(h.device))
        return torch.cat(outs)
    return run


def pipe_cards_mlp_check(w, plan, gen):
    """One block's sparse down-projection ``w`` (d_ff → d_model) on a
    microbatch of 1 × ``PIPE_CARDS_SEQ`` tokens, through ``sparse_linear``
    on ``plan`` as the path calls it, forward and backward of
    ``sum(y·G)``: y (the forward plan's kernel), dh (the transpose-side
    plan's) and the blocks' gradient (B2), each against the plain
    masked-dense product in f32 of the same values by
    :func:`check_close`'s rule for ``w``'s dtype; its launches counted
    (one of each kernel, apart from the path's)."""
    from repro_torch.models.layers import sparse_linear
    dtype = w.blocks.dtype
    h = torch.randn((1, PIPE_CARDS_SEQ, w.shape[1]), generator=gen,
                    device=gen.device).to(dtype)
    g = torch.randn((1, PIPE_CARDS_SEQ, w.shape[0]), generator=gen,
                    device=gen.device).to(dtype)
    out = {}
    zero_pipe_launches()
    for name, dt in (("kernel", dtype), ("plain", torch.float32)):
        blocks = w.blocks.detach().to(dt).requires_grad_(True)
        hx = h.detach().to(dt).requires_grad_(True)
        wx = dataclasses.replace(w, blocks=blocks)
        y = (sparse_linear(wx, hx, plan=plan) if name == "kernel"
             else torch.matmul(hx, wx.to_dense().t()))
        y.backward(g.to(dt))
        out[name] = (y.detach(), hx.grad, blocks.grad)
        if name == "kernel":
            launches = pipe_launches()
    names = ("y", "dh", "dblocks")
    errs = {what: check_close(got, want, dtype, f"sparse MLP {what}")
            for what, got, want in zip(names, out["kernel"], out["plain"])}
    share = {what: errs[what] / float(want.abs().max())
             for what, want in zip(names, out["plain"])}
    expect = pipe_expected(plan, 1)
    expect[PLANNED[plan.fwd.fused]] -= 1          # no recompute here
    if launches != expect:
        raise AssertionError(f"sparse MLP check: launches {launches}, "
                             f"expected {expect}")
    return {"shape": [*w.shape], "block": [*w.block_shape],
            "nnzb": int(w.nnzb), "tokens": PIPE_CARDS_SEQ,
            "kernels": {"y": PLANNED[plan.fwd.fused],
                        "dh": PLANNED[plan.bwd.fused],
                        "dblocks": "maple_sddmm_bsr"},
            "launches": launches, "max_abs_err": errs,
            "share_of_max": share, "tolerance": "1e-2·max (bf16)" if dtype == torch.bfloat16
            else "1e-5·max + 1e-6"}


def pipe_cards_cut():
    """qwen2-72b at full width cut to 8 layers (2 a stage), bf16, sparse
    MLP, drawn on ``cuda:0``, through ``pipeline_apply`` over four
    ``cuda:0`` entries: 8 microbatches of 1 × 1 024 embedded tokens, the
    gradients of ``sum(y·R)``; launches zeroed just before and read just
    after, exact; y, dx and every gradient against the same blocks run in
    order, microbatch by microbatch, within 1e-2·max.  Returns the
    launches, the line, and the tree, inputs and results for the
    four-card check."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = pipe_cards_config(PIPE_CARDS_CUT)
    gen = torch.Generator(device="cuda:0").manual_seed(SEED)
    layers = share_pattern([pipe_cards_layer(cfg, gen)
                            for _ in range(cfg.n_layers)])
    x, r = pipe_cards_inputs(cfg, gen)
    plan = lm.sparse_mlp_plan(layers)
    stage_fn = pipe_stage_fn(cfg, plan)
    mesh = make_debug_mesh((PIPE_CARDS,), ("pod",), device="cuda")
    m = cfg.train_microbatches
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_pipe_launches()
    t1 = time.perf_counter()
    got = pipe_grads(layers, lambda h: pipeline_apply(stage_fn, mesh, m,
                                                      layers, h), x, r)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    launches = pipe_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expect = pipe_expected(plan, m * cfg.n_layers)
    if launches != expect:
        raise AssertionError(f"pipeline_cards launches {launches}, expected "
                             f"{expect}")
    per = cfg.n_layers // PIPE_CARDS
    stages = [layers[p * per:(p + 1) * per] for p in range(PIPE_CARDS)]
    want = pipe_grads(layers, sequential_blocks(stage_fn, stages, m), x, r)
    bf = torch.bfloat16
    errs = {"y_max_abs_err": check_close(got[0], want[0], bf, "8 layers: y"),
            "dx_max_abs_err": check_close(got[2], want[2], bf,
                                          "8 layers: dx"),
            "grad_max_abs_err": max(
                check_close(a, b, bf, f"8 layers: grad {i}")
                for i, (a, b) in enumerate(zip(got[1], want[1])))}
    errs["bit_identical"] = (torch.equal(got[0], want[0])
                             and torch.equal(got[2], want[2])
                             and all(torch.equal(a, b)
                                     for a, b in zip(got[1], want[1])))
    del want
    mlp = pipe_cards_mlp_check(layers[0]["mlp"]["w_down"], plan, gen)
    line = {"config": f"{PIPE_CARDS_ARCH} at full width, {cfg.n_layers} of "
            f"80 layers, bf16, sparse_mlp (64,64) d=0.25, QKV biases drawn, "
            f"remat per block", "n_layers": cfg.n_layers,
            "depth_reduced": True, "mesh": {"pod": PIPE_CARDS},
            "devices": "four cuda:0 entries", "microbatches": m,
            "tokens": [m, PIPE_CARDS_SEQ], "launches": launches,
            "launches_expected": expect,
            "plan_fused": [plan.fwd.fused, plan.bwd.fused],
            "vs_sequential": errs, "tolerance": "1e-2·max",
            "mlp_vs_plain": mlp,
            "init_s": init_s, "wall_ms": wall_ms, "peak_mem_gib": peak_gib,
            "n_grads": len(got[1]), "s": time.perf_counter() - t0}
    return launches, line, (cfg, layers, plan, x, r, got)


def pipe_cards_bits(cut, mesh):
    """The 8-layer tree of :func:`pipe_cards_cut` placed by
    ``place_stages`` on the four cards: y, dx and every gradient against
    the four ``cuda:0`` entries' bit for bit (else, the gaps, held to
    1e-2·max); each layer's ``.grad`` on its stage's card; the unplaced
    tree raises there."""
    from repro_torch.distributed.pipeline import pipeline_apply, place_stages
    from repro_torch.train.optimizer import named_leaves
    cfg, layers, plan, x, r, one = cut
    stage_fn = pipe_stage_fn(cfg, plan)
    m = cfg.train_microbatches
    devices = [mesh.device_at(pod=p) for p in range(PIPE_CARDS)]
    try:
        pipeline_apply(stage_fn, mesh, m, layers, x)
    except ValueError as e:
        unplaced = str(e)
    else:
        raise AssertionError("the unplaced tree ran on four cards")
    placed = place_stages(layers, mesh)
    per_layer = len(list(named_leaves(layers[0])))
    per = cfg.n_layers // PIPE_CARDS
    leaves = [t for _, t in named_leaves(placed)]
    kept = sum(t is u for t, (_, u) in zip(leaves, named_leaves(layers)))
    y, grads, dx = pipe_grads(
        placed, lambda h: pipeline_apply(stage_fn, mesh, m, placed, h), x, r)
    for i, g in enumerate(grads):
        if g.device != devices[i // per_layer // per]:
            raise AssertionError(f"grad {i} on {g.device}, its stage on "
                                 f"{devices[i // per_layer // per]}")
    equal = [torch.equal(y, one[0]), torch.equal(dx, one[2])] + [
        torch.equal(g.to(w.device), w) for g, w in zip(grads, one[1])]
    out = {"bit_identical": all(equal), "kept_on_cuda0": kept,
           "leaves": len(leaves), "unplaced_raises": unplaced[:160]}
    if not all(equal):
        out["differ"] = [i for i, e in enumerate(equal) if not e]
        bf = torch.bfloat16
        out["max_abs_err"] = max(
            [check_close(y, one[0], bf, "four cards: y"),
             check_close(dx, one[2], bf, "four cards: dx")]
            + [check_close(g, w, bf, f"four cards: grad {i}")
               for i, (g, w) in enumerate(zip(grads, one[1]))])
    return out


def pipe_cards_profile(fn):
    """One call of ``fn`` under torch.profiler: its wall ms (every card
    synchronised), its device events by card (:func:`events_by_card`),
    and the ms during which 0, 1, … ``PIPE_CARDS`` cards ran a kernel at
    once (each card's kernel intervals swept together): the stages'
    overlap, which a run that serialised the cards would leave at 1."""
    import collections
    from torch.profiler import ProfilerActivity
    sync_all()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.profiler.kineto_results.events())
    edges = sorted(
        edge for e in events
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.name().startswith(("Memcpy", "Memset"))
        for edge in ((e.start_ns(), e.device_index(), 1),
                     (e.start_ns() + e.duration_ns(), e.device_index(), -1)))
    busy_ms = [0.0] * (PIPE_CARDS + 1)
    running = collections.Counter()
    for (t, card, step), (t_next, _, _) in zip(edges, edges[1:]):
        running[card] += step
        busy_ms[sum(n > 0 for n in running.values())] += (t_next - t) / 1e6
    return {"wall_ms": wall_ms, "by_card": events_by_card(events),
            "cards_busy_at_once_ms": busy_ms}


def pipe_cards_full(mesh):
    """qwen2-72b at all 80 layers, 20 on each card, each stage drawn on
    its own card (no card ever holds the whole tree; one host pattern),
    through ``pipeline_apply`` with 8 microbatches of 1 × 1 024 embedded
    tokens, forward and backward of ``sum(y·R)``: launches, ring bytes
    and peak GiB by card in the first run; a second run's wall; a third
    profiled by card; then the same blocks run in order on their cards,
    microbatch by microbatch: y, dx and every gradient (the pipeline's
    held as host copies meanwhile) within 1e-2·max."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import collectives_moved
    from repro_torch.models import lm
    from repro_torch.train.optimizer import named_leaves
    t0 = time.perf_counter()
    cfg = pipe_cards_config()
    devices = [mesh.device_at(pod=p) for p in range(PIPE_CARDS)]
    per = cfg.n_layers // PIPE_CARDS
    stages = []
    for p, dev in enumerate(devices):
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 + p)
        stages.append([pipe_cards_layer(cfg, gen) for _ in range(per)])
    layers = share_pattern([layer for stage in stages for layer in stage])
    stages = [layers[p * per:(p + 1) * per] for p in range(PIPE_CARDS)]
    x, r = pipe_cards_inputs(cfg, torch.Generator(
        device=devices[0]).manual_seed(SEED))
    plan = lm.sparse_mlp_plan(layers)
    stage_fn = pipe_stage_fn(cfg, plan)
    m = cfg.train_microbatches
    piped = lambda h: pipeline_apply(stage_fn, mesh, m, layers, h)
    sync_all()
    init_s = time.perf_counter() - t0
    params_gib = {f"cuda:{i}": n / 2**30
                  for i, n in placed_bytes(layers).items()}
    for i in range(PIPE_CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    before = collectives_moved()
    zero_pipe_launches()
    with launches_by_card("maple_spmm", "maple_spmm_planned") as b4, \
            launches_by_card("maple_spmm", "maple_spmm_compact") as b1, \
            launches_by_card("maple_sddmm", "maple_sddmm_bsr") as b2:
        t1 = time.perf_counter()
        y, grads, dx = pipe_grads(layers, piped, x, r)
        sync_all()
        first_ms = (time.perf_counter() - t1) * 1e3
    launches = pipe_launches()
    moved = {k: v - before[k] for k, v in collectives_moved().items()}
    peaks = [torch.cuda.max_memory_allocated(i) / 2**30
             for i in range(PIPE_CARDS)]
    by_card = {"maple_spmm_planned": dict(b4), "maple_spmm_compact": dict(b1),
               "maple_sddmm_bsr": dict(b2)}
    expect = pipe_expected(plan, m * cfg.n_layers)
    if launches != expect:
        raise AssertionError(f"pipeline_cards full depth: launches "
                             f"{launches}, expected {expect}")
    for name, counts in by_card.items():
        want = {i: expect[name] // PIPE_CARDS for i in range(PIPE_CARDS)}
        if {i: c for i, c in counts.items() if c} != \
                {i: c for i, c in want.items() if c}:
            raise AssertionError(f"pipeline_cards full depth: {name} by "
                                 f"card {dict(counts)}, expected {want}")
    hop = PIPE_CARDS_SEQ * cfg.d_model * 2
    ring = {"collective_permute_bytes": moved["collective-permute"],
            "reckoned_each_way": m * (PIPE_CARDS - 1) * hop,
            "all_reduce_bytes": moved["all-reduce"]}
    if moved["collective-permute"] != 2 * ring["reckoned_each_way"]:
        raise AssertionError(f"ring bytes {ring}")
    if not all(bool(torch.isfinite(t).all()) for t in (y, dx)):
        raise AssertionError("pipeline_cards full depth: non-finite output")
    host = [g.cpu() for g in grads]
    host_y, host_dx = y.cpu(), dx.cpu()
    del grads, y, dx
    leaves = [t for _, t in named_leaves(layers)]

    def fwd_bwd():
        (piped(x) * r).sum().backward()
        for t in leaves:
            t.grad = None
    wall_ms = walls_ms(fwd_bwd, calls=1)[0]
    prof = pipe_cards_profile(fwd_bwd)
    busy = sum(c["kernel_ms"] for c in prof["by_card"].values())
    t2 = time.perf_counter()
    want = pipe_grads(layers, sequential_blocks(stage_fn, stages, m), x, r)
    sync_all()
    sequential_ms = (time.perf_counter() - t2) * 1e3
    bf = torch.bfloat16
    errs = {"y_max_abs_err": check_close(host_y, want[0], bf, "80 layers: y"),
            "dx_max_abs_err": check_close(host_dx, want[2], bf,
                                          "80 layers: dx"),
            "grad_max_abs_err": max(
                check_close(h, w, bf, f"80 layers: grad {i}")
                for i, (h, w) in enumerate(zip(host, want[1])))}
    line = {"config": f"{PIPE_CARDS_ARCH} at full width and depth, bf16, "
            f"sparse_mlp (64,64) d=0.25, QKV biases drawn, remat per block",
            "n_layers": cfg.n_layers, "depth_reduced": False,
            "layers_a_card": per, "microbatches": m,
            "tokens": [m, PIPE_CARDS_SEQ], "init_s": init_s,
            "params_gib_by_card": params_gib,
            "reckoned_gib_by_card": {k: 2 * v for k, v in params_gib.items()},
            "peak_gib_by_card": peaks, "launches": launches,
            "launches_by_card": by_card, "ring": ring,
            "first_wall_ms": first_ms, "wall_ms": wall_ms,
            "sequential_wall_ms": sequential_ms,
            "device_ms_by_card": prof,
            "efficiency": busy / (PIPE_CARDS * wall_ms),
            "gpipe_ideal": m / (m + PIPE_CARDS - 1),
            "vs_sequential": errs, "tolerance": "1e-2·max",
            "s": time.perf_counter() - t0}
    del layers, stages, leaves, want, host, x, r
    torch.cuda.empty_cache()
    return launches, line


def pipeline_cards(card):
    """The GPipe pipeline with each stage's layer groups on its own card
    (module docstring, phase 37): every run the qwen2-72b smoke config
    card against CPU and the 8-layer full-width tree on four ``cuda:0``
    entries against the sequential blocks; with four cards also that tree
    placed on them (bit for bit against the one card) and qwen2-72b at
    all 80 layers, 20 a card.  Returns the one-card run's launches (the
    path's) and the line."""
    from repro_torch.launch.mesh import make_debug_mesh
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    line = {"phase": "pipeline_cards", "card": card, "cards": n_cards,
            "smoke_card_vs_cpu":
                pipeline_smoke_against_cpu(PIPE_CARDS_ARCH)}
    launches, line["cut"], cut = pipe_cards_cut()
    if n_cards < PIPE_CARDS:
        line["four_cards"] = (f"not run: needs four cards (this process "
                              f"sees {n_cards})")
        del cut
    else:
        mesh = make_debug_mesh((PIPE_CARDS,), ("pod",))
        line["device_names"] = [torch.cuda.get_device_name(i)
                                for i in range(n_cards)]
        line["bits"] = pipe_cards_bits(cut, mesh)
        del cut
        torch.cuda.empty_cache()
        _, line["full_depth"] = pipe_cards_full(mesh)
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t0
    return launches, line


def profile_events(events):
    """The profiler's raw events, aggregated in one pass (``key_averages``
    takes minutes over a train step's million events): device events by
    name as [count, ns]; host events by name as [count, self ns], self
    being an event's duration less its direct children's on its thread."""
    import collections
    dev = collections.defaultdict(lambda: [0, 0])
    host = collections.defaultdict(lambda: [0, 0])
    threads = collections.defaultdict(list)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = dev[e.name()]
            row[0] += 1
            row[1] += e.duration_ns()
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            threads[e.start_thread_id()].append(
                (e.start_ns(), -e.duration_ns(), e.name()))
    for evs in threads.values():
        evs.sort()                      # by start, the enclosing one first
        stack = []                      # [end, name, self ns]
        for start, neg, name in evs:
            while stack and stack[-1][0] <= start:
                _, done, self_ns = stack.pop()
                host[done][1] += self_ns
            if stack:
                stack[-1][2] += neg
            host[name][0] += 1
            stack.append([start - neg, name, -neg])
        for _, done, self_ns in stack:
            host[done][1] += self_ns
    return dev, host


def key_averages_check(prof, kernels, hosts) -> dict:
    """``profile_events``' sums beside ``key_averages``' for the same
    profile: device ms and launches over the CUDA entries, and each of the
    top host operators' count and self ms."""
    ka = prof.key_averages()
    cuda = [e for e in ka
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_key = {e.key: e for e in ka}
    return {
        "device_ms": {"profile_events": sum(ns for _, (_, ns) in kernels)
                      / 1e6, "key_averages": sum(
                          e.self_device_time_total for e in cuda) / 1e3},
        "launches": {"profile_events": sum(n for _, (n, _) in kernels),
                     "key_averages": sum(e.count for e in cuda)},
        "host_top": [{"op": k[:60], "count": [n, by_key[k].count
                                              if k in by_key else None],
                      "self_cpu_ms": [ns / 1e6, by_key[k].self_cpu_time_total
                                      / 1e3 if k in by_key else None]}
                     for k, (n, ns) in hosts[:8]]}


def profile(fn, warmup: bool = True, totals=(), cross_check=False) -> dict:
    """One call of ``fn`` under torch.profiler (after one call outside it
    with ``warmup``): wall ms, the device time summed over kernels, the
    kernels that took the most of it, the device ms and launches of the
    kernels whose names contain each string of ``totals``, and the host
    operators with the most self time (inflated by the profiler's own
    cost); with ``cross_check`` also :func:`key_averages_check`."""
    from torch.profiler import ProfilerActivity
    if warmup:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, host = profile_events(prof.profiler.kineto_results.events())
    kernels = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)
    hosts = sorted(host.items(), key=lambda kv: kv[1][1], reverse=True)
    checked = ({"key_averages_check": key_averages_check(prof, kernels, hosts)}
               if cross_check else {})
    return {**checked, "wall_ms": wall_ms,
            "device_ms": sum(ns for _, (_, ns) in kernels) / 1e6,
            "launches": sum(n for _, (n, _) in kernels),
            "totals": {sub: {"device_ms": sum(ns for k, (_, ns) in kernels
                                              if sub in k) / 1e6,
                             "launches": sum(n for k, (n, _) in kernels
                                             if sub in k)}
                       for sub in totals},
            "top": [{"kernel": k[:80], "count": n, "device_ms": ns / 1e6}
                    for k, (n, ns) in kernels[:8]],
            "host_top": [{"op": k[:60], "count": n, "self_cpu_ms": ns / 1e6}
                         for k, (n, ns) in hosts[:8]]}


def main(argv) -> int:
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or argv[1] not in (
                "moe_ep_cards", "pipeline_cards"):
            print("usage: chip_smoke.py [--only moe_ep_cards|pipeline_cards]",
                  file=sys.stderr)
            return 2
        only = argv[1]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi_all = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    smi = smi_all[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    build_s = _build.build_all()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s,
          "device_count": torch.cuda.device_count(),
          "nvidia_smi_all": smi_all})
    if only is not None:
        _, line = (moe_ep_cards if only == "moe_ep_cards"
                   else pipeline_cards)(smi)
        emit(line)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    spec = card_spec(name)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")

    n_edge = edge_cases() + sddmm_edge_cases()
    emit({"phase": "kernels_edge", "cases": n_edge, "ok": True})
    emit(planned_edge_cases())
    rows, plan_s = serving_shapes(spec, flush)
    train_rows, train_plans = training_shapes(spec, flush)
    rows += train_rows
    for row in rows:
        emit({"phase": "kernels", "card": smi, **row})
    emit({"phase": "head_plan", "plan_spmm_s": plan_s,
          "train_plans": train_plans})
    del flush
    torch.cuda.empty_cache()

    emit(small_reference())
    serve_launches, serve_line = serve(smi)
    emit(serve_line)
    emit(train_reference())
    train_launches, train_line = train(smi)
    emit(train_line)
    emit(head_backward())
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    part_launches, part_line = partitioned(spec, flush, smi)
    emit(part_line)
    autotune_launches, autotune_line = autotune(smi)
    emit(autotune_line)
    emit(spgemm_kernels_edge())
    spgemm_launches, spgemm_kernel_rows, spgemm_line, clones = spgemm(
        spec, flush, smi)
    emit(spgemm_line)
    for row in spgemm_kernel_rows:
        emit({"phase": "kernels", "card": smi, **row})
    rows += spgemm_kernel_rows
    gustavson_launches, gustavson_line = gustavson(clones, smi)
    emit(gustavson_line)
    emit(paper_tables_phase(clones, smi))
    del clones
    torch.cuda.empty_cache()

    emit(moe_kernels_edge())
    emit(moe_backward_kernels_edge())
    emit(moe_reference())
    moe_launches, moe_line = moe_serve(smi)
    emit(moe_line)
    batcher_launches, batcher_line = batcher(smi)
    emit(batcher_line)
    moe_kernel_rows = moe_rows(spec, flush)
    emit(block_attn_kernels_edge())
    attn_launches, attn_rows, attn_line = local_attention(spec, flush, smi)
    emit(attn_line)
    for row in moe_kernel_rows + attn_rows:
        emit({"phase": "kernels", "card": smi, **row})
    rows += moe_kernel_rows + attn_rows
    emit(small_reference(QWEN2_ARCH, phase="qwen2_reference"))
    qwen2_launches, qwen2_line = serve(smi, QWEN2_ARCH, phase="qwen2_serve",
                                       autotuned=False)
    emit(qwen2_line)

    hybrid_ref_launches, line = recurrent_reference(HYBRID_ARCH,
                                                    "hybrid_reference")
    emit(line)
    hybrid_launches, hybrid_line = serve(
        smi, HYBRID_ARCH, phase="hybrid_serve", autotuned=False,
        continuation=HYBRID_LONG)
    emit(hybrid_line)
    hb_launches, hb_line = hybrid_batcher(smi)
    emit(hb_line)
    hybrid_rows = hybrid_attention_rows(spec, flush)
    for row in hybrid_rows:
        emit({"phase": "kernels", "card": smi, **row})
    rows += hybrid_rows
    del flush
    _, line = recurrent_reference(SSM_ARCH, "ssm_reference")
    emit(line)
    ssm_launches, ssm_line = serve(smi, SSM_ARCH, phase="ssm_serve",
                                   autotuned=False, continuation=SSM_LONG)
    emit(ssm_line)
    torch.cuda.empty_cache()

    encdec_ref_launches, line = extras_reference(ENCDEC_ARCH,
                                                 "encdec_reference")
    emit(line)
    encdec_launches, encdec_line = serve(smi, ENCDEC_ARCH,
                                         phase="encdec_serve",
                                         autotuned=False)
    emit(encdec_line)
    vlm_ref_launches, line = extras_reference(VLM_ARCH, "vlm_reference")
    emit(line)
    vlm_launches, vlm_line = serve(smi, VLM_ARCH, phase="vlm_serve",
                                   autotuned=False)
    emit(vlm_line)
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    extra_rows = extras_rows(spec, flush)
    del flush
    for row in extra_rows:
        emit({"phase": "kernels", "card": smi, **row})
    rows += extra_rows

    emit(train_families_reference())
    family_launches = {}
    for phase, arch, argv, held in TRAIN_FAMILIES:
        family_launches[phase], line = train_family(smi, phase, arch, argv,
                                                    held=held)
        emit(line)
    family_launches["train_hybrid"], line = train_hybrid(smi)
    emit(line)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    train_moe_rows = moe_train_rows(spec, flush)
    for row in train_moe_rows:
        emit({"phase": "kernels", "card": smi, **row})
    rows += train_moe_rows
    emit({"phase": "chunked_attention", "card": smi,
          "rows": chunked_attention_rows(spec, flush)})
    del flush
    torch.cuda.empty_cache()

    ep_launches = {}
    ep_launches["moe_ep_reference"], line = moe_ep_reference()
    emit(line)
    ep_launches["moe_ep_serve"], line = moe_ep_serve(smi)
    emit(line)
    ep_launches["train_moe_ep"], line = train_moe_ep(smi)
    emit(line)
    ep_launches["qwen3_moe_ep_serve"], line = moe_ep_serve(
        smi, QWEN3_MOE_ARCH, phase="qwen3_moe_ep_serve")
    emit(line)
    emit(train_resume(smi))
    pipe_launches, line = pipeline_phase(smi,
                                         train_line["profile"]["device_ms"])
    emit(line)
    emit(dryrun_phase(smi))
    examples_launches, line = examples_phase(smi)
    emit(line)
    paths, line = moe_ep_cards(smi)
    ep_launches.update(paths)
    emit(line)
    pipe_cards_launches, line = pipeline_cards(smi)
    emit(line)

    # launches: each path's run, counted from 0
    by_path = {**serve_launches, "train": train_launches,
               "partitioned": part_launches,
               "autotune": autotune_launches, **spgemm_launches,
               "gustavson": gustavson_launches,
               "moe_serve": moe_launches, **batcher_launches,
               "local_attention": attn_launches, **qwen2_launches,
               "hybrid_reference": hybrid_ref_launches, **hybrid_launches,
               "hybrid_batcher": hb_launches, **ssm_launches,
               "encdec_reference": encdec_ref_launches, **encdec_launches,
               "vlm_reference": vlm_ref_launches, **vlm_launches,
               **family_launches, **ep_launches,
               "pipeline": pipe_launches, **examples_launches,
               "pipeline_cards": pipe_cards_launches}
    f32 = lambda n: lambda r: r["dtype"] == "float32" and r.get("N") == n
    headline = {"maple_spmm_naive": f32(1), "maple_spmm_compact": f32(1),
                "maple_spmm_planned": f32(1),
                "maple_sddmm_bsr": f32(256),
                **{k: f32(None) for k in SPGEMM_COUNTERS},
                "moe_gemm": f32(None), "moe_gemm_dw": f32(None),
                "block_attention": f32(None)}
    keys = ("shape", "dtype", "G", "N", "bt", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_share", "bound_by", "max_abs_err", "compact_merge_ms",
            "merge_ms", "merge_bound_ms", "runs", "rows")
    summary = []
    for kname, pick in headline.items():
        counts = {p: c[kname] for p, c in by_path.items() if kname in c}
        if not sum(counts.values()):
            raise AssertionError(f"{kname} was never launched on the main "
                                 f"path: {counts}")
        mine = [r for r in rows if r["name"] == kname]
        top = next(r for r in mine if pick(r))
        summary.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": sum(counts.values()),
            "launches_by_path": counts,
            **{k: top[k] for k in keys if k in top and k != "dtype"},
            "shapes": [{k: r[k] for k in keys if k in r} for r in mine]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if "PYTHONHASHSEED" not in os.environ:
        # sparsity.generate seeds its rng with hash() of the clone's name:
        # fix the string hashes so that every run plans the same cage12
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main(sys.argv[1:]))
