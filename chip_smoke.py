#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (the quickest proof
that ``triton_dist_tpu_torch`` still starts, serves and trains on the
card).

Run from the root of a checkout, with one card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero without the final line):

1. device: ``torch.cuda`` name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: every CUDA source of the port compiled with ``nvcc`` for
   ``sm_90a`` (one process per source, in parallel), with each kernel's
   registers / shared memory / spills from ``-Xptxas -v``; a kernel that
   spills fails the run; then the count of wgmma instructions (``HGMMA``
   bf16, ``IGMMA`` int8) in the SASS (``cuobjdump --dump-sass``) of
   ``ring_attn_kernel``, both backward kernels, the forward
   ``flash_fwd_wg_kernel`` (each instance: contiguous and segmented, bf16
   and int8 K/V), the uni AG-GEMM's ``ag_gemm_wg_kernel`` (bf16 with B
   [K][n] and B^T, int8) and its bidir ring's ``ag_gemm_bidir_wg_kernel``,
   the GEMM-RS's ``gemm_rs_wg_kernel`` (bf16 and int8, flat and group;
   int8 on both tiles) and ``gemm_rs_bidir_i8_wg_kernel``, the MoE
   GroupGEMM-RS's ``moe_rs_wg_kernel``, and the persistent GEMMs, and of
   mma.sync instructions (``HMMA``) in each instance of
   ``decode_kernel``, beside their ptxas registers and spill bytes (a
   count of 0 fails the run; without ``cuobjdump`` the line says so);
3. kernels: each Hopper kernel against its plain PyTorch version at the
   main path's shapes (Hq 32, Hkv 8, D 128, bf16), within the stated
   tolerance, then timed (CUDA events around CUDA-graph replays, so host
   launch cost is excluded; the eager per-call time is printed beside)
   next to its bound, the plain version and, where one exists, the one
   PyTorch call that computes the same function
   (``scaled_dot_product_attention``, a yardstick only); the flash
   backward kernels (dq, dkv) at the training shape (B 1, Hq 32, Hkv 8,
   S 2048, D 128, causal) against the plain gradient: for each of dq, dk
   and dv, max |kernel - plain| within 2e-2 of the plain gradient's
   largest magnitude, relative L2 error within 1e-2 over the whole tensor
   and within 2e-2 in every (head, 64-row tile), so a fault confined to
   some rows or tiles shows (the kernels round P and dS to bf16 before
   their products, as the TPU kernels do; the plain version keeps f32),
   beside SDPA's backward as the yardstick; the int8 kernels on quantized
   inputs (``quantize_kv`` of N(0, 1) K/V; random int8 GEMM operands):
   decode_i8 and decode_paged_i8 at the decode shape, flash_fwd_i8 at the
   chunk shape (same tolerances; every decode row's calls each one
   kernel launch by the profiler's count: the split merge runs in the
   launch), matmul_i8 at (m, k, n) = (8, 4096, 14336), (512, 4096,
   14336) and (2048, 3584, 4096) by exact equality
   with its float64 plain version (the split-K loop at m 8, the wgmma
   kernel at the others), ``torch._int_mm`` above m 16 as the yardstick;
   the grouped GEMM's three modes (bf16, dx, int8) at Mixtral-8x7B's
   gate/up shape with a sort_align tile map (int8 also at block_m 512,
   its 256 x 128 tiles): bf16 within 2e-2 of the plain version's largest
   magnitude and 1e-2 relative L2 over the tensor and over each row tile,
   int8 exactly equal, padding tiles exactly zero;
   ``torch._grouped_mm`` as the bf16 yardstick; the bf16 forward and dx
   also at the down projection's shape (K 14336, N 4096) on the same tile
   map; the all-to-all kernel at world 1 at the MoE dispatch's shape
   (send [1, 1, 4096, 4096] bf16) and at a shape with a byte tail,
   exactly equal to its plain version (a copy), one PyTorch copy as the
   yardstick, and over EP ranks (its peer segments) at the EP-4 dispatch
   (send [4, 4, 1024, 4096] bf16, balanced and skewed splits), at [4,
   4, 37, 3] and at Ulysses' two shuffles at Llama-3-8B CP 4 ([4, 4,
   2048, 1536] and [4, 4, 2048, 1024], full splits), equal to its plain
   version on every row it defines (below each split, the own segment
   whole) and on the split counts, timed by
   the profiler's device time, ``transpose(0, 1).contiguous()`` as the
   yardstick;
   the dense GEMM (``csrc/gemm.cu``, on no model path: the reference's
   world-1 paths take XLA's dot) at (M, K, N) = (2048, 4096, 14336),
   torch.matmul as the yardstick; the AG-GEMM and the GEMM-RS over a
   virtual world of TP ranks at every projection shape of Llama-3-8B's
   TP-4 train step, both B layouts (the gathered A bit for bit, the
   products within 2e-2 of the plain version's largest magnitude and 1e-2
   relative L2), timed eagerly between CUDA events (each call carries a
   new epoch, so no CUDA graph), one batched torch.matmul (AG-GEMM) or
   one einsum (GEMM-RS) over the virtual world's ranks as the yardstick;
   the AG-GEMM's int8 mode (``ag_gemm_i8``) at the TP-4 W8A8 forward's
   QKV (n 1536) and gate/up (n 3584) shapes (m_loc 512, K 4096): the
   gathered A bit for bit and the int32 C exactly equal to the plain
   version, ``torch._int_mm`` of the gathered rows against every rank's B
   side by side as the yardstick; row tails at 250 rows per rank (a
   1,000-token prompt at TP 4): the int8 AG-GEMM exactly, the bf16
   AG-GEMM (gate/up) and GEMM-RS (down) by the bf16 GEMM rule;
   the SP combine (``csrc/sp_combine.cu``) over SP ranks at the SP-4
   decode's shape (out [4, 8, 32, 128] f32) and the engine chunk's ([4,
   512, 32, 128]), a dead rank and a row dead on every rank among the
   partials: within 1e-5 of the plain result's largest magnitude, the dead
   row 0, every rank's merge bit for bit the same; timed by the profiler's
   device time, softmax + einsum over the gathered stack as the yardstick;
   checked (not timed) at W 8 ([8, 8, 32, 128]) and with fewer rows than
   ranks ([8, 1, 3, 128]: owners with an empty band);
   the context-parallel rows at Llama-3-8B CP 4 (W 4, S_loc 2048): the
   flash forward and the dq / dkv kernels in their segmented mode (the
   four ranks of one zigzag ring step folded into the batch, per-row block
   starts; f32 gradients), against their plain versions on the same run
   starts, SDPA with the same mask as the yardstick; the fused ring kernel
   ``ring_attn`` contiguous and zigzag against the dense ring (2e-2
   absolute, and relative L2 over the output and each 64-row block), one
   causal
   SDPA call over the gathered 8,192 positions as the yardstick, and ten
   calls in a row on new inputs, each checked;
   the collectives over meshes of an eight-rank virtual world (rows
   10-12): the barrier over tp at (2, 2, 2) and over a flat axis of 8
   (each rank's word back; latency only); the all-gather's ring, bidir
   and full-mesh modes at the PP path's band ([1,024,528, 128] f32 per
   rank, T 2 in four groups), T 4 over (2, 4), T 8 at [4,096, 128] bf16
   and 37 rows, exactly equal to the plain version (a concatenation),
   ``expand(...).contiguous()`` of the gathered view as the yardstick;
   the reduce-scatter's ring and bidir modes at the path's plane
   ([2,049,056, 128] f32 per rank over tp), T 4, T 8 bf16 and 5 and 1
   rows per chunk, bit-equal to the plain version in the reference's ring
   order, one ``sum`` over the rank dimension as the yardstick; each
   timed eagerly between CUDA events and by the profiler's device time;
   then ten bidir calls of each in a row, each checked;
4. generator: Llama-3-8B at full width and all 32 layers, random weights
   from a seed: batch 2, a 512-token prompt, prefill + 32 greedy tokens;
5. engine: ``ServeEngine`` (page 16, 8 slots, 512-token prefill chunks,
   blocks for 8 x 2048 tokens) serving 8 staggered requests of 100..1500
   prompt tokens and 32..64 new tokens; every request must finish, and a
   teacher-forced forward with the plain attention must agree with the
   served tokens at >= 0.98 of positions (bf16 near-ties may flip a few);
   a ninth request samples (temperature 0.8, seed 2**40); then the
   engine's decode step profiled (``decode_profile``: eight rows, wall
   and device-busy ms a decode step, idle share; under 5h also with one
   row sampled, the mixed-sampler program);
5h. horizon engine: phase 5's mix and knobs with ``horizon=8,
   pipeline=2`` after ``warmup()`` (the horizon's CUDA graphs captured
   there: > 0, and serving adds no program signature); every request
   finishes, the served tokens agree with a teacher-forced forward at
   phase 5's floors, the sampled request draws phase 5's tokens, the
   greedy prefix match against phase 5's streams is printed, and tok/s,
   TTFT, ITL and the profiled decode step beside phase 5's;
5p. prefix cache: eight requests sharing one 1,024-token prefix (64
   pages), suffixes of 64..500 tokens, 32 new tokens each, in two waves
   of four (horizon 8, pipeline 2, after warmup); every request finishes,
   tokens agree with a teacher-forced forward at phase 5's floors, wave 2
   maps cached blocks, and no copy-on-write copy runs (admission shares
   only full pages below a prompt's last token); warm and cold TTFT
   printed;
5s. speculative serving: phase 5's mix with its sampled request through
   ``ServeEngine(draft=, draft_params=, spec_k=SPEC_K)`` after
   ``warmup()`` (the fused round's CUDA graphs captured there), three
   ways: (a) the target as its own draft, (b) the reference CLI's draft
   (half width, one layer, seeded) at a fixed k, (c) that draft with the
   adaptive k; every request finishes, the greedy streams agree with a
   teacher-forced forward at phase 5's floors, (a)'s sampled request
   draws the same stream in a second pass of the mix, no program
   signature is added after warmup, and the paged decode kernel's
   launches equal the layers times the verify and decode calls (phase 3
   holds the verify's shape, T 5 with a dead row, to one kernel a call); acceptance, tokens a
   dispatch, the chosen-k histogram, tok/s, TTFT and ITL printed beside
   phase 5's, the sampled stream's agreement with phase 5's with its
   first difference's logit gap; then ``SpeculativeGenerator`` (batch 2,
   512 + 32 tokens, self-draft) through the Generator's multi-token
   verify, its agreement gated alike;
5beam. beam search: ``beam_search_paged`` and ``beam_search``, 4 beams
   over a 1,024-token prompt, 32 new tokens; copy-on-write copies > 0,
   64 shared prompt pages, every block back at the end, the winners
   equal or a near-tie; the paged path's peak KV bytes against the
   contiguous path's;
5b. quantized generator: ``Generator(kv_dtype=torch.int8)`` at 32 layers,
   batch 2, a 512-token prompt through ``prefill_chunked(chunk_size=256)``
   (flash_fwd_i8), then 32 greedy tokens (decode_i8);
5c. quantized engine: phase 5's mix over int8 pools with ``w8a8=True``
   (decode_paged_i8, flash_fwd_i8, matmul_i8); every request finishes,
   the pools read 67,584 bytes per token, and the served tokens agree with
   a teacher-forced forward of the same quantized model whose attention
   and int8 GEMMs are the plain versions, at phase 5's floors; the
   greedy prefix match against phase 5's float streams is printed (int8
   error is real: no gate);
6. train (run last, after the serving state is freed): Llama-3-8B at full
   width, random weights from seed 0, tokens [S 2048, B 1] from a seed:
   (a) 4 plain-SGD steps at all 32 layers (``make_train_step``, lr
   SGD_LR) — finite losses, the last below the first, peak memory
   printed; (b) 3 AdamW steps (``models/training.py``, optax's defaults)
   at 8 layers — the loss falls; (c) at 2 layers, the loss and every
   gradient leaf with the kernels against autograd through the plain
   attention — loss within 1e-3 relative, each leaf within 2e-2 relative
   L2; (d) the launch counters of flash_fwd and both backward kernels,
   zeroed just before (a) and read just after, are each > 0;
7. MoE forward (after the Llama state is freed): Mixtral-8x7B at full
   width cut to MOE_LAYERS layers, random weights from seed 0, tokens
   [S 2048, B 1]: ``models/moe.make_forward`` with the group_gemm and
   all_to_all counters zeroed just before (each > 0 after), a profiled
   forward (device ms and the grouped GEMMs' share), and the MoE
   noise-floor line (a forward with the kernels against one with the
   plain versions: max |d logit|, argmax agreement >= MOE_ARGMAX_MIN, and
   from the experts each layer picked, the tokens whose top-2 expert set
   differs per layer);
7b. MoE EP forward: phase 7's tree sharded over EP ranks of the virtual
   world (``shard_params``: TP attention, expert-parallel FFNs), the
   forward with the all_to_all, group_gemm, ag_gemm and gemm_rs counters
   zeroed just before (each > 0 after), timed and profiled (device ms,
   idle share, the grouped GEMMs', all-to-all's and ring kernels'
   shares); routed as phase 7's forward was, its argmax agrees with the
   world-1 forward's at phase 11's gates (the world-1 forward against its
   plain versions, routed alike, printed beside as the noise floor);
8. MoE generator: ``MoEGenerator`` on the same tree, batch 2, a 512-token
   prompt, 32 greedy tokens; flash_fwd and decode launch; teacher-forced
   agreement against a prompt forward with the plain attention
   (near-ties within MOE_NEAR_TIE);
9. MoE layer: ``DistributedMoELayer`` (E 8, H 4096, F 14336, top-2) at T
   2048 and T 8, bf16 and after ``quantize_weights()``, each against the
   same layer with the plain grouped GEMM (bf16 within the grouped-GEMM
   tolerances, W8A8 equal), the W8A8 output against the float one within
   the reference's tolerance (median relative error < 0.05, cosine >
   0.995); the same weights over EP ranks at T 2048, bf16 and W8A8, held
   to their plain versions alike; group_gemm_i8 launches;
10. MoE train: MOE_SGD_STEPS in-place SGD steps at MOE_TRAIN_LAYERS layers
   (finite, falling losses; peak memory; group_gemm and group_gemm_dx
   launch; a profiled step), then at 2 layers the loss and every gradient
   leaf with the kernels against the plain versions, both routed alike
   (1e-3, 2e-2);
10b. MoE EP train: phase 10 over EP ranks (the ring kernels' counters
   too; the steps' launches read into the all_to_all row);
11. TP forward: Llama-3-8B at full width and 32 layers, random weights
   from seed 0, the world-1 forward (and, as the noise floor, the same
   with the plain attention), then ``shard_params`` to TP ranks and the
   TP forward through ``make_forward(cfg, TP)`` with the ring and GEMM
   counters zeroed just before (each > 0 after), timed and profiled; its
   argmax agrees with the world-1 forward's at >= 0.98 of the 2048
   positions counting ties within 0.125, >= 0.90 exact;
12. TP train: (a) TP_SGD_STEPS in-place SGD steps at 32 layers, the
   counters zeroed again (finite, falling losses; peak memory; a profiled
   step); (b) at 2 layers the loss and every gradient leaf with the
   kernels against the plain versions of every kernel (1e-3, 2e-2);
13. SP generator (run after 5c, on phase 4's weights): ``Generator(mesh=
   World(SP), max_seq=8192)``, batch 2, a 7,000-token prompt through
   ``prefill_chunked`` at 512, then 32 greedy tokens; the world-1
   Generator on the same prompt, teacher-forced on the SP tokens, agrees
   at the dense gates; decode ms per step of both;
14. SP engine: ``ServeEngine(mesh=World(SP), kv_shard="seq")`` with phase
   5's knobs at max_seq 8192 and 4,096 blocks: 8 requests of 300..7000
   prompt tokens (two past 6,144) and 32..64 new tokens; every request
   finishes and every partition holds pages; the served tokens agree with
   a world-1 teacher-forced forward at the dense gates; the world-1
   engine serves the same mix once beside (tok/s, TTFT, ITL, step time
   of both);
15. W8A8 TP forward (after 14, on phase 4's weights): ``quantize_params_
   w8a8`` for TP ranks, ``place_w8a8_params``, ``make_w8a8_forward(cfg,
   TP)`` at 32 layers on tokens [S 2048, B 1] (every column projection
   through the int8 AG-GEMM, every row projection matmul_i8 per rank and
   an f32 sum over the ranks), timed and profiled (the int8 AG-GEMM's
   device share); its logits against the float world-1 forward (cosine
   > 0.995) and its argmax against the same forward over the plain
   versions at the W8A8 floors; once more at a ragged S 1,000 (250 rows
   per rank); the first W8A8_GATE_LAYERS layers at both W8A8 gates
   (median relative error < 0.05, cosine > 0.995);
16. heads engine: phase 5's mix and knobs through ``ServeEngine(mesh=
   World(TP), kv_shard="heads")``, float then ``w8a8=True``, each beside
   the world-1 engine on the same mix (tok/s, TTFT, ITL); every request
   finishes, and the served tokens agree with a world-1 teacher-forced
   forward: the float run with the flash prompt forward at the dense
   gates, the W8A8 run with the world-1 W8A8 model's forward at the W8A8
   floors; the greedy prefix match against the world-1 engine printed;
17. CP forward (after 16, on phase 4's weights): Llama-3-8B, 32 layers,
   tokens [8192, 1] (``max_position_embeddings``), the world-1 forward
   at the same S (its noise floor: the same with the plain attention),
   then ``make_cp_forward(cfg, CP)`` over CP ranks three ways: the ring
   under ``impl="auto"`` (the zigzag flash ring through the flash
   kernels' segmented mode), ``impl="fused"`` (contiguous, through
   ``ring_attn``) and Ulysses; each timed and profiled (device busy,
   attention's share, the ring rotation's or the all-to-all's), its
   argmax against the world-1 forward's at the dense gates;
18. CP train (after 6, on its own tree): CP_SGD_STEPS SGD steps at 32
   layers and S 8192 through ``make_cp_train_step(impl="auto",
   remat=True)`` (finite, falling losses; step ms, trained tok/s, peak;
   a profiled step), one Ulysses step at 32 layers, at 2 layers and S
   4,096 the loss and every gradient leaf of each scheme against the same
   scheme over the plain versions (1e-3, 2e-2 relative L2), the peak of a
   2-layer gradient at S 8192 without and with remat, and one fused-ring
   step at 2 layers and S 8192;
19. PP train (last, on its own tree): ``LlamaConfig.mistral_7b()`` at
   PP_LAYERS layers on a dcn 2 x pp 2 x tp 2 mesh of the virtual world,
   tokens [S 2048, B 4] (S over tp, B over dcn, 2 microbatches), remat,
   ``hier_dp_fast_axis="tp"``: (a) PP_STEPS SGD steps (finite, falling
   losses; step ms, trained tok/s, peak memory; one reduce-scatter in its
   bidir mode and one all-gather in its full-mesh mode per step; a
   profiled step: device busy, idle share, the collectives', ring
   kernels' and flash kernels' shares); (b) the same first two steps with
   the plain psum (losses 1e-3 relative, every updated leaf 2e-2
   relative L2); (c) at 2 layers the PP gradients against the port's
   non-PP TP-2 step over the same batch and against the PP step over the
   plain versions (1e-3; 2e-2 relative L2 per leaf);
20. ring GEMM entries and modes (last): the host entries ``ag_gemm_
   gathered`` / ``gemm_rs`` with contexts on a ``Mesh`` of TP ranks at
   Llama-3-8B TP-4 widths, at m_loc 512 (S 2,048) and 16 (decode): the
   AG-GEMM at QKV and gate/up in its bidir, int8-wire and chunked (2, 4)
   modes, the GEMM-RS at wo and down in its bidir mode and on int8
   operands in its uni and bidir modes (rows 15i, 15bi; these two also
   at a ragged m_loc 250), then
   ``ag_gemm_autotuned`` (gate/up) and ``gemm_rs_autotuned`` (down, bf16
   and int8) in one ``contextual_autotune`` region (every config's time
   and the winner printed; the int8 sweep must time the bidir config); each result against its plain version (the gathered
   A bit for bit, bf16 products within 2e-2 of the plain version's
   largest magnitude and 1e-2 relative L2 over the tensor and each
   128-row tile, int8 exactly), each mode timed eagerly between CUDA
   events beside its bound, its plain version and one PyTorch call of
   the same function where one exists;
21. MoE overlap kernels (last): the host entries ``ag_group_gemm`` /
   ``moe_reduce_rs`` with contexts on a ``Mesh`` of TP ranks at
   Mixtral-8x7B's expert widths (D 4096, F 14336, F_loc 3584, E 8,
   top-2, bf16, seed 0), at a 2,048-token prefill (the load-aware
   block_m 512: m_pad 5,120 a segment; and block_m 128: 2,048) and a
   32-token decode (block_m 128: m_pad 1,152), each under balanced,
   skewed (most assignments on two experts) and one-empty-expert
   routing; then ``ag_group_gemm_autotuned`` and
   ``moe_reduce_rs_autotuned`` in one ``contextual_autotune`` region
   (every config's time and the winner printed) and the host planner
   ``host_ops.moe_ag_scatter_align_block_size(impl="native")`` equal to
   numpy; each host entry against its plain version, each kernel's
   wrapper against its plain version (the gathered sorted x bit for
   bit, the grouped outputs within 2e-2 of the plain version's largest
   magnitude and 1e-2 relative L2 over the tensor and each 128-row tile,
   padding rows exactly zero, ten calls in a row each equal to the
   first), each kernel timed eagerly between CUDA events beside its
   bounds (useful work 2 T topk D F, the padded work it does, bytes),
   its plain version and one ``torch._grouped_mm`` of the same product;
22. torus (multi-axis) schedules (last): the host entries ``all_gather``,
   ``reduce_scatter``, ``ag_gemm_gathered`` / ``ag_gemm`` and ``gemm_rs``
   with a tuple axis (all of the mesh's axes) on the (2, 4), (4, 2) and
   (2, 2, 2) meshes of eight ranks at Llama-3-8B TP-8 widths (a 2,048-token
   prefill: 256 rows a rank; gate/up N 14336, QKV N 6144, down K 14336, wo
   K 4096; bf16 and int8), then the autotuned entries; each against its
   plain version, each of the six kernels (torus all-gather and
   reduce-scatter, the torus AG-GEMM and GEMM-RS and their int8 modes)
   against its plain version on every mesh (the gathers and the
   reduce-scatter bit for bit, in f32 and bf16; the GEMMs by the 128-row
   tile rule; int8 exactly), ten calls in a row equal, and timed on the
   (2, 4) mesh beside its bound, its plain version and one PyTorch call;
   the int8 GEMM-RS also at a ragged m_loc (250) on every mesh, exactly.

The launch counters of the three serving kernels are zeroed just before
phase 4 and read just after phase 5: each must be > 0; flash_fwd's and
decode_paged's are zeroed again before phases 5h and 5p and read after
each (> 0; under "serve_launches": a replay of a captured horizon adds
the launches its capture recorded); every counter is
zeroed again just before phase 5b and read just after 5c, where the four
int8 kernels must each be > 0; the backward kernels' counts in the
``kernels`` line come from phase 6 (a), the grouped GEMM's from phases 7
(bf16), 9 (int8) and 10 (dx), the all-to-all's from phase 7 (its
phase-7b and 10b counts beside under "ep4_forward_launches" and
"ep4_train_launches"), the ring
kernels' from phase 12 (a), their phase-11 counts beside under
"forward_launches"; the dense GEMM's counter is zeroed and read with
theirs and reads 0 (no model path calls it).  Every counter is zeroed
again just before phase 13 and read just after phase 14: the combine's
count comes from there (> 0 in each phase), and flash_fwd's, decode's and
decode_paged's ride beside under "sp_launches".  Phase 15 zeroes the int8
AG-GEMM's, matmul_i8's and flash_fwd's counters just before its forward
and reads them just after: the int8 AG-GEMM's count comes from there
(matmul_i8's and flash_fwd's beside under "w8a8_tp_launches"); phase 16
zeroes flash_fwd's, decode_paged's and matmul_i8's before each engine run
and reads them after it ("heads_launches", each > 0 in its heads run).
Phases 17 and 18 zero the CP counters (flash_fwd's launches, the flash
kernels' segmented ones, ``ring_attn``'s and the all-to-all's) before
each forward or step and read them after it: the segmented flash
forward's count in the ``kernels`` line comes from phase 17's flash ring,
``ring_attn``'s from its fused forward, the segmented backward kernels'
from phase 18 (a); every scheme's counts ride beside under "cp_launches"
(flash_fwd's and the all-to-all's too).  Phase 19 zeroes the
collectives' mode counters, the barrier's and the ring and flash
kernels' counters just before its SGD steps and reads them just after: the all-gather's and the
reduce-scatter's rows take their counts from there (the full-mesh
all-gather and the bidir reduce-scatter > 0, the other modes 0: no path
takes them at T 2), the barrier's is read there too and must be 0 (no model path calls
it), and the
ring and flash kernels' ride beside under "pp_launches".  The ring
modes' counters (13b, 13w, 13c, 15b, 15i, 15bi) are zeroed before phases 11,
12 (a), 15 and 19 and read after them, where each must be 0 (no model
path passes a mode: "model_path_launches"), and zeroed just before
phase 20 and read just after its autotuned region: each row's count
comes from there (> 0).  The
counters of the two MoE overlap kernels (rows 19, 20) are zeroed with
the ring modes' before phases 7, 7b, 11, 12 (a), 15 and 19 and read after
them, where each must be 0, and zeroed just before phase 21 and read just
after it: their counts come from there (> 0).  The six torus kernels'
counters are never zeroed before phase 22: they are read after every
model path above (0) and at the start of phase 22 (0: no earlier phase
took a torus schedule), zeroed just before its path and read just after
its autotuned region (each > 0).  A
noise-floor line compares one prompt forward with the flash kernel
against the plain attention (what bf16 rounding alone moves the logits
by).  A ``ratio`` line per kernel row (each layout of ``ring_attn``)
gives its time over its library call's from the same run; the
``kernels`` JSON line, the ``nvidia-smi`` line and the result line close
the output.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

OUT_TOL = 2e-2   # bf16 outputs; kernels round P to bf16 before P @ V
LSE_TOL = 1e-3   # f32 log-sum-exp on both sides
# Teacher-forced agreement.  With random weights the 128256-way argmax has
# a small top-2 logit gap (the noise-floor line prints its median, ~0.15
# at logit std ~1), while two bf16 computations of the same forward that
# differ in any rounding (kernel vs plain attention, a decode step vs a
# full forward) land up to ~0.12 apart after 32 layers (printed on the
# same line); such near-ties flip a few percent of positions whatever the
# attention kernel.  So the 0.98 floor counts a mismatch within NEAR_TIE
# of the reference maximum as a tie, and the exact agreement over the
# engine's ~400 positions must still reach STRICT_MIN.  A wrong token is
# typically several logits below the maximum.
AGREE_MIN = 0.98
NEAR_TIE = 0.125
STRICT_MIN = 0.90
# The W8A8 model amplifies such rounding: each projection re-quantizes its
# input rows to int8, so an input that moves by one bf16 step flips the
# rounding of some of its 4096..14336 values by a whole int8 step.  One
# prompt forward of the quantized model with the kernels and with the
# plain versions (the quantized noise-floor line) lands up to ~0.46 apart
# and picks another argmax at ~19% of positions (NVIDIA H100 80GB HBM3,
# 700 W); near-ties therefore reach QUANT_NEAR_TIE there, and the exact
# floor is QUANT_STRICT_MIN.  A wrong kernel is several logits off, and
# every kernel is also held to its plain version directly (phase 3).
QUANT_NEAR_TIE = 0.5
QUANT_STRICT_MIN = 0.75
# flash backward, kernel against plain gradient (P and dS rounded to bf16
# give ~4e-3 relative L2): max |err| / max |plain|; ||err|| / ||plain||
# over the tensor; the same over each (head, 64-row tile)
BWD_REL_TOL = 2e-2
BWD_L2_TOL = 1e-2
BWD_TILE_L2_TOL = 2e-2
# ring_attn returns no lse, and at Llama-3-8B CP 4 a row that sees n keys
# has |out| ~ 0.8 sqrt(e / n) (~0.02 at the median row), so OUT_TOL alone
# would pass a kernel that dropped a live key tile.  Its output is also
# held to ||err|| / ||plain|| over the tensor and over each (rank, batch,
# head, 64-row block): a kernel that rounds P to bf16 reads ~2e-3 on both,
# one dropped 64-key tile of one q tile ~0.16 on its block.
RING_L2_TOL = 1e-2
RING_TILE_L2_TOL = 2e-2
SAMPLED_REQ = "s-2**40"  # phases 5, 5h and 5s: one sampled request
SPEC_K = 4          # phase 5s: draft tokens a round
SGD_LR = 0.2        # phase 6 (a): big enough that bf16 updates survive
MOE_LAYERS = 16       # phases 7-8: 46.97 GB of Mixtral-8x7B weights
MOE_TRAIN_LAYERS = 8  # phase 10 (a): parameters and gradients, 2 x 23.75 GB
MOE_SGD_LR = 0.2
MOE_SGD_STEPS = 3
# MoE gates (PERF.md Findings).  Routing amplifies bf16 rounding: a token
# whose second and third router probabilities nearly tie takes another
# expert when its hidden state moves by one rounding, and its FFN output
# then moves by O(1).  One 16-layer forward with the kernels and with the
# plain versions swapped the top-2 set of 4 tokens (of 2048) at the first
# layer and 185 at the sixteenth, landing up to 3.81 logits apart with
# 0.86 argmax agreement (NVIDIA H100 80GB HBM3, 700 W): MOE_ARGMAX_MIN
# floors that agreement.  The generator's check differs only in its
# attention (its FFNs are torch.matmul on both sides): its 64 teacher-
# forced positions flipped 11 greedy tokens, the largest 1.27 logits below
# the reference maximum (same card), so a mismatch within MOE_NEAR_TIE
# counts as a tie, and exact agreement is floored at MOE_STRICT_MIN, below
# the measured 0.83 and far above what a wrong kernel gives (a random
# token of 32000).  Each kernel is also held to its plain version directly
# (phase 3).
MOE_ARGMAX_MIN = 0.6
MOE_NEAR_TIE = 1.5
MOE_STRICT_MIN = 0.6
# Phase 7b holds the EP-4 forward, routed as the world-1 forward was, to the
# world-1 argmax at the dense gates (AGREE_MIN with ties within NEAR_TIE,
# STRICT_MIN exact): with routing pinned, only bf16 rounding (the TP
# attention's GEMM-RS partials) separates the two, and the world-1 forward
# against its own plain versions, pinned alike, agreed at 0.9634 exact and
# 1.0 with ties (EP 4: 0.9653 and 1.0; NVIDIA H100 80GB HBM3, 700 W).
ADAMW_LR = 1e-4     # phase 6 (b)
TRAIN_SEQ = 2048
# grouped GEMM, kernel against plain version (both round the f32 sums to
# bf16 once): max |err| / max |plain|; ||err|| / ||plain|| over the
# tensor and over each row tile
GG_REL_TOL = 2e-2
GG_L2_TOL = 1e-2
TP = 4              # phases 11-12: ranks of the virtual world
EP = 4              # phases 7b, 9, 10b: ranks of the virtual world
SP = 4              # phases 13-14: ranks of the virtual world
SP_MAX_SEQ = 8192   # Llama-3-8B's published context (max_position_embeddings)
SP_COMBINE_TOL = 1e-5   # sp_combine vs plain, relative to the largest value
TP_SGD_LR = 0.2
TP_SGD_STEPS = 3
CP = 4              # phases 17-18 and the CP kernel rows: virtual world ranks
CP_SEQ = 8192       # Llama-3-8B's max_position_embeddings: 2,048 per rank
CP_GRAD_SEQ = 4096  # phase 18 (c): the plain versions hold S x S f32 scores
CP_SGD_STEPS = 3
# Phase 19: Mistral-7B (vocab 32,000: the hierarchical step's f32 plane of
# the tp-replicated gradients is 1.05 GB a rank, 8.4 GB for eight) on dcn 2
# x pp 2 x tp 2; PERF.md holds the memory reckoning
PP_LAYERS = 32
PP_SEQ = 2048
PP_BATCH = 4
PP_STEPS = 3
# Phase 15 holds the W8A8 TP forward to the float forward at the W8A8
# gates (median relative error < 0.05, cosine > 0.995).  W8A8 error grows
# with depth (each projection re-quantizes its rows): at 32 layers the
# cosine read 0.9973 and the median relative error 0.0719 (NVIDIA H100
# 80GB HBM3, 700 W; the CPU tests hold the port to the reference's W8A8
# forward), so the 32-layer logits are gated on the cosine, and both gates
# hold the first W8A8_GATE_LAYERS layers of the same weights.
W8A8_GATE_LAYERS = 2
HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS_S = 989e12      # H100 SXM dense bf16 tensor-core peak
INT8_OPS_S = 1979e12       # H100 SXM dense int8 tensor-core peak
KV_BYTES_PER_TOKEN_I8 = 2 * 32 * 8 * (128 + 4)   # Llama-3-8B int8 pools


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, reps=5):
    """Device time of one ``fn()`` call: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events after a
    warm-up, so the host's launch cost between calls does not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def call_ms(fn, iters=50):
    """Eager time per call, back to back: the larger of the device time
    and the host's cost of issuing the call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(n_bytes, n_ops, ops_s=BF16_FLOPS_S):
    t_b = n_bytes / HBM_BYTES_S * 1e3
    t_f = n_ops / ops_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def grad_errors(got, want, tile=64):
    """(max |err|, max |want|, ||err|| / ||want||, worst ||err|| / ||want||
    over each (batch, head, ``tile``-row block)) of a gradient laid out
    [B, H, S, D].  A block whose plain gradient is zero counts its error
    against the smallest positive float, so it must be zero too."""
    import torch

    err = got.float() - want.float()
    want = want.float()
    B, H, S, D = want.shape
    pad = -S % tile
    blocks = [torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
        B, H, (S + pad) // tile, tile * D).norm(dim=-1) for x in (err, want)]
    tiny = torch.finfo(torch.float32).tiny
    return (err.abs().max().item(), want.abs().max().item(),
            (err.norm() / want.norm().clamp_min(tiny)).item(),
            (blocks[0] / blocks[1].clamp_min(tiny)).max().item())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    Hq, Hkv, D = 32, 8, 128
    G = Hq // Hkv
    rows = {}

    # -- flash_fwd: the engine's 512-row chunk at q_offset 1536 against
    #    extent 2048, and a 1024-token causal prompt
    flash_cases = [("chunk512@1536", 512, 2048, 1536),
                   ("prompt1024", 1024, 1024, 0)]
    errs, main = [], None
    for tag, Sq, Sk, off in flash_cases:
        q, k, v = randn(1, Hq, Sq, D), randn(1, Hkv, Sk, D), randn(1, Hkv,
                                                                    Sk, D)
        out, lse = fa.flash_attention(q, k, v, q_offset=off,
                                      return_lse=True)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_ref(q, k, v, q_offset=off)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        log(f"flash_fwd {tag}: max|out-plain| {e_out:.3e} (tol {OUT_TOL}),"
            f" max|lse-plain| {e_lse:.3e} (tol {LSE_TOL})")
        if not (e_out <= OUT_TOL and e_lse <= LSE_TOL):
            raise AssertionError(f"flash_fwd {tag} disagrees with plain")
        errs.append(e_out)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, q_offset=off))
        eager = call_ms(lambda: fa.flash_attention(q, k, v, q_offset=off))
        plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                          q_offset=off),
                           iters=5)
        qpos = off + torch.arange(Sq, device=dev)[:, None]
        kpos = torch.arange(Sk, device=dev)[None, :]
        mask = qpos >= kpos
        if off == 0 and Sq == Sk:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        else:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True))
        visible = int(mask.sum())
        n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
            + Sq * Hq * 4
        n_flops = 4 * Hq * D * visible
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        log(f"flash_fwd {tag}: kernel {ms:.4f} ms (eager call {eager:.4f}"
            f" ms), plain {plain_ms:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib)
    rows["flash_fwd"] = dict(main, max_abs_err=max(errs))

    # -- decode: B 8, S 2048 with ragged lens; T 4 with a dead row
    B, S = 8, 2048
    k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    lens = torch.tensor([2048, 1999, 1500, 1024, 1800, 777, 2047, 1300],
                        dtype=torch.int32, device=dev)
    errs, main = [], None
    for tag, T, q_lens in (("T1", 1, None), ("T4", 4, [4, 3, 0, 4, 1, 4, 2,
                                                        4])):
        q = randn(B, Hq, D) if T == 1 else randn(B, T, Hq, D)
        ql = (None if q_lens is None else
              torch.tensor(q_lens, dtype=torch.int32, device=dev))
        out, lse = fd.gqa_decode_shard(q, k, v, lens, q_lens=ql)
        torch.cuda.synchronize()
        ref_out, ref_lse = fd.decode_ref(q, k, v, lens, q_lens=ql)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        log(f"decode {tag}: max|out-plain| {e_out:.3e}, max|lse-plain| "
            f"{e_lse:.3e}")
        if not (e_out <= OUT_TOL and e_lse <= LSE_TOL):
            raise AssertionError(f"decode {tag} disagrees with plain")
        if q_lens is not None:
            dead = q_lens.index(0)
            if not (torch.all(out[dead] == 0) and torch.all(lse[dead]
                                                            <= -1e29)):
                raise AssertionError("decode: dead row not zero / NEG_INF")
        errs.append(e_out)
        one_kernel_per_call(f"decode {tag}", lambda: fd.gqa_decode_shard(
            q, k, v, lens, q_lens=ql), lens_packing(lens, ql, T))
        if T == 1:
            ms = time_ms(lambda: fd.gqa_decode_shard(q, k, v, lens))
            eager = call_ms(lambda: fd.gqa_decode_shard(q, k, v, lens))
            plain_ms = time_ms(lambda: fd.decode_ref(q, k, v, lens),
                               iters=5)
            pos_ok = (torch.arange(S, device=dev)[None, :]
                      < lens[:, None])[:, None, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=pos_ok, enable_gqa=True))
            n_kv = int(lens.sum())
            n_bytes = 2 * n_kv * Hkv * D * 2 + q.numel() * 2 \
                + B * Hq * (D + 1) * 4
            b_ms, b_by = bound_ms(n_bytes, 4 * n_kv * Hq * D)
            log(f"decode {tag}: kernel {ms:.4f} ms (eager call {eager:.4f} "
                f"ms), plain {plain_ms:.4f} ms, sdpa {lib:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib)
    rows["decode"] = dict(main, max_abs_err=max(errs))

    # -- decode_paged: page 16, shuffled non-contiguous tables, the null
    #    block 0 past each length
    page, n_pages = 16, S // 16
    need = [-(-int(n) // page) for n in lens.tolist()]
    n_blocks = 1 + sum(need) + 64
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    table = torch.zeros((B, n_pages), dtype=torch.int32, device=dev)
    at = 0
    for b in range(B):
        table[b, :need[b]] = perm[at:at + need[b]].to(torch.int32)
        at += need[b]
    k_pool = randn(n_blocks, Hkv, page, D)
    v_pool = randn(n_blocks, Hkv, page, D)
    errs = []
    # T5: phase 5s's verify at k 4 (every row k + 1 live queries, one
    # dead row)
    for tag, T, q_lens in (("T1", 1, None),
                           ("T4", 4, [4, 0, 2, 4, 4, 1, 3, 4]),
                           ("T5 verify", 5, [5] * (B - 1) + [0])):
        q = randn(B, Hq, D) if T == 1 else randn(B, T, Hq, D)
        ql = (None if q_lens is None else
              torch.tensor(q_lens, dtype=torch.int32, device=dev))
        out, lse = fd.gqa_decode_paged_shard(q, k_pool, v_pool, table, lens,
                                             q_lens=ql)
        torch.cuda.synchronize()
        ref_out, ref_lse = fd.decode_paged_ref(q, k_pool, v_pool, table,
                                               lens, q_lens=ql)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        log(f"decode_paged {tag}: max|out-plain| {e_out:.3e}, "
            f"max|lse-plain| {e_lse:.3e}")
        if not (e_out <= OUT_TOL and e_lse <= LSE_TOL):
            raise AssertionError(f"decode_paged {tag} disagrees with plain")
        errs.append(e_out)
        one_kernel_per_call(f"decode_paged {tag}",
                            lambda: fd.gqa_decode_paged_shard(
                                q, k_pool, v_pool, table, lens, q_lens=ql),
                            lens_packing(lens, ql, T))
        if T == 1:
            ms = time_ms(lambda: fd.gqa_decode_paged_shard(
                q, k_pool, v_pool, table, lens))
            eager = call_ms(lambda: fd.gqa_decode_paged_shard(
                q, k_pool, v_pool, table, lens))
            plain_ms = time_ms(lambda: fd.decode_paged_ref(
                q, k_pool, v_pool, table, lens), iters=5)
            n_kv = int(lens.sum())
            n_bytes = 2 * n_kv * Hkv * D * 2 + q.numel() * 2 \
                + sum(need) * 4 + B * Hq * (D + 1) * 4
            b_ms, b_by = bound_ms(n_bytes, 4 * n_kv * Hq * D)
            log(f"decode_paged {tag}: kernel {ms:.4f} ms (eager call "
                f"{eager:.4f} ms), plain {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}); no single PyTorch call computes "
                f"paged attention")
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    rows["decode_paged"] = dict(main, max_abs_err=max(errs))
    rows.update(i8_attention_rows(dev, randn, k, v, lens, k_pool, v_pool,
                                  table))
    rows["matmul_i8"] = matmul_i8_row(dev, g)
    rows.update(bwd_kernel_rows(dev, randn))
    rows.update(group_gemm_rows(dev, g))
    rows["all_to_all"] = all_to_all_row(dev, g)
    rows["matmul"] = matmul_row(dev, g)
    rows.update(ring_rows(dev, g))
    rows["sp_combine"] = sp_combine_row(dev, g)
    rows.update(cp_kernel_rows(dev, g))
    rows.update(collective_rows(dev, g))
    return rows


def check_attention(tag, out, lse, ref_out, ref_lse):
    e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
    log(f"{tag}: max|out-plain| {e_out:.3e} (tol {OUT_TOL}), max|lse-plain|"
        f" {e_lse:.3e} (tol {LSE_TOL})")
    if not (e_out <= OUT_TOL and e_lse <= LSE_TOL):
        raise AssertionError(f"{tag} disagrees with plain")
    return e_out


def i8_attention_rows(dev, randn, k, v, lens, k_pool, v_pool, table):
    """decode_i8 / decode_paged_i8 at the decode shape (the bf16 rows'
    K/V, quantized) and flash_fwd_i8 at the chunk shape, each against its
    plain version on the same int8 inputs, then timed.  No single
    PyTorch call dequantizes inside attention: library_ms is null."""
    import torch

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd

    Hq, D = 32, 128
    B, Hkv = k.shape[0], k.shape[1]
    rows = {}
    n_kv = int(lens.sum())
    io_bytes = B * Hq * D * 2 + B * Hq * (D + 1) * 4   # q in, out + lse
    kv_bytes = 2 * n_kv * Hkv * (D + 4)                 # int8 rows + scales
    kq, ks = fd.quantize_kv(k.float())
    vq, vs = fd.quantize_kv(v.float())
    kpq, kps = fd.quantize_kv(k_pool.float())
    vpq, vps = fd.quantize_kv(v_pool.float())
    cases = {
        "decode_i8": (lambda q, **kw: fd.gqa_decode_shard(
            q, kq, vq, lens, k_scale=ks, v_scale=vs, **kw),
            lambda q, **kw: fd.decode_ref(q, kq, vq, lens, k_scale=ks,
                                          v_scale=vs, **kw), 0),
        "decode_paged_i8": (lambda q, **kw: fd.gqa_decode_paged_shard(
            q, kpq, vpq, table, lens, k_scale=kps, v_scale=vps, **kw),
            lambda q, **kw: fd.decode_paged_ref(
                q, kpq, vpq, table, lens, k_scale=kps, v_scale=vps, **kw),
            int((table != 0).sum()) * 4),
    }
    for name, (kern, plain, table_bytes) in cases.items():
        errs = []
        for tag, T, q_lens in (("T1", 1, None),
                               ("T4", 4, [4, 3, 0, 4, 1, 4, 2, 4])):
            q = randn(B, Hq, D) if T == 1 else randn(B, T, Hq, D)
            ql = (None if q_lens is None else
                  torch.tensor(q_lens, dtype=torch.int32, device=dev))
            out, lse = kern(q, q_lens=ql)
            torch.cuda.synchronize()
            ref_out, ref_lse = plain(q, q_lens=ql)
            errs.append(check_attention(f"{name} {tag}", out, lse, ref_out,
                                        ref_lse))
            if q_lens is not None:
                dead = q_lens.index(0)
                if not (torch.all(out[dead] == 0)
                        and torch.all(lse[dead] <= -1e29)):
                    raise AssertionError(f"{name}: dead row not zero")
            one_kernel_per_call(f"{name} {tag}",
                                lambda: kern(q, q_lens=ql),
                                lens_packing(lens, ql, T))
            if T == 1:
                ms = time_ms(lambda: kern(q))
                eager = call_ms(lambda: kern(q))
                plain_ms = time_ms(lambda: plain(q), iters=5)
                b_ms, b_by = bound_ms(kv_bytes + io_bytes + table_bytes,
                                      4 * n_kv * Hq * D)
                log(f"{name} {tag}: kernel {ms:.4f} ms (eager call "
                    f"{eager:.4f} ms), plain {plain_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}, {kv_bytes / 1e6:.2f} MB of "
                    f"int8 K/V and scales); no single PyTorch call "
                    f"dequantizes inside attention")
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)
        rows[name] = dict(main, max_abs_err=max(errs))

    # flash_fwd_i8: the engine's 512-row chunk at q_offset 1536, extent 2048
    Sq, Sk, off = 512, 2048, 1536
    q = randn(1, Hq, Sq, D)
    fk, fks = fd.quantize_kv(randn(1, Hkv, Sk, D).float())
    fv, fvs = fd.quantize_kv(randn(1, Hkv, Sk, D).float())
    kw = dict(q_offset=off, k_scale=fks, v_scale=fvs)
    out, lse = fa.flash_attention(q, fk, fv, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_ref(q, fk, fv, **kw)
    err = check_attention("flash_fwd_i8 chunk512@1536", out, lse, ref_out,
                          ref_lse)
    ms = time_ms(lambda: fa.flash_attention(q, fk, fv, **kw))
    eager = call_ms(lambda: fa.flash_attention(q, fk, fv, **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, fk, fv, **kw),
                       iters=5)
    visible = int((off + torch.arange(Sq, device=dev)[:, None]
                   >= torch.arange(Sk, device=dev)[None, :]).sum())
    n_bytes = 2 * q.numel() * 2 + 2 * Hkv * Sk * (D + 4) + Sq * Hq * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * Hq * D * visible)
    log(f"flash_fwd_i8 chunk512@1536: kernel {ms:.4f} ms (eager call "
        f"{eager:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); no single PyTorch call dequantizes inside attention")
    rows["flash_fwd_i8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None,
                                max_abs_err=err)
    return rows


def matmul_i8_row(dev, g):
    """matmul_i8 at the gate/up projection's decode width (m 8, the split-K
    tile loop), at a 512-row prefill chunk (k 4096, n 14336) and at the
    W8A8 TP-4 row side's down projection (m 2048, k 3584, n 4096), both
    on the persistent wgmma kernel: exact equality with the plain version
    (float64, exact), then timed beside its bound and, above m 16,
    ``torch._int_mm`` (cuBLASLt; it takes no m <= 16).  The row reports m
    512; the others ride along under "m8" and "tp_down", each with the
    kernel ``matmul_i8_kernel_for`` chose."""
    import torch

    from triton_dist_tpu_torch.kernels import quant

    out = {}
    for tag, m, k, n in (("m8", 8, 4096, 14336), ("m512", 512, 4096, 14336),
                         ("tp_down", 2048, 3584, 4096)):
        b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        kind = quant.matmul_i8_kernel_for(m, n, k)
        got = quant.matmul_i8(a, b)
        torch.cuda.synchronize()
        want = quant.matmul_i8_ref(a, b)
        exact = torch.equal(got, want)
        err = (got.double() - want.double()).abs().max().item()
        log(f"matmul_i8 {tag} ({m}, {k}, {n}; {kind}): exact {exact}, "
            f"max|kernel-plain| {err:.1f}")
        if not exact:
            raise AssertionError(f"matmul_i8 {tag} is not exact")
        ms = time_ms(lambda: quant.matmul_i8(a, b))
        eager = call_ms(lambda: quant.matmul_i8(a, b))
        plain_ms = time_ms(lambda: quant.matmul_i8_ref(a, b), iters=3)
        lib, why = None, "cuBLASLt's int8 product takes no m <= 16"
        if m > 16:
            # cuBLASLt's int8 path wants B column-major: time both layouts
            # of the same B, keep the faster
            b_cm = b.t().contiguous().t()
            same = all(torch.equal(torch._int_mm(a, x), want)
                       for x in (b, b_cm))
            t_rm = time_ms(lambda: torch._int_mm(a, b))
            t_cm = time_ms(lambda: torch._int_mm(a, b_cm))
            lib = min(t_rm, t_cm)
            why = (f"torch._int_mm, B row-major {t_rm:.4f} ms, "
                   f"column-major {t_cm:.4f} ms; equal to the plain version:"
                   f" {same}")
        b_ms, b_by = bound_ms(m * k + k * n + m * n * 4, 2 * m * n * k,
                              INT8_OPS_S)
        log(f"matmul_i8 {tag}: kernel {ms:.4f} ms "
            f"({2 * m * n * k / ms / 1e9:.1f} TOP/s; eager call {eager:.4f} "
            f"ms), plain {plain_ms:.4f} ms, library "
            f"{'null' if lib is None else f'{lib:.4f} ms'} ({why}), bound "
            f"{b_ms:.4f} ms ({b_by})")
        out[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib, max_abs_err=err,
                        kernel=kind)
        del a, b, got, want
    return dict(out["m512"], m8=out["m8"], tp_down=out["tp_down"])


def bwd_kernel_rows(dev, randn):
    """flash_bwd_dq / flash_bwd_dkv at the training shape against the plain
    gradient from the same (out, lse); then timed beside their bounds, the
    plain gradient (one call computes dq, dk and dv: both rows show it)
    and SDPA's backward (a yardstick for both rows)."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import flash_attention as fa

    B, Hq, Hkv, S, D = 1, 32, 8, TRAIN_SEQ, 128
    q, k, v = randn(B, Hq, S, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    do = randn(B, Hq, S, D)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do)
    errs = {}
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        err, top, l2, tile_l2 = grad_errors(gt, wt)
        log(f"flash_bwd {name}: max|kernel-plain| {err:.3e}, max|plain| "
            f"{top:.3e} (tol {BWD_REL_TOL} x max|plain|); relative L2 "
            f"{l2:.3e} (tol {BWD_L2_TOL}), worst (head, 64-row tile) "
            f"{tile_l2:.3e} (tol {BWD_TILE_L2_TOL})")
        if not (torch.isfinite(gt).all() and err <= BWD_REL_TOL * top
                and l2 <= BWD_L2_TOL and tile_l2 <= BWD_TILE_L2_TOL):
            raise AssertionError(f"flash_bwd {name} disagrees with plain")
        errs[name] = err
    del got, want
    delta = (do.float() * out.float()).sum(-1).contiguous()
    kw = dict(causal=True, scale=D ** -0.5, q_offset=0, kv_offset=0,
              soft_cap=0.0, window=0, out_dtype=torch.bfloat16)
    dq_ms = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw))
    dkv_ms = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                              **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(
        q, k, v, out, lse, do), iters=3)
    # SDPA's backward: the GQA form, and K/V expanded to Hq heads in case
    # the GQA form has no fast backward; the faster of the two is the row's.
    # Autograd runs a backward on its forward's stream, so the backward is
    # timed as CUDA-graph replays of forward + backward less those of the
    # forward alone, as the kernels are timed
    lib = {}
    for tag, kk, vv, gqa in (
            ("gqa", k, v, True),
            ("expanded", k.repeat_interleave(Hq // Hkv, dim=1),
             v.repeat_interleave(Hq // Hkv, dim=1), False)):
        xs = [x.detach().clone().requires_grad_() for x in (q, kk, vv)]

        def fwd():
            return F.scaled_dot_product_attention(*xs, is_causal=True,
                                                  enable_gqa=gqa)

        lib[tag] = (time_ms(lambda: torch.autograd.grad(fwd(), xs, do))
                    - time_ms(fwd))
        del xs
    lib_ms = min(lib.values())
    visible = S * (S + 1) // 2            # causal (i, j) pairs per q-head
    in_bytes = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * B * Hq * S * 4
    prod = 2 * D * visible * Hq           # flops of one S x S x D product
    dq_b = bound_ms(in_bytes + q.numel() * 2, 3 * prod)
    dkv_b = bound_ms(in_bytes + 2 * k.numel() * 2, 4 * prod)
    five = bound_ms(in_bytes + (q.numel() + 2 * k.numel()) * 2, 5 * prod)
    log(f"flash_bwd: dq kernel {dq_ms:.4f} ms (bound {dq_b[0]:.4f} ms, "
        f"{dq_b[1]}), dkv kernel {dkv_ms:.4f} ms (bound {dkv_b[0]:.4f} ms, "
        f"{dkv_b[1]}); together {dq_ms + dkv_ms:.4f} ms against the "
        f"gradient's five-product bound {five[0]:.4f} ms (the split's seven "
        f"products: {dq_b[0] + dkv_b[0]:.4f} ms); plain gradient "
        f"{plain_ms:.4f} ms; sdpa backward {lib['gqa']:.4f} ms (GQA), "
        f"{lib['expanded']:.4f} ms (K/V expanded)")
    common = dict(plain_ms=plain_ms, library_ms=lib_ms)
    return {"flash_bwd_dq": dict(common, ms=dq_ms, bound_ms=dq_b[0],
                                 bound_by=dq_b[1], max_abs_err=errs["dq"]),
            "flash_bwd_dkv": dict(common, ms=dkv_ms, bound_ms=dkv_b[0],
                                  bound_by=dkv_b[1],
                                  max_abs_err=max(errs["dk"], errs["dv"]))}


def event_ms(fn, iters=3, hold_gc=True):
    """Eager device time per call between CUDA events (for a plain version
    that reads the tile map on the host, which a CUDA graph cannot
    capture), Python's collector held off in the timed window (unless
    ``hold_gc`` is False): a collection there stalls the host while the
    card idles between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    was_on = gc.isenabled()
    if hold_gc:
        gc.disable()
    try:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    finally:
        if was_on:
            gc.enable()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gc_pauses(fn):
    """(fn(), [(generation, ms)] of the Python collections that ran
    during it)."""
    seen, t = [], {}

    def watch(phase, info):
        if phase == "start":
            t["s"] = time.perf_counter()
        else:
            seen.append((info["generation"],
                         round((time.perf_counter() - t["s"]) * 1e3, 3)))

    gc.callbacks.append(watch)
    try:
        return fn(), seen
    finally:
        gc.callbacks.remove(watch)


def call_trace(fn, iters=10):
    """Per-call device ms (CUDA events around each of ``iters`` eager
    calls, one synchronisation at the end) and the host's ms for each
    call, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    host = []
    ev[0].record()
    for i in range(iters):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(iters)], host


def kernel_device_ms(fn, key, iters=20):
    """Device time per call of the kernels whose name holds ``key``, from
    ``iters`` eager calls under ``torch.profiler`` (for a launch that
    cannot be captured in a CUDA graph and is short enough that eager
    calls wait on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_dist_tpu_torch.examples.serve import _device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages() if key in e.key)
    if us <= 0:
        raise AssertionError(f"the profiler saw no kernel named {key}")
    return us / 1e3 / iters


# A profile of one call is framed by two fills of a float64 marker, a
# kernel that no profiled call launches.  The profiler has been seen to
# drop a short window's device events whole (a decode call's one kernel,
# a lens packing's ``cat``), so a profile that lacks either marker is
# incomplete and is taken again, up to ``PROFILES`` times; one that holds
# both is judged as it stands.
PROFILES = 3
MARKER = "FillFunctor<double>"


def device_kernels(fn):
    """Names and counts of the device kernels one ``fn()`` launches (the
    profiler's count, after a first call outside it, the markers taken
    off), and the number of profiles it took to hold both markers."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    mark = torch.zeros(1, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    for tries in range(1, PROFILES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mark.fill_(1.0)
            fn()
            mark.fill_(2.0)
            torch.cuda.synchronize()
        seen = Counter({e.key: e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        marks = [k for k in seen if MARKER in k]
        if len(marks) == 1 and seen[marks[0]] >= 2:
            seen[marks[0]] -= 2
            return +seen, tries
    raise AssertionError(f"{PROFILES} profiles, none holding both of its "
                         f"markers: {dict(seen)}")


def lens_packing(lens, q_lens, T):
    """The lens packing alone of a decode call at T > 1 (``pack_lens_arg``
    stacks them on the device), else None."""
    from triton_dist_tpu_torch.kernels import flash_decode as fd

    if T == 1:
        return None
    return lambda: fd.pack_lens_arg(lens, None, q_lens, n_tok=T, window=0)


def one_kernel_per_call(tag, fn, packing=None):
    """Assert that one ``fn()`` launches exactly one device kernel, the
    decode kernel, counting every kernel the profiler sees (the decode
    kernel merges its splits inside its own launch).  ``packing`` (from
    :func:`lens_packing`), where given, packs the call's lens alone: it
    must show its stack's ``cat`` kernel, and the kernels it launches are
    taken off the count first.  Each profile is judged once, as soon as
    it holds both markers (:func:`device_kernels`)."""
    seen, tries = device_kernels(fn)
    if packing is not None:
        pack, pack_tries = device_kernels(packing)
        tries = max(tries, pack_tries)
        if not any("Cat" in k for k in pack):
            raise AssertionError(f"{tag}: the lens packing alone launched "
                                 f"{dict(pack)}, no cat kernel")
        if any(seen[k] < n for k, n in pack.items()):
            raise AssertionError(f"{tag}: one call launched {dict(seen)}, "
                                 f"less than its lens packing {dict(pack)}")
        seen -= pack
    if list(seen.values()) != [1] or "decode_kernel" not in next(iter(seen)):
        raise AssertionError(f"{tag}: one call launched {dict(seen)} "
                             f"besides its lens packing, not one decode "
                             f"kernel")
    log(f"{tag}: one kernel a call, every kernel counted (profiler"
        f"{'' if tries == 1 else f'; a profile taken {tries} times'}"
        f"): {next(iter(seen))[:60]}")


def check_tiles(tag, got, want, block_m):
    """The grouped GEMM's agreement rule: max |kernel - plain| <= GG_REL_TOL
    max |plain|; relative L2 <= GG_L2_TOL over the tensor and over each
    row tile (a tile steered to the wrong expert shows); a tile whose
    plain output is zero (padding) must be exactly zero.  Returns
    max |err|."""
    import torch

    err, want = got.float() - want.float(), want.float()
    tiles = err.reshape(-1, block_m * err.shape[1]).norm(dim=1)
    ref = want.reshape(-1, block_m * want.shape[1]).norm(dim=1)
    pad = ref == 0
    worst = (tiles[~pad] / ref[~pad]).max().item()
    amax, top = err.abs().max().item(), want.abs().max().item()
    l2 = (err.norm() / want.norm()).item()
    pad_zero = bool(torch.all(tiles[pad] == 0))
    log(f"{tag}: max|kernel-plain| {amax:.3e} (tol {GG_REL_TOL} x max|plain| "
        f"{top:.3e}), relative L2 {l2:.3e} (tol {GG_L2_TOL}), worst row "
        f"tile {worst:.3e} (tol {GG_L2_TOL}), {int(pad.sum())} padding tiles "
        f"exactly zero: {pad_zero}")
    if not (torch.isfinite(got).all() and amax <= GG_REL_TOL * top
            and l2 <= GG_L2_TOL and worst <= GG_L2_TOL and pad_zero):
        raise AssertionError(f"{tag} disagrees with plain")
    return amax


def group_gemm_rows(dev, g):
    """The three modes of csrc/group_gemm.cu at Mixtral-8x7B's gate/up
    projection (E 8, K 4096, N 14336), each row tile's expert from
    sort_align of seeded top-2 routing: group_gemm at 2048 tokens (M_pad
    5120, block_m 128) and, under "t8", at 8 tokens (M_pad 1152);
    group_gemm_dx (dy [5120, 14336] against the same stack; padding rows
    of dy zero, as the backward's are); group_gemm_i8 at the first plan.
    Each against its plain version, then timed beside its bound and
    ``torch._grouped_mm`` (bf16) where this PyTorch has it."""
    import torch

    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.kernels import moe_utils as mu

    E, K, N, bm = 8, 4096, 14336, 128

    def plan_for(T):
        _, experts = mu.topk_routing(torch.randn(
            (T, E), generator=g, device=dev), 2)
        plan = mu.sort_align(experts, E, bm)
        x = torch.randn((T, K), generator=g, device=dev).bfloat16()
        return plan, mu.gather_sorted(x, plan["dest"], plan["m_pad"])

    def library(a, b, te):
        """torch._grouped_mm over the plan's groups (offsets: each
        expert's end row, the trailing padding tiles counted to E - 1),
        timed eagerly (a 1-3 ms call hides its launch; no graph capture
        of a call the port does not own); None and the reason where it is
        missing or fails."""
        if not hasattr(torch, "_grouped_mm"):
            return None, "this PyTorch has no torch._grouped_mm"
        offs = (torch.bincount(te, minlength=E).cumsum(0) * bm).to(
            torch.int32)
        try:
            out = torch._grouped_mm(a, b, offs=offs)
            ms = event_ms(lambda: torch._grouped_mm(a, b, offs=offs),
                          iters=10)
        except Exception as e:   # a yardstick only: report why it is null
            return None, f"torch._grouped_mm failed: {str(e)[:120]}"
        return ms, out

    def bound(x_bytes, te, slab_bytes, out_bytes, ops, rate=BF16_FLOPS_S):
        n_slabs = len(set(te.tolist()))
        return bound_ms(x_bytes + n_slabs * slab_bytes + out_bytes, ops,
                        rate) + (n_slabs,)

    w = (torch.randn((E, K, N), generator=g, device=dev) / K ** 0.5
         ).bfloat16()
    rows = {}
    entries = {}
    for tag, T in (("T2048", 2048), ("T8", 8)):
        plan, xs = plan_for(T)
        te = plan["tile_expert"]
        M = xs.shape[0]
        y = gg.group_gemm(xs, w, te, block_m=bm)
        torch.cuda.synchronize()
        want = gg.group_gemm_ref(xs, w, te, block_m=bm)
        err = check_tiles(f"group_gemm {tag} (M_pad {M})", y, want, bm)
        ms = time_ms(lambda: gg.group_gemm(xs, w, te, block_m=bm))
        plain_ms = event_ms(lambda: gg.group_gemm_ref(xs, w, te,
                                                      block_m=bm))
        lib, out = library(xs, w, te)
        why = out if lib is None else (
            f"torch._grouped_mm, relative L2 to plain "
            f"{((out.float() - want.float()).norm() / want.float().norm()).item():.2e}")
        b_ms, b_by, n_slabs = bound(M * K * 2, te, K * N * 2, M * N * 2,
                                    2 * M * K * N)
        log(f"group_gemm {tag}: kernel {ms:.4f} ms "
            f"({2 * M * K * N / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f}"
            f" ms, library {'null' if lib is None else f'{lib:.4f} ms'} "
            f"({why}), bound {b_ms:.4f} ms ({b_by}; {n_slabs} expert slabs "
            f"of {K * N * 2 / 1e6:.1f} MB)")
        entries[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib, max_abs_err=err)
        if T == 2048:
            main_plan, main_xs = plan, xs
        del y, want, out
    rows["group_gemm"] = dict(entries["T2048"], t8=entries["T8"])

    te, valid = main_plan["tile_expert"], main_plan["valid_rows"]
    M = main_xs.shape[0]
    dy = (torch.randn((M, N), generator=g, device=dev)
          * valid[:, None]).bfloat16()
    dx = gg.group_gemm_dx(dy, w, te, block_m=bm)
    torch.cuda.synchronize()
    want = gg.group_gemm_ref(dy, w, te, block_m=bm, trans_w=True)
    err = check_tiles("group_gemm_dx T2048", dx, want, bm)
    ms = time_ms(lambda: gg.group_gemm_dx(dy, w, te, block_m=bm))
    plain_ms = event_ms(lambda: gg.group_gemm_ref(dy, w, te, block_m=bm,
                                                  trans_w=True))
    lib, out = library(dy, w.transpose(1, 2), te)
    why = out if lib is None else (
        f"torch._grouped_mm on the transposed view, relative L2 to plain "
        f"{((out.float() - want.float()).norm() / want.float().norm()).item():.2e}")
    b_ms, b_by, n_slabs = bound(M * N * 2, te, K * N * 2, M * K * 2,
                                2 * M * K * N)
    log(f"group_gemm_dx T2048: kernel {ms:.4f} ms "
        f"({2 * M * K * N / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"library {'null' if lib is None else f'{lib:.4f} ms'} ({why}), "
        f"bound {b_ms:.4f} ms ({b_by})")
    rows["group_gemm_dx"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib,
                                 max_abs_err=err)
    del dy, dx, want, out

    # the down projection on the same tile map: w [E, 14336, 4096], a
    # 448-step K loop forward, and its dx (contraction 4096, 14336 columns)
    w_down = (torch.randn((E, N, K), generator=g, device=dev) / N ** 0.5
              ).bfloat16()
    h = (torch.randn((M, N), generator=g, device=dev)
         * valid[:, None]).bfloat16()
    y = gg.group_gemm(h, w_down, te, block_m=bm)
    torch.cuda.synchronize()
    err = check_tiles("group_gemm down T2048", y,
                      gg.group_gemm_ref(h, w_down, te, block_m=bm), bm)
    rows["group_gemm"]["max_abs_err"] = max(rows["group_gemm"]["max_abs_err"],
                                            err)
    dy = (torch.randn((M, K), generator=g, device=dev)
          * valid[:, None]).bfloat16()
    dx = gg.group_gemm_dx(dy, w_down, te, block_m=bm)
    torch.cuda.synchronize()
    err = check_tiles("group_gemm_dx down T2048", dx,
                      gg.group_gemm_ref(dy, w_down, te, block_m=bm,
                                        trans_w=True), bm)
    rows["group_gemm_dx"]["max_abs_err"] = max(
        rows["group_gemm_dx"]["max_abs_err"], err)
    del w_down, h, y, dy, dx

    xq = torch.randint(-127, 128, main_xs.shape, generator=g, device=dev,
                       dtype=torch.int8) * valid[:, None].to(torch.int8)
    wq = torch.randint(-127, 128, (E, K, N), generator=g, device=dev,
                       dtype=torch.int8)
    yq = gg.group_gemm_i8(xq, wq, te, block_m=bm)
    torch.cuda.synchronize()
    want = gg.group_gemm_ref(xq, wq, te, block_m=bm)
    exact = torch.equal(yq, want)
    pad_zero = bool(torch.all(yq[~valid] == 0))
    err = (yq.double() - want.double()).abs().max().item()
    log(f"group_gemm_i8 T2048: exact {exact}, max|kernel-plain| {err:.1f}, "
        f"padding rows zero {pad_zero}")
    if not (exact and pad_zero):
        raise AssertionError("group_gemm_i8 is not exact")
    ms = time_ms(lambda: gg.group_gemm_i8(xq, wq, te, block_m=bm))
    plain_ms = event_ms(lambda: gg.group_gemm_ref(xq, wq, te, block_m=bm))
    b_ms, b_by, _ = bound(M * K, te, K * N, M * N * 4, 2 * M * K * N,
                          INT8_OPS_S)
    log(f"group_gemm_i8 T2048: kernel {ms:.4f} ms "
        f"({2 * M * K * N / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, "
        f"library null (no single PyTorch call computes an int8 grouped "
        f"product), bound {b_ms:.4f} ms ({b_by})")
    rows["group_gemm_i8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None,
                                 max_abs_err=err)
    del xq, yq, want

    # the int8 mode at block_m 512, the W8A8 MoE layer's load-aware tile
    # at 2,048 tokens: the kernel's 256 x 128 tiles (under "bm512")
    _, experts = mu.topk_routing(torch.randn((2048, E), generator=g,
                                             device=dev), 2)
    plan = mu.sort_align(experts, E, 512)
    te, valid = plan["tile_expert"], plan["valid_rows"]
    M = plan["m_pad"]
    xq = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                       dtype=torch.int8) * valid[:, None].to(torch.int8)
    yq = gg.group_gemm_i8(xq, wq, te, block_m=512)
    torch.cuda.synchronize()
    want = gg.group_gemm_ref(xq, wq, te, block_m=512)
    err = (yq.double() - want.double()).abs().max().item()
    if not torch.equal(yq, want):
        raise AssertionError("group_gemm_i8 block_m 512 is not exact")
    ms = time_ms(lambda: gg.group_gemm_i8(xq, wq, te, block_m=512))
    b_ms, b_by, _ = bound(M * K, te, K * N, M * N * 4, 2 * M * K * N,
                          INT8_OPS_S)
    log(f"group_gemm_i8 T2048 block_m 512 (M_pad {M}): exact True; kernel "
        f"{ms:.4f} ms ({2 * M * K * N / ms / 1e9:.1f} TOP/s), bound "
        f"{b_ms:.4f} ms ({b_by})")
    rows["group_gemm_i8"]["bm512"] = dict(ms=ms, bound_ms=b_ms,
                                          bound_by=b_by, max_abs_err=err)
    return rows


def a2a_agree(tag, recv, recv_splits, want, want_splits):
    """The all-to-all's agreement rule: recv_splits, each rank's own
    segment whole and every peer segment's rows below min(split,
    max_tokens) bit for bit (the rows past them are undefined)."""
    import torch

    world, _, max_tokens = recv.shape[:3]
    ok = torch.equal(recv_splits, want_splits)
    for p in range(world):
        for r in range(world):
            k = max_tokens if p == r else min(int(want_splits[p, r]),
                                              max_tokens)
            ok = ok and torch.equal(recv[p, r, :k], want[p, r, :k])
    log(f"all_to_all {tag} send {list(recv.shape)}: equal to the plain "
        f"version on every defined row and on recv_splits {ok}")
    if not ok:
        raise AssertionError(f"all_to_all {tag} disagrees with plain")


def all_to_all_row(dev, g):
    """csrc/all_to_all.cu.  World 1 (the local copy): the MoE dispatch's
    shape at 2048 tokens top-2 (send [1, 1, 4096, 4096] bf16, one split of
    4095 rows; the combine's is the same) and [1, 1, 37, 3] (222 bytes:
    16-byte vectors and a byte tail), each exactly equal to its plain
    version, the first timed (CUDA-graph replays) beside its bound (the
    segment read once and written once) and one PyTorch copy.  EP over 4
    ranks (the peer segments), under "shapes": the dispatch of 2048 tokens
    top-2 (send [4, 4, 1024, 4096] bf16) with the splits of a balanced
    routing (seeded top-2 over 8 experts, ~256 rows a segment) and of a
    skewed one (all 1024 rows of a rank to one peer), and a ragged [4, 4,
    37, 3]; and Ulysses' two shuffles at Llama-3-8B CP 4 (phase 17's
    shapes, full splits of S_loc 2048 rows: send [4, 4, 2048, 1536], each
    rank's q | k | v heads of every peer, and [4, 4, 2048, 1024], the
    attention output back); each equal to its plain version on every
    defined row
    (``a2a_agree``), timed by the profiler's device time of the kernel
    (each call carries a new epoch, so no CUDA graph; back-to-back eager
    calls between CUDA events, which count the host's launch cost where it
    exceeds the kernel's, printed beside), next to its bound (the shipped
    rows, min(split, max_tokens) of every segment, read once and written
    once), the contract's bound beside it (``contract_bound_ms``: the
    peers' shipped rows and each rank's own segment whole, padding
    included, as the contract writes it) and one ``send.transpose(0,
    1).contiguous()`` (the full segments)."""
    import torch

    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import moe_utils as mu

    for shape in ((1, 1, 37, 3), (1, 1, 4096, 4096)):
        send = torch.randn(shape, generator=g, device=dev).bfloat16()
        splits = torch.tensor([[shape[2] - 1]], dtype=torch.int32,
                              device=dev)
        recv, recv_splits = a2a.fast_all_to_all_shard(send, splits)
        torch.cuda.synchronize()
        want, want_splits = a2a.all_to_all_ref(send, splits)
        exact = (torch.equal(recv, want)
                 and torch.equal(recv_splits, want_splits))
        log(f"all_to_all send {list(shape)}: equal to the plain version "
            f"{exact}")
        if not exact:
            raise AssertionError(f"all_to_all {list(shape)} disagrees with "
                                 f"plain")
    ms = time_ms(lambda: a2a.fast_all_to_all_shard(send, splits))
    plain_ms = time_ms(lambda: a2a.all_to_all_ref(send, splits))
    out = torch.empty_like(send)
    lib = time_ms(lambda: out.copy_(send))
    n_bytes = 2 * send.numel() * send.element_size() + 2 * 4
    b_ms, b_by = bound_ms(n_bytes, 0)
    log(f"all_to_all [1, 1, 4096, 4096] bf16: kernel {ms:.4f} ms "
        f"({n_bytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, library "
        f"{lib:.4f} ms (Tensor.copy_), bound {b_ms:.4f} ms ({b_by})")
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib, max_abs_err=0.0)
    del send, out, recv, want

    W, mt, H = EP, 1024, 4096
    _, experts = mu.topk_routing(torch.randn((W * 512, 8), generator=g,
                                             device=dev), 2)
    dest = (experts.reshape(W, -1).long() // (8 // W))
    balanced = torch.stack([torch.bincount(d, minlength=W) for d in dest]
                           ).to(torch.int32)
    skewed = torch.zeros((W, W), dtype=torch.int32, device=dev)
    skewed[torch.arange(W), (torch.arange(W) + 1) % W] = mt
    s_cp = CP_SEQ // CP
    full = torch.full((CP, CP), s_cp, dtype=torch.int32, device=dev)
    shapes = {}
    for tag, shape, splits in (
            ("ep4_balanced", (W, W, mt, H), balanced),
            ("ep4_skewed", (W, W, mt, H), skewed),
            ("ep4_ragged", (W, W, 37, 3),
             torch.randint(0, 41, (W, W), generator=g, device=dev,
                           dtype=torch.int32)),
            ("cp4_ulysses_qkv", (CP, CP, s_cp, 1536), full),
            ("cp4_ulysses_out", (CP, CP, s_cp, 1024), full)):
        send = torch.randn(shape, generator=g, device=dev).bfloat16()
        recv, recv_splits = a2a.fast_all_to_all_shard(send, splits)
        torch.cuda.synchronize()
        want, want_splits = a2a.all_to_all_ref(send, splits)
        a2a_agree(tag, recv, recv_splits, want, want_splits)
        del recv, want
        eager = event_ms(lambda: a2a.fast_all_to_all_shard(send, splits),
                         iters=20)
        ms = kernel_device_ms(
            lambda: a2a.fast_all_to_all_shard(send, splits), "a2a_peer")
        plain_ms = time_ms(lambda: a2a.all_to_all_ref(send, splits))
        lib = time_ms(lambda: send.transpose(0, 1).contiguous())
        rows = int(torch.clamp(splits, 0, shape[2]).sum())
        n_bytes = 2 * rows * shape[3] * send.element_size() + 2 * 4 * W * W
        b_ms, b_by = bound_ms(n_bytes, 0)
        # the contract also writes each rank's own segment whole, its
        # padding rows included (recv[r][r] == send[r][r])
        own = torch.eye(W, dtype=torch.bool, device=dev)
        c_rows = int(torch.where(own, shape[2], torch.clamp(
            splits, 0, shape[2])).sum())
        c_ms, _ = bound_ms(2 * c_rows * shape[3] * send.element_size()
                           + 2 * 4 * W * W, 0)
        log(f"all_to_all {tag} send {list(shape)} bf16, splits "
            f"{splits.tolist()}: kernel {ms:.4f} ms device (profiler; eager "
            f"calls {eager:.4f} ms between CUDA events), "
            f"plain {plain_ms:.4f} ms, library {lib:.4f} ms "
            f"(transpose(0, 1).contiguous()), bound {b_ms:.4f} ms ({b_by}:"
            f" {rows} shipped rows); the contract's rows (own segments "
            f"whole) {c_rows}, bound {c_ms:.4f} ms, kernel at "
            f"{c_ms / ms:.3f} of it")
        shapes[tag] = dict(ms=ms, eager_ms=eager, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                           contract_bound_ms=c_ms, max_abs_err=0.0)
        del send
    return dict(row, shapes=shapes)


def gemm_rule(tag, got, want):
    """The bf16 GEMM agreement rule (both sides sum in f32, then round):
    max |kernel - plain| <= GG_REL_TOL max |plain|, relative L2 <=
    GG_L2_TOL.  Returns max |err|."""
    import torch

    err, want = got.float() - want.float(), want.float()
    amax, top = err.abs().max().item(), want.abs().max().item()
    l2 = (err.norm() / want.norm()).item()
    log(f"{tag}: max|kernel-plain| {amax:.3e} (tol {GG_REL_TOL} x max|plain|"
        f" {top:.3e}), relative L2 {l2:.3e} (tol {GG_L2_TOL})")
    if not (torch.isfinite(got).all() and amax <= GG_REL_TOL * top
            and l2 <= GG_L2_TOL):
        raise AssertionError(f"{tag} disagrees with plain")
    return amax


def matmul_row(dev, g):
    """csrc/gemm.cu at (M, K, N) = (2048, 4096, 14336) (a 2048-token
    projection of Llama-3-8B's FFN width) against its plain version by the
    bf16 GEMM rule, timed beside its bound and torch.matmul (cuBLAS, the
    yardstick); the line names the kernel the call took
    (``matmul.mode_launches``)."""
    import torch

    from triton_dist_tpu_torch.kernels import gemm

    M, K, N = 2048, 4096, 14336
    a = torch.randn((M, K), generator=g, device=dev).bfloat16()
    b = (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).bfloat16()
    modes0 = dict(gemm.matmul.mode_launches)
    got = gemm.matmul(a, b)
    torch.cuda.synchronize()
    kind = next(k for k, n in gemm.matmul.mode_launches.items()
                if n > modes0[k])
    err = gemm_rule(f"matmul ({M}, {K}, {N})", got, gemm.matmul_ref(a, b))
    ms = time_ms(lambda: gemm.matmul(a, b))
    plain_ms = time_ms(lambda: gemm.matmul_ref(a, b), iters=3)
    lib = time_ms(lambda: torch.matmul(a, b))
    b_ms, b_by = bound_ms(2 * (M * K + K * N + M * N), 2 * M * N * K)
    log(f"matmul ({M}, {K}, {N}): kernel ({kind}) {ms:.4f} ms "
        f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"library {lib:.4f} ms (torch.matmul), bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, max_abs_err=err)


def ring_rows(dev, g):
    """csrc/ag_gemm.cu and csrc/gemm_rs.cu over a virtual world of TP ranks
    at every projection shape of Llama-3-8B's TP-4 train step (m_loc 512
    rows per rank): the AG-GEMM at the forward's QKV (n 1536) and gate/up
    (n 3584) and, transposed, at the backward's wo^T (n 1024) and wdown^T
    (n 3584); the GEMM-RS at the forward's wo (k 1024) and down (k 3584)
    and, transposed, at the backward's QKV^T (k 1536) and gate/up^T (k
    3584).  Each against its plain version (the gathered A bit for bit,
    the products by the bf16 GEMM rule), timed eagerly between CUDA events
    (a launch carries its call's epoch, so it is never captured in a
    graph) beside its bound, its plain version and one PyTorch call of the
    same function over the virtual world (library): for the AG-GEMM a
    batched torch.matmul of the gathered A, a view of the rank-stacked
    rows, against every rank's B; for the GEMM-RS one einsum that sums
    each chunk's products over the ranks.  Across cards no single call
    gathers or reduce-scatters; on one card the ranks' rows already lie
    in one tensor.  Rows report gate/up and down; every shape rides along
    under "shapes"."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    W, m_loc, D, F, KO, QKV = TP, 512, 4096, 14336 // TP, 4096 // TP, 1536

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).bfloat16()

    def entry(kind, tag, ms, plain_ms, n_bytes, ops, err, lib, lib_call):
        b_ms, b_by = bound_ms(n_bytes, ops)
        log(f"{kind} {tag}: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
            f"TFLOP/s over {W} ranks), plain {plain_ms:.4f} ms, library "
            f"{lib:.4f} ms ({lib_call}), bound {b_ms:.4f} ms ({b_by})")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib, max_abs_err=err)

    rows = {}
    shapes = {}
    for tag, K, n, trans in (("qkv", D, QKV, False), ("gate_up", D, F, False),
                             ("wo_bwd", D, KO, True),
                             ("wdown_bwd", D, F, True)):
        a = randn(W, m_loc, K)
        b = randn(*((W, n, K) if trans else (W, K, n)), scale=K ** -0.5)
        a_full, c = agm.ag_gemm_shard(a, b, trans_b=trans)
        torch.cuda.synchronize()
        want_full, want_c = agm.ag_gemm_ref(a, b, trans_b=trans)
        if not torch.equal(a_full, want_full):
            raise AssertionError(f"ag_gemm {tag}: gathered A differs")
        err = gemm_rule(f"ag_gemm {tag} (W {W}, m_loc {m_loc}, K {K}, n {n}"
                        f"{', B^T' if trans else ''})", c, want_c)
        del a_full, c, want_full, want_c
        ms = event_ms(lambda: agm.ag_gemm_shard(a, b, trans_b=trans), iters=10)
        plain_ms = time_ms(lambda: agm.ag_gemm_ref(a, b, trans_b=trans),
                           iters=3)
        af = a.reshape(1, W * m_loc, K).expand(W, -1, -1)
        bt = b.transpose(1, 2) if trans else b
        lib = time_ms(lambda: torch.matmul(af, bt), iters=5)
        shapes[tag] = entry("ag_gemm", tag, ms, plain_ms, 2 * (
            W * m_loc * K + W * K * n + W * W * m_loc * (K + n)),
            2 * W * W * m_loc * n * K, err, lib, "batched torch.matmul")
    rows["ag_gemm"] = dict(shapes["gate_up"], shapes=shapes)

    shapes = {}
    for tag, k, N, trans in (("wo", KO, D, False), ("down", F, D, False),
                             ("qkv_bwd", QKV, D, True),
                             ("gate_up_bwd", F, D, True)):
        a = randn(W, W * m_loc, k)
        b = randn(*((W, N, k) if trans else (W, k, N)), scale=k ** -0.5)
        out = grs.gemm_rs_shard(a, b, trans_b=trans)
        torch.cuda.synchronize()
        err = gemm_rule(f"gemm_rs {tag} (W {W}, m_loc {m_loc}, k {k}, N {N}"
                        f"{', B^T' if trans else ''})", out,
                        grs.gemm_rs_ref(a, b, trans_b=trans))
        del out
        ms = event_ms(lambda: grs.gemm_rs_shard(a, b, trans_b=trans), iters=10)
        plain_ms = time_ms(lambda: grs.gemm_rs_ref(a, b, trans_b=trans),
                           iters=3)
        a4 = a.view(W, W, m_loc, k)
        eq = "qrmk,qnk->rmn" if trans else "qrmk,qkn->rmn"
        lib = time_ms(lambda: torch.einsum(eq, a4, b), iters=5)
        shapes[tag] = entry("gemm_rs", tag, ms, plain_ms, 2 * (
            W * W * m_loc * k + W * k * N + W * m_loc * N),
            2 * W * W * m_loc * k * N, err, lib, "torch.einsum")
    rows["gemm_rs"] = dict(shapes["down"], shapes=shapes)
    rows["ag_gemm_i8"] = ag_gemm_i8_row(dev, g)
    ragged_ring_rows(dev, g, rows)
    return rows


def ag_gemm_i8_row(dev, g):
    """The AG-GEMM's int8 mode (``tdt_ag_gemm_i8``) at the TP-4 W8A8
    forward's column projections (m_loc 512 rows per rank, K 4096): QKV (n
    1536) and gate/up (n 3584) on random int8 operands, the gathered A bit
    for bit and the int32 C exactly equal to the plain version (exact on
    both sides), timed eagerly between CUDA events (each launch carries
    its call's epoch) beside its bound (int8 operations at 1,979 TOP/s
    against the bytes of int8 A, B and gathered A and int32 C), its plain
    version (float64 products, graph-timed) and one ``torch._int_mm`` of
    the gathered rows against every rank's B side by side ([K, W n], B
    column-major as the matmul_i8 row measures it; cuBLASLt). The row
    reports gate/up; both ride along under "shapes"."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    W, m_loc, K = TP, 512, 4096
    shapes = {}
    for tag, n in (("qkv", 1536), ("gate_up", 14336 // TP)):
        a = torch.randint(-127, 128, (W, m_loc, K), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (W, K, n), generator=g, device=dev,
                          dtype=torch.int8)
        a_full, c = agm.ag_gemm_shard(a, b)
        torch.cuda.synchronize()
        want_full, want_c = agm.ag_gemm_ref(a, b)
        same_a, same_c = torch.equal(a_full, want_full), torch.equal(c,
                                                                     want_c)
        err = (c.double() - want_c.double()).abs().max().item()
        b_cm = b.permute(1, 0, 2).reshape(K, W * n).t().contiguous().t()
        af = a.reshape(W * m_loc, K)
        lib_same = torch.equal(torch._int_mm(af, b_cm), torch.cat(
            list(want_c), dim=1))
        log(f"ag_gemm_i8 {tag} (W {W}, m_loc {m_loc}, K {K}, n {n}): "
            f"gathered A equal {same_a}, C exactly equal {same_c} (max "
            f"|kernel-plain| {err:.1f}); torch._int_mm equal {lib_same}")
        if not (same_a and same_c):
            raise AssertionError(f"ag_gemm_i8 {tag} disagrees with plain")
        del a_full, c, want_full, want_c
        ms = event_ms(lambda: agm.ag_gemm_shard(a, b), iters=10)
        plain_ms = time_ms(lambda: agm.ag_gemm_ref(a, b), iters=2, reps=2)
        lib = time_ms(lambda: torch._int_mm(af, b_cm), iters=5)
        ops = 2 * W * W * m_loc * n * K
        n_bytes = W * m_loc * K + W * K * n + W * W * m_loc * K \
            + 4 * W * W * m_loc * n
        b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS_S)
        log(f"ag_gemm_i8 {tag}: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
            f"TOP/s over {W} ranks), plain {plain_ms:.4f} ms, library "
            f"{lib:.4f} ms (torch._int_mm, B column-major), bound "
            f"{b_ms:.4f} ms ({b_by})")
        shapes[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib, max_abs_err=err)
    return dict(shapes["gate_up"], shapes=shapes)


def ragged_ring_rows(dev, g, rows):
    """The row tails: 250 rows per rank (a 1,000-token prompt at TP 4),
    no multiple of any tile's rows (128 for the AG-GEMM, 128 / 64 for the
    GEMM-RS).  The int8 AG-GEMM at the gate/up shape (exactly equal), the
    bf16 AG-GEMM at gate/up and the GEMM-RS at down (the gathered A bit
    for bit, the products by the bf16 GEMM rule), each timed once between
    CUDA events beside its bound and, for the AG-GEMMs, the library call
    of its row (``torch._int_mm`` of the gathered rows against B
    column-major; the batched ``torch.matmul`` of the gathered view); the
    entries ride under each row's "shapes" as "ragged250"."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    W, m_loc, D, F = TP, 250, 4096, 14336 // TP
    a = torch.randint(-127, 128, (W, m_loc, D), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (W, D, F), generator=g, device=dev,
                      dtype=torch.int8)
    a_full, c = agm.ag_gemm_shard(a, b)
    torch.cuda.synchronize()
    want_full, want_c = agm.ag_gemm_ref(a, b)
    if not (torch.equal(a_full, want_full) and torch.equal(c, want_c)):
        raise AssertionError("ag_gemm_i8 ragged250 disagrees with plain")
    ms = event_ms(lambda: agm.ag_gemm_shard(a, b), iters=5)
    # this row read 0.78-0.84 ms for calls of ~0.21 ms when a collection
    # fell in its window (PERF.md §7): the same five calls with the
    # collector on and the collections in their window, and a per-call
    # trace, beside
    on, pauses = gc_pauses(lambda: event_ms(
        lambda: agm.ag_gemm_shard(a, b), iters=5, hold_gc=False))
    per_call, host = call_trace(lambda: agm.ag_gemm_shard(a, b))
    log(f"ag_gemm_i8 ragged250 timing: {ms:.4f} ms a call over five eager "
        f"calls; with the collector on {on:.4f} ms (collections in the "
        f"window, (generation, ms): {pauses}); per call, device ms "
        f"{[round(x, 4) for x in per_call]}, host ms "
        f"{[round(x, 4) for x in host]}")
    b_cm = b.permute(1, 0, 2).reshape(D, W * F).t().contiguous().t()
    af = a.reshape(W * m_loc, D)
    lib = time_ms(lambda: torch._int_mm(af, b_cm), iters=5)
    del b_cm, af
    ops = 2 * W * W * m_loc * F * D
    b_ms, b_by = bound_ms(W * m_loc * D + W * D * F + W * W * m_loc * D
                          + 4 * W * W * m_loc * F, ops, INT8_OPS_S)
    log(f"ag_gemm_i8 ragged250 (W {W}, m_loc {m_loc}, K {D}, n {F}): "
        f"gathered A and C exactly equal; kernel {ms:.4f} ms, library "
        f"{lib:.4f} ms (torch._int_mm, B column-major), bound {b_ms:.4f} ms "
        f"({b_by})")
    rows["ag_gemm_i8"]["shapes"]["ragged250"] = dict(
        ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        max_abs_err=0.0)
    del a, b, a_full, c, want_full, want_c

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).bfloat16()

    a, b = randn(W, m_loc, D), randn(W, D, F, scale=D ** -0.5)
    a_full, c = agm.ag_gemm_shard(a, b)
    torch.cuda.synchronize()
    want_full, want_c = agm.ag_gemm_ref(a, b)
    if not torch.equal(a_full, want_full):
        raise AssertionError("ag_gemm ragged250: gathered A differs")
    err = gemm_rule(f"ag_gemm ragged250 (W {W}, m_loc {m_loc}, K {D}, n "
                    f"{F})", c, want_c)
    ms = event_ms(lambda: agm.ag_gemm_shard(a, b), iters=5)
    af = a.reshape(1, W * m_loc, D).expand(W, -1, -1)
    lib = time_ms(lambda: torch.matmul(af, b), iters=5)
    ops = 2 * W * W * m_loc * F * D
    b_ms, b_by = bound_ms(2 * (W * m_loc * D + W * D * F + W * W * m_loc
                               * (D + F)), ops)
    log(f"ag_gemm ragged250: kernel {ms:.4f} ms, library {lib:.4f} ms "
        f"(batched torch.matmul), bound {b_ms:.4f} ms ({b_by})")
    rows["ag_gemm"]["shapes"]["ragged250"] = dict(
        ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        max_abs_err=err)
    del a, b, a_full, c, want_full, want_c

    a, b = randn(W, W * m_loc, F), randn(W, F, D, scale=F ** -0.5)
    out = grs.gemm_rs_shard(a, b)
    torch.cuda.synchronize()
    err = gemm_rule(f"gemm_rs ragged250 (W {W}, m_loc {m_loc}, k {F}, N "
                    f"{D})", out, grs.gemm_rs_ref(a, b))
    ms = event_ms(lambda: grs.gemm_rs_shard(a, b), iters=5)
    b_ms, b_by = bound_ms(2 * (W * W * m_loc * F + W * F * D + W * m_loc
                               * D), 2 * W * W * m_loc * F * D)
    log(f"gemm_rs ragged250: kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    rows["gemm_rs"]["shapes"]["ragged250"] = dict(
        ms=ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------


def sp_combine_row(dev, g):
    """csrc/sp_combine.cu over SP ranks of the virtual world at the two
    shapes the SP paths give it: the SP-4 decode of 8 sequences (out
    [4, 8, 32, 128] f32) and the engine's 512-token prompt chunk ([4, 512,
    32, 128]), the partials drawn from a seed with rank 1 dead (it holds
    nothing of any row) and one row dead on every rank.  Each against its
    plain version (``combine_partials`` over the rank stack) within
    SP_COMBINE_TOL of the plain result's largest magnitude, the dead row
    exactly 0, and every rank's merge bit for bit the same; timed by the
    profiler's device time (a launch carries its call's epoch, so no CUDA
    graph; eager calls between CUDA events beside), next to its bound
    (what the function must move: every rank's partial read once and
    every rank's final written once; the kernel's own traffic, the
    inputs read, the owners' gather slots written and read once and every
    rank's final written, beside as "algorithm_bound_ms"), its
    plain version and, as the
    yardstick, ``torch.softmax`` of the lse over the ranks then one
    ``torch.einsum`` over the gathered stack (two calls: no single PyTorch
    call gathers across ranks).  The row reports the decode shape; both
    ride along under "shapes".  Then, checked by the same rules and not
    timed: W 8 at the decode shape ([8, 8, 32, 128]) and fewer rows than
    ranks ([8, 1, 3, 128]: owners with an empty band)."""
    import torch

    from triton_dist_tpu_torch.kernels import flash_decode as fd

    Hq, D = 32, 128

    def checked(tag, W, B, H):
        out = torch.randn((W, B, H, D), generator=g, device=dev)
        lse = 3 * torch.randn((W, B, H), generator=g, device=dev)
        out[1], lse[1] = 0, fd.NEG_INF
        out[:, 0, 0], lse[:, 0, 0] = 0, fd.NEG_INF
        got = fd.sp_combine_shard(out, lse, all_ranks=True)
        torch.cuda.synchronize()
        want = fd.combine_partials(out, lse)
        err = max_err(got[0], want)
        scale = want.abs().max().item()
        same = all(torch.equal(got[r], got[0]) for r in range(1, W))
        log(f"sp_combine {tag} out {[W, B, H, D]} f32: max|kernel-plain| "
            f"{err:.3e} (tol {SP_COMBINE_TOL} x {scale:.3f}), ranks bit-"
            f"equal {same}, dead row zero "
            f"{bool(torch.all(got[:, 0, 0] == 0))}")
        if not (err <= SP_COMBINE_TOL * scale and same
                and torch.all(got[:, 0, 0] == 0)):
            raise AssertionError(f"sp_combine {tag} disagrees with plain")
        return out, lse, err

    W = SP
    shapes, row = {}, None
    for tag, B in (("decode", 8), ("chunk512", 512)):
        out, lse, err = checked(tag, W, B, Hq)
        eager = event_ms(lambda: fd.sp_combine_shard(out, lse), iters=20)
        ms = kernel_device_ms(lambda: fd.sp_combine_shard(out, lse),
                              "sp_combine")
        plain_ms = time_ms(lambda: fd.sp_combine_ref(out, lse))
        lib = time_ms(lambda: torch.einsum(
            "wbh,wbhd->bhd", torch.softmax(lse, 0), out))
        bh, plane = B * Hq, (D + fd.SP_PLANE_PAD) * 4
        n_bytes = W * bh * (D + 1) * 4 + W * bh * D * 4
        algo_bytes = n_bytes + 2 * W * bh * plane
        b_ms, b_by = bound_ms(n_bytes, 0)
        algo_ms, _ = bound_ms(algo_bytes, 0)
        log(f"sp_combine {tag}: kernel {ms:.4f} ms device (profiler; eager "
            f"calls {eager:.4f} ms between CUDA events), plain "
            f"{plain_ms:.4f} ms, library {lib:.4f} ms (softmax + einsum, "
            f"two calls), bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} "
            f"MB, inputs and outputs once), the kernel's own traffic "
            f"{algo_ms:.4f} ms ({algo_bytes / 1e6:.1f} MB)")
        shapes[tag] = dict(ms=ms, eager_ms=eager, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           algorithm_bound_ms=algo_ms, library_ms=lib,
                           max_abs_err=err)
        row = row or dict(shapes[tag])
        del out, lse
    for tag, W, B, H in (("W 8 decode", 8, 8, Hq), ("bh < W", 8, 1, 3)):
        checked(tag, W, B, H)
    return dict(row, shapes=shapes)


def teacher_forced_agreement(params, cfg, prompt, served, logits_fn=None,
                             near_tie=NEAR_TIE):
    """Compare served tokens with the argmax of one plain-attention forward
    (``logits_fn(tokens [1, L])``, by default the float prompt forward)
    over prompt + served[:-1] at the positions that produced them.
    Returns (exact matches, matches counting near-ties, positions): a
    mismatch is a near-tie when the served token's reference logit lies
    within ``near_tie`` of the reference maximum."""
    import torch

    from triton_dist_tpu_torch.models.generate import _prompt_forward

    seq = np.concatenate([np.asarray(prompt), np.asarray(served[:-1])])
    toks = torch.as_tensor(seq[None], device="cuda")
    with torch.no_grad():
        if logits_fn is not None:
            logits = logits_fn(toks)
        else:
            _, logits = _prompt_forward(params, toks, cfg=cfg, plain=True)
    ref = logits[0, len(prompt) - 1:]
    if not torch.isfinite(ref).all():
        raise AssertionError("teacher-forced logits are not finite")
    served_t = torch.as_tensor(np.asarray(served), device=ref.device)
    pred = torch.argmax(ref, dim=-1)
    miss = (pred != served_t).nonzero()[:, 0]
    gaps = (ref[miss, pred[miss]] - ref[miss, served_t[miss]]).tolist()
    if gaps:
        log(f"  teacher-forced flips at {miss.tolist()}: reference logit "
            f"gap to the served token {[round(x, 4) for x in gaps]}")
    n = len(served)
    return n - len(gaps), n - sum(g > near_tie for g in gaps), n


def check_agreement(tag, counts, strict_min, near_tie=NEAR_TIE):
    exact = sum(c[0] for c in counts)
    ties = sum(c[1] for c in counts)
    n = sum(c[2] for c in counts)
    log(f"{tag}: teacher-forced agreement {exact}/{n} = {exact / n:.4f} "
        f"exact, {ties}/{n} = {ties / n:.4f} counting near-ties "
        f"(gap <= {near_tie})")
    if ties / n < AGREE_MIN or exact / n < strict_min:
        raise AssertionError(
            f"{tag}: agreement {exact / n:.4f} exact (floor {strict_min}), "
            f"{ties / n:.4f} with near-ties (floor {AGREE_MIN})")


def noise_floor(params, cfg):
    """The bf16 noise floor the agreement check must tolerate: one prompt
    forward with the flash kernel and with the plain attention (run after
    the launch counters are read: these launches are a comparison)."""
    import torch

    from triton_dist_tpu_torch.models.generate import _prompt_forward

    rng = np.random.default_rng(7)
    prompt_t = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 512)),
                               device="cuda")
    _, lk = _prompt_forward(params, prompt_t, cfg=cfg)
    _, lp = _prompt_forward(params, prompt_t, cfg=cfg, plain=True)
    diff = (lk - lp).abs()
    top2 = torch.topk(lp, 2, dim=-1).values
    log(f"noise floor: prompt logits, flash kernel vs plain attention: max "
        f"|diff| {diff.max().item():.4f}, mean {diff.mean().item():.4f}, "
        f"argmax agreement "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f}; "
        f"reference logit std {lp.std().item():.4f}, median top-2 gap "
        f"{(top2[..., 0] - top2[..., 1]).median().item():.4f}")


def generator_phase(cfg, params):
    import torch

    from triton_dist_tpu_torch.models.generate import Generator

    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, size=(2, 512)).astype(np.int64)
    gen = Generator(cfg, max_seq=2048)
    t0 = time.perf_counter()
    st = gen.prefill(params, prompt)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, st = gen.generate(params, st, 32)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    toks = toks.cpu().numpy()
    if toks.shape != (2, 32) or not torch.isfinite(st.last_logits).all():
        raise AssertionError(f"generator: bad output {toks.shape}")
    log(f"generator: prefill 2x512 {t_pre * 1e3:.1f} ms, 32 decode steps "
        f"{t_dec * 1e3:.1f} ms ({t_dec / 32 * 1e3:.2f} ms/step)")
    check_agreement("generator", [
        teacher_forced_agreement(params, cfg, prompt[b], toks[b])
        for b in range(2)], 0.0)
    return gen


def quant_plain_logits(params, cfg, w8a8):
    """A forward of the quantized model that runs the plain versions: one
    ``_chunk_forward`` over the whole sequence into int8 caches (rows
    quantized as they are written, as the served path does), attention by
    ``flash_attention_ref`` on the int8 K/V and, with ``w8a8``, the W8A8
    hooks on ``matmul_i8_ref``."""
    import functools

    import torch

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.models import llama_w8a8
    from triton_dist_tpu_torch.models.generate import _chunk_forward

    def attend(q, k, v, off, k_scale=None, v_scale=None):
        out, _ = fa.flash_attention_ref(q.permute(0, 2, 1, 3), k, v,
                                        q_offset=off, k_scale=k_scale,
                                        v_scale=v_scale)
        return out.permute(0, 2, 1, 3).float()

    hooks = {}
    if w8a8:
        hooks = dict(ffn=functools.partial(llama_w8a8.w8a8_serve_ffn,
                                           plain=True),
                     out_proj=functools.partial(
                         llama_w8a8.w8a8_serve_out_proj, plain=True))

    def fn(toks):
        shape = (1, cfg.n_kv_heads, toks.shape[1], cfg.head_dim)

        def store():
            return {"q": torch.zeros(shape, dtype=torch.int8,
                                     device=toks.device),
                    "s": torch.ones(shape[:3], device=toks.device)}

        caches = [(store(), store()) for _ in range(cfg.n_layers)]
        _, logits = _chunk_forward(params, toks, caches, 0, cfg=cfg,
                                   attend=attend, **hooks)
        return logits

    return fn


def quant_noise_floor(qparams, cfg, plain):
    """The W8A8 model's noise floor: one 2 x 512 prompt forward of the
    quantized model (int8 caches, W8A8 hooks) with the kernels and with
    the plain versions (after the launch counters are read)."""
    import torch

    from triton_dist_tpu_torch.models import llama_w8a8
    from triton_dist_tpu_torch.models.generate import _chunk_forward

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 512)),
                           device="cuda")
    shape = (2, cfg.n_kv_heads, 512, cfg.head_dim)

    def store():
        return {"q": torch.zeros(shape, dtype=torch.int8, device="cuda"),
                "s": torch.ones(shape[:3], device="cuda")}

    _, lk = _chunk_forward(qparams, toks, [(store(), store()) for _ in
                                           range(cfg.n_layers)], 0, cfg=cfg,
                           ffn=llama_w8a8.w8a8_serve_ffn,
                           out_proj=llama_w8a8.w8a8_serve_out_proj)
    lp = torch.cat([plain(toks[b:b + 1]) for b in range(2)])
    diff = (lk - lp).abs()
    top2 = torch.topk(lp, 2, dim=-1).values
    log(f"quantized noise floor: prompt logits of the W8A8 + int8-KV model, "
        f"kernels vs plain versions: max |diff| {diff.max().item():.4f}, "
        f"mean {diff.mean().item():.4f}, argmax agreement "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f}; "
        f"median top-2 gap "
        f"{(top2[..., 0] - top2[..., 1]).median().item():.4f}")


def quant_generator_phase(cfg, params):
    """Phase 5b: the int8-cache Generator (flash_fwd_i8 for 256-token
    prompt chunks, decode_i8 for the steps)."""
    import torch

    from triton_dist_tpu_torch.models.generate import Generator

    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, size=(2, 512)).astype(np.int64)
    gen = Generator(cfg, max_seq=2048, kv_dtype=torch.int8)
    t0 = time.perf_counter()
    st = gen.prefill_chunked(params, prompt, chunk_size=256)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, st = gen.generate(params, st, 32)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    toks = toks.cpu().numpy()
    if toks.shape != (2, 32) or not torch.isfinite(st.last_logits).all():
        raise AssertionError(f"quantized generator: bad output "
                             f"{toks.shape}")
    log(f"quantized generator: prefill_chunked 2x512 (chunks of 256) "
        f"{t_pre * 1e3:.1f} ms, 32 decode steps {t_dec * 1e3:.1f} ms "
        f"({t_dec / 32 * 1e3:.2f} ms/step)")
    plain = quant_plain_logits(params, cfg, w8a8=False)
    check_agreement("quantized generator", [
        teacher_forced_agreement(params, cfg, prompt[b], toks[b],
                                 logits_fn=plain)
        for b in range(2)], 0.0)
    return gen


def engine_phase(cfg, params, gen, *, w8a8=False, tag="engine", mesh=None,
                 kv_shard=None, sampled=False, counters=(), **engine_kw):
    """Phase 5's mix (8 staggered greedy requests; with ``sampled`` a
    ninth, SAMPLED_REQ, at temperature 0.8 and seed 2**40) through a
    ``ServeEngine`` with phase 5's knobs and ``engine_kw`` (``horizon``,
    ``pipeline``, the speculative options; ``warmup=True`` runs
    ``engine.warmup()`` first, then zeroes the launch counts of the
    kernel wrappers in ``counters``).
    Returns (engine, the greedy requests, outputs by id, their prompts,
    the serving line's numbers)."""
    import torch

    from triton_dist_tpu_torch.serve import (
        FinishReason,
        Request,
        SamplingParams,
        ServeEngine,
    )

    warmup = engine_kw.pop("warmup", False)
    rng = np.random.default_rng(11)
    lens = rng.permutation(np.linspace(100, 1500, 8).astype(int))
    news = rng.integers(32, 65, size=8)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)) for n in lens]
    eng = ServeEngine(gen, params, num_blocks=1 + 8 * 2048 // 16,
                      page_size=16, max_batch=8, prefill_chunk=512,
                      w8a8=w8a8, mesh=mesh, kv_shard=kv_shard, **engine_kw)
    w = None
    if warmup:
        w = eng.warmup()
        torch.cuda.synchronize()
        log(f"{tag}: warmup {w['programs']} program signatures, "
            f"{w['graphs']} CUDA graphs captured in {w['seconds']:.2f} s")
    for fn in counters:
        fn.launches = 0
    misses0 = eng.metrics.compile_misses
    reqs = [Request(f"r{i}", p, SamplingParams(max_new_tokens=int(n)))
            for i, (p, n) in enumerate(zip(prompts, news))]
    extra = [Request(SAMPLED_REQ, prompts[0][:300], SamplingParams(
        max_new_tokens=48, temperature=0.8, seed=2**40))] if sampled else []
    t0 = time.perf_counter()
    outs, sub, steps, allr = {}, 0, 0, reqs + extra
    while eng.has_work() or sub < len(allr):
        if steps % 2 == 0 and sub < len(allr):
            eng.submit(allr[sub])
            sub += 1
        for o in eng.step():
            outs[o.request_id] = o
        steps += 1
        if steps > 2000:
            raise AssertionError(f"{tag} did not drain in 2000 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.metrics.summary()
    n_out = sum(len(o.token_ids) for o in outs.values())
    d = s["decode"]
    line = dict(tok_s=n_out / wall, ttft_ms=s["mean_ttft"] * 1e3,
                itl_ms=s["mean_itl"] * 1e3, wall_s=wall,
                dispatches_per_token=d["dispatches_per_token"],
                new_misses=eng.metrics.compile_misses - misses0,
                warmup=w)
    log(f"{tag} ({smi_line()}): {len(outs)} requests, prompts "
        f"{sorted(lens.tolist())}, {s['prefill_tokens']} prefill + {n_out} "
        f"generated tokens in {steps} steps, {wall:.2f} s wall "
        f"({n_out / wall:.1f} tok/s), {s['decode_steps']} decode steps in "
        f"{d['dispatches']} dispatches "
        f"({d['dispatches_per_token']:.4f} a token), step p50 "
        f"{s['latency']['step']['p50'] * 1e3:.1f} ms p99 "
        f"{s['latency']['step']['p99'] * 1e3:.1f} ms, ttft mean "
        f"{s['mean_ttft'] * 1e3:.1f} ms, itl mean "
        f"{s['mean_itl'] * 1e3:.1f} ms, preemptions {s['preemptions']}, "
        f"program misses while serving {line['new_misses']}")
    for i, r in enumerate(allr):
        o = outs.get(r.request_id)
        want = int(news[i]) if i < len(reqs) else 48
        if (o is None or o.finish_reason is not FinishReason.LENGTH
                or len(o.token_ids) != want):
            raise AssertionError(f"{tag}: {r.request_id} did not finish "
                                 f"({o and o.finish_reason})")
    return eng, reqs, outs, prompts, line


def decode_profile(eng, prompts, tag, n_steps, sampled=False):
    """The engine's decode step on the card, as ``examples/serve.py
    --profile`` reads it: eight requests (``prompts``' first 512 tokens;
    with ``sampled`` the first at temperature 0.8, so the horizon runs its
    mixed-sampler program) admitted together; once every row decodes,
    ``n_steps`` engine steps on the host clock, then as many more under
    ``torch.profiler``.
    Returns per DECODE step (one token a row: an engine step at H 1, up to
    H x pipeline of them under the horizon) the wall ms, the device-busy
    ms (every kernel's and copy's own device time, CUDA-graph replays
    included) and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_dist_tpu_torch.examples.serve import _device_us
    from triton_dist_tpu_torch.serve import Request, SamplingParams

    per = eng.horizon * (eng.pipeline if eng.horizon > 1 else 1)
    budget = 2 * n_steps * per + 8
    for i, p in enumerate(prompts[:eng.max_batch]):
        knobs = dict(temperature=0.8, seed=i) if sampled and i == 0 else {}
        eng.submit(Request(f"{tag}-p{i}", p[:512], SamplingParams(
            max_new_tokens=budget, **knobs)))
    while eng.scheduler.waiting or any(
            x is not None and x.status.value != "running"
            for x in eng.slots):
        eng.step()
    runs = []
    for profiled in (False, True):
        m0 = eng.metrics.decode_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n_steps):
                    eng.step()
                torch.cuda.synchronize()
        else:
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3,
                     eng.metrics.decode_steps - m0))
    evts = [e for e in prof.key_averages() if _device_us(e) > 0]
    (wall, n_wall), (_, n_prof) = runs
    wall /= n_wall
    busy = sum(_device_us(e) for e in evts) / 1e3 / n_prof
    decode_calls = sum(e.count for e in evts if "decode_kernel" in e.key)
    eng.run()
    rep = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
               decode_steps=n_wall, kernel_decode_calls=decode_calls)
    log(f"{tag} decode step ({smi_line()}; {eng.max_batch} rows, horizon "
        f"{eng.horizon}, {n_wall} + {n_prof} decode steps): wall "
        f"{wall:.3f} ms a decode "
        f"step, device busy {busy:.3f} ms (profiled; decode_kernel "
        f"{decode_calls} calls in its window), idle share "
        f"{rep['idle_share']:.3f}, wall / busy {wall / busy:.3f}")
    return rep


def prefix_phase(cfg, params, gen):
    """Phase 5p: eight requests share one 1,024-token prefix (64 pages),
    each with a distinct 64..500-token suffix and 32 new tokens, in two
    waves of four (horizon 8, pipeline 2, after warmup).  Wave 2 maps the
    prefix read-only; its 500-token suffix ends mid-page.  Admission maps
    only full pages below a prompt's last token, so no row writes a shared
    page and no copy-on-write split runs (the reference's design: a split
    needs a beam fork or a restored snapshot, neither ported): the phase
    holds the copies to 0.
    Returns (the outputs, prompts, the phase's numbers)."""
    import torch

    from triton_dist_tpu_torch.serve import (
        FinishReason,
        Request,
        SamplingParams,
        ServeEngine,
    )

    rng = np.random.default_rng(15)
    shared = rng.integers(0, cfg.vocab, size=1024)
    suffix = [64, 128, 192, 256, 320, 384, 448, 500]
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, size=n)])
               for n in suffix]
    eng = ServeEngine(gen, params, num_blocks=1 + 8 * 2048 // 16,
                      page_size=16, max_batch=8, prefill_chunk=512,
                      horizon=8, pipeline=2)
    eng.warmup()
    misses0 = eng.metrics.compile_misses
    outs = {}
    t0 = time.perf_counter()
    for wave in (0, 1):
        for i in range(4 * wave, 4 * wave + 4):
            eng.submit(Request(f"p{i}", prompts[i],
                               SamplingParams(max_new_tokens=32)))
        outs.update(eng.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.metrics.summary()
    pc = s["prefix_cache"]
    for i in range(8):
        o = outs.get(f"p{i}")
        if (o is None or o.finish_reason is not FinishReason.LENGTH
                or len(o.token_ids) != 32):
            raise AssertionError(f"prefix: p{i} did not finish "
                                 f"({o and o.finish_reason})")
    warm = [eng.metrics.requests[f"p{i}"].cached_prefix_tokens
            for i in range(4, 8)]
    line = dict(wall_s=wall, hit_blocks=pc["hit_blocks"],
                cow_copies=pc["cow_copies"],
                ttft_warm_ms=pc["mean_ttft_warm"] * 1e3,
                ttft_cold_ms=pc["mean_ttft_cold"] * 1e3,
                skipped=pc["prefix_skipped_tokens"], warm_tokens=warm,
                new_misses=eng.metrics.compile_misses - misses0)
    log(f"prefix ({smi_line()}): 2 waves of 4 (1,024 shared + {suffix} "
        f"tokens, 32 new), {wall:.2f} s wall; wave 2 mapped {warm} prompt tokens, "
        f"{pc['hit_blocks']} blocks hit, {pc['prefix_skipped_tokens']} "
        f"prefill tokens skipped, {pc['cow_copies']} COW copies, "
        f"{pc['evictions']} evictions; ttft warm {line['ttft_warm_ms']:.1f} ms vs cold "
        f"{line['ttft_cold_ms']:.1f} ms ({pc['ttft_warm_over_cold']:.3f}), "
        f"program misses while serving {line['new_misses']}")
    if pc["hit_blocks"] <= 0 or min(warm) <= 0:
        raise AssertionError(f"prefix: wave 2 hit no cached block {warm}")
    if pc["cow_copies"]:
        raise AssertionError(f"prefix: {pc['cow_copies']} copy-on-write "
                             f"copies: admission shared a page a row writes")
    if line["new_misses"]:
        raise AssertionError(f"prefix: {line['new_misses']} new program "
                             f"signatures after warmup")
    del eng
    return outs, prompts, line


# ---------------------------------------------------------------------------
# phases 5s and 5beam: speculative serving and beam search
# ---------------------------------------------------------------------------


def cli_draft(cfg):
    """The reference CLI's draft (``examples/serve.py:1107-1113``): half
    the width, one layer, half the heads and KV heads, half the FFN, the
    same vocabulary; random weights from seed 1."""
    import dataclasses

    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.models.llama import init_params

    dcfg = dataclasses.replace(cfg, dim=cfg.dim // 2, n_layers=1,
                               n_heads=cfg.n_heads // 2,
                               n_kv_heads=max(1, cfg.n_kv_heads // 2),
                               ffn_dim=cfg.ffn_dim // 2)
    return Generator(dcfg, max_seq=2048), init_params(dcfg, seed=1)


def first_difference(params, cfg, prompt, a, b, temperature):
    """(position, logit gap) where token streams ``a`` and ``b`` first
    differ: the plain forward's logit of a's token minus b's at that
    position, over the temperature; (None, None) where they agree."""
    import torch

    from triton_dist_tpu_torch.models.generate import _prompt_forward

    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if n is None:
        return None, None
    seq = np.concatenate([np.asarray(prompt), np.asarray(a[:n])])
    with torch.no_grad():
        _, logits = _prompt_forward(params, torch.as_tensor(
            seq[None], device="cuda"), cfg=cfg, plain=True)
    row = logits[0, -1]
    return n, float(row[a[n]] - row[b[n]]) / temperature


def spec_phase(cfg, params, gen, counters, float_streams, sampled5):
    """Phase 5s: phase 5's mix (with its sampled request) through
    ``ServeEngine(draft=, draft_params=, spec_k=SPEC_K)`` after
    ``warmup()``: (a) the target as its own draft (the reference's
    ``scripts/bench_serve.py:333-356``; the prefix cache off, so a second
    pass of the mix repeats the first's schedule exactly), (b) the
    reference CLI's draft at a fixed k (``spec_adaptive=0``: every round
    proposes k, nearly every proposal is rejected), (c) the same draft
    with ``spec_adaptive=8`` (the default).  Gates: every request
    finishes; the greedy streams' teacher-forced agreement (phase 5's
    floors); the sampled request draws the same stream in both passes of
    (a); no program signature after warmup; the paged decode kernel's
    launches equal the layers times the verify and decode calls (one
    launch a call: phase 3's "T5 verify" case shows the verify's shape
    launching its kernel alone).
    Then ``SpeculativeGenerator`` (batch 2, a 512-token prompt, 32 new
    tokens, self-draft: the Generator's verify through the multi-token
    contiguous decode), its agreement gated alike.  Returns the launch
    counts and the lines."""
    import dataclasses

    import torch

    from triton_dist_tpu_torch.models.speculative import (
        SpeculativeGenerator,
    )

    draft, dparams = cli_draft(cfg)
    runs = {"self": dict(draft=gen, draft_params=params, prefix_cache=False),
            "cli": dict(draft=draft, draft_params=dparams, spec_adaptive=0),
            "cli_adaptive": dict(draft=draft, draft_params=dparams)}
    launches, lines = {}, {}
    for tag, kw in runs.items():
        with torch.no_grad():
            eng, reqs, outs, prompts, line = engine_phase(
                cfg, params, gen, tag=f"spec engine ({tag})", sampled=True,
                warmup=True, counters=list(counters.values()),
                spec_k=SPEC_K, **kw)
        launches[tag] = {n: fn.launches for n, fn in counters.items()}
        m = eng.metrics
        sp = m.spec_stats()
        L = cfg.n_layers
        verify_calls = L * m.spec_dispatches
        decode_calls = L * (m.spec_dispatches + m.decode_steps)
        line.update(accept=sp["accept_rate"],
                    rolling_accept=sp["rolling_accept_rate"],
                    tokens_per_dispatch=sp["spec_tokens_per_dispatch"],
                    chosen_k=sp["chosen_k"], rounds=sp["rounds"],
                    verify_calls=verify_calls)
        log(f"spec engine ({tag}) ({smi_line()}): k {SPEC_K}, accepted "
            f"{sp['accepted']}/{sp['proposed']} = {sp['accept_rate']:.4f} "
            f"(rolling {sp['rolling_accept_rate']:.4f}), {sp['rounds']} "
            f"rounds in {sp['spec_dispatches']} dispatches, "
            f"{sp['spec_tokens_per_dispatch']:.3f} tokens a dispatch, "
            f"chosen k {sp['chosen_k']}; tok/s {line['tok_s']:.1f}, ttft "
            f"{line['ttft_ms']:.1f} ms, itl {line['itl_ms']:.2f} ms; "
            f"launches {launches[tag]} (verify attention calls "
            f"{verify_calls}, decode attention calls {decode_calls})")
        if line["new_misses"]:
            raise AssertionError(f"spec engine ({tag}): {line['new_misses']}"
                                 f" new program signatures after warmup")
        if eng._spec_fused_fn.graphs != 2 * len(eng._k_ladder):
            raise AssertionError(
                f"spec engine ({tag}): {eng._spec_fused_fn.graphs} fused "
                f"round graphs, expected one a (k rung, sampler) of "
                f"{eng._k_ladder}")
        if launches[tag]["decode_paged"] != verify_calls + decode_calls:
            raise AssertionError(
                f"spec engine ({tag}): {launches[tag]['decode_paged']} "
                f"paged decode launches for {verify_calls} verify and "
                f"{decode_calls} decode attention calls")
        if not verify_calls:
            raise AssertionError(f"spec engine ({tag}): no verify ran")
        check_agreement(f"spec engine ({tag})", [
            teacher_forced_agreement(params, cfg, p,
                                     outs[r.request_id].token_ids)
            for r, p in zip(reqs, prompts)], STRICT_MIN)
        match = []
        for rid, fl in float_streams.items():
            s_toks, n = outs[rid].token_ids, 0
            while n < min(len(fl), len(s_toks)) and fl[n] == s_toks[n]:
                n += 1
            match.append(n / len(fl))
        sampled = outs[SAMPLED_REQ].token_ids
        pos, gap = first_difference(params, cfg, prompts[0][:300], sampled,
                                    sampled5, 0.8)
        same = sum(x == y for x, y in zip(sampled, sampled5))
        log(f"spec engine ({tag}) vs engine (no draft): mean greedy prefix "
            f"match {np.mean(match):.4f}; sampled request agrees at "
            f"{same}/{len(sampled5)} positions"
            + ("" if pos is None else
               f", first difference at {pos} (plain-forward logit gap of "
               f"the two tokens over the temperature {gap:.4f})"))
        if tag == "self":
            # the same configuration's second pass of the mix
            outs2 = {}
            with torch.no_grad():
                sub, steps = 0, 0
                allr = [dataclasses.replace(
                    eng._states[rid].req, request_id=f"{rid}+2",
                    arrival_time=None)
                    for rid in [r.request_id for r in reqs] + [SAMPLED_REQ]]
                while eng.has_work() or sub < len(allr):
                    if steps % 2 == 0 and sub < len(allr):
                        eng.submit(allr[sub])
                        sub += 1
                    for o in eng.step():
                        outs2[o.request_id] = o
                    steps += 1
            again = outs2[f"{SAMPLED_REQ}+2"].token_ids
            log(f"spec engine (self): the sampled request's second pass "
                f"{'equal' if again == sampled else 'DIFFERS'} over "
                f"{len(sampled)} tokens")
            if again != sampled:
                raise AssertionError(f"spec engine (self): the sampled "
                                     f"request drew {again}, then "
                                     f"{sampled}")
        lines[tag] = line
        del eng, outs
        free_cuda()

    # SpeculativeGenerator: the Generator's batched verify (row 2 at T 5)
    for fn in counters.values():
        fn.launches = 0
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, cfg.vocab, size=(2, 512)).astype(np.int64)
    t0 = time.perf_counter()
    with torch.no_grad():
        toks, st = SpeculativeGenerator(gen, gen, k=SPEC_K).generate(
            params, params, prompt, 32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["generator"] = {n: fn.launches for n, fn in counters.items()}
    log(f"spec generator (self-draft, batch 2, 512 + 32): {dt:.2f} s, "
        f"{st['target_passes']} target passes, accepted {st['accepted']}/"
        f"{st['proposed']}; launches {launches['generator']}")
    check_agreement("spec generator", [
        teacher_forced_agreement(params, cfg, prompt[b],
                                 toks[b].cpu().numpy()) for b in range(2)],
        STRICT_MIN)
    if launches["generator"]["decode"] <= 0:
        raise AssertionError("spec generator: the decode kernel never "
                             "launched")
    return launches, lines


def beam_phase(cfg, params, gen):
    """Phase 5beam: ``beam_search_paged`` and ``beam_search`` at
    Llama-3-8B, 4 beams over a 1,024-token prompt, 32 new tokens (page
    16).  Gates: copy-on-write copies > 0, 64 shared prompt pages, every
    block back at the end, and the two paths' winners equal or a
    near-tie (their total log-probs within NEAR_TIE).  Printed: each
    path's wall and the paged path's peak KV bytes against the
    contiguous path's."""
    import torch

    from triton_dist_tpu_torch.models.beam import (
        beam_search,
        beam_search_paged,
    )

    B, n_new, page = 4, 32, 16
    prompt = np.random.default_rng(17).integers(0, cfg.vocab,
                                                size=(1, 1024))
    stats = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        paged, p_score = beam_search_paged(gen, params, prompt, n_new,
                                           num_beams=B, page_size=page,
                                           stats=stats)
        torch.cuda.synchronize()
        t_paged = time.perf_counter() - t0
        t0 = time.perf_counter()
        contig, c_score = beam_search(gen, params, prompt, n_new,
                                      num_beams=B)
        torch.cuda.synchronize()
        t_contig = time.perf_counter() - t0
    row_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    paged_peak = stats["peak_used"] * page * row_bytes
    contig_alloc = B * gen.max_seq * row_bytes
    contig_used = B * (1024 + n_new) * row_bytes
    same = torch.equal(paged, contig)
    log(f"beams ({smi_line()}): 4 beams, 1,024 + {n_new}: paged "
        f"{t_paged:.2f} s, contiguous {t_contig:.2f} s; winners "
        f"{'equal' if same else 'differ'} (scores {p_score:.4f} vs "
        f"{c_score:.4f}); paged peak KV {paged_peak / 2**20:.1f} MiB "
        f"({stats['peak_used']} of {stats['num_blocks']} blocks), "
        f"contiguous {contig_used / 2**20:.1f} MiB used of "
        f"{contig_alloc / 2**20:.1f} MiB allocated; {stats['cow_copies']} "
        f"COW copies, {stats['shared_prompt_pages']} shared prompt pages")
    if stats["cow_copies"] <= 0:
        raise AssertionError("beams: no copy-on-write copy")
    if stats["shared_prompt_pages"] != 1024 // page or stats["leaked_blocks"]:
        raise AssertionError(f"beams: block accounting {stats}")
    if not same and abs(p_score - c_score) > NEAR_TIE:
        raise AssertionError(f"beams: winners differ at a log-prob gap "
                             f"{abs(p_score - c_score):.4f}")
    return dict(paged_s=t_paged, contig_s=t_contig, same=same,
                paged_peak_bytes=paged_peak, contig_used_bytes=contig_used,
                **stats)


# ---------------------------------------------------------------------------
# phases 13-14: sequence-parallel serving over SP ranks
# ---------------------------------------------------------------------------


def forced_agreement(gen, params, state, served, near_tie=NEAR_TIE):
    """Teacher-force ``served`` [B, n] greedy tokens through ``gen`` from
    ``state``: the argmax of each step's logits against the served token
    (a mismatch within ``near_tie`` of the maximum counts as a tie).
    Returns (exact, ties, positions)."""
    import torch

    served = torch.as_tensor(np.asarray(served), device="cuda")
    exact = ties = 0
    logits = state.last_logits
    for t in range(served.shape[1]):
        tok = served[:, t]
        pred = logits.argmax(-1)
        gap = (logits.gather(1, pred[:, None])
               - logits.gather(1, tok[:, None].long()))[:, 0]
        exact += int((pred == tok).sum())
        ties += int((gap <= near_tie).sum())
        state = gen.step(params, state, tok)
        logits = state.last_logits
    return exact, ties, served.numel()


def replay_ms(gen, params, state, served, warm=8):
    """Wall ms per decode step of ``gen`` fed ``served`` [B, n] from
    ``state``, no host sync inside the loop, after ``warm`` steps: the
    one timing loop both generators of phase 13 go through.  The steps
    rewrite the K/V rows the same tokens already wrote."""
    import torch

    served = torch.as_tensor(np.asarray(served), device="cuda")
    for t in range(served.shape[1]):
        if t == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state = gen.step(params, state, served[:, t])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (served.shape[1] - warm)


def sp_generator_phase(cfg, params):
    """Phase 13: ``Generator(mesh=World(SP), max_seq=SP_MAX_SEQ)`` on
    phase 4's weights: batch 2, a 7,000-token prompt (rank 3's span holds
    856 prompt rows) through ``prefill_chunked`` at 512 (per-rank flash
    partials merged by the combine kernel), then 32 greedy tokens (one
    folded decode launch and one combine launch per layer and step).
    The world-1 Generator takes the same prompt, then the SP tokens
    teacher-forced: its argmax agrees with them at the dense gates; decode
    ms per step of both at the same context, through one timing loop."""
    import torch

    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab, size=(2, 7000)).astype(np.int64)
    res = {}
    for tag, mesh in (("sp", get_world(SP, "cuda")), ("world1", None)):
        gen = Generator(cfg, mesh=mesh, max_seq=SP_MAX_SEQ)
        gen.prefill_chunked(params, prompt[:, :1024], chunk_size=512)
        torch.cuda.synchronize()              # warm-up: the chunk's shapes
        t0 = time.perf_counter()
        st = gen.prefill_chunked(params, prompt, chunk_size=512)
        torch.cuda.synchronize()
        res[tag] = dict(gen=gen, state=st,
                        prefill_ms=(time.perf_counter() - t0) * 1e3)
    sp, w1 = res["sp"], res["world1"]
    d0 = (sp["state"].last_logits - w1["state"].last_logits).abs().max()
    toks, st = sp["gen"].generate(params, sp["state"], 32)
    toks = toks.cpu().numpy()
    if toks.shape != (2, 32) or not torch.isfinite(st.last_logits).all():
        raise AssertionError(f"sp generator: bad output {toks.shape}")
    counts = forced_agreement(w1["gen"], params, w1["state"], toks)
    # both decodes through one timing loop, twice in turn (the first pass
    # warms the allocator); the second pass is reported
    for _ in range(2):
        sp_ms = replay_ms(sp["gen"], params, sp["state"], toks)
        w1_ms = replay_ms(w1["gen"], params, w1["state"], toks)
    tok = torch.as_tensor(toks[:, -1], device="cuda")
    for tag, r, ms in (("SP", sp, sp_ms), ("world 1", w1, w1_ms)):
        busy, top = profile_once(
            lambda: r["gen"].step(params, r["state"], tok), top_n=8)
        combine = sum(t for name, _, t in top if "sp_combine" in name)
        log(f"sp generator, one {tag} decode step profiled: device busy "
            f"{busy:.2f} ms, idle share {1 - busy / ms:.3f} of the "
            f"{ms:.2f} ms step, sp_combine {combine:.3f} ms")
        for name, n, t in top:
            log(f"sp generator {tag:>7}  {t:7.3f} ms  x{n:<4d} {name[:80]}")
    log(f"sp generator: SP {SP}, max_seq {SP_MAX_SEQ}, prompt 2 x 7000 "
        f"(rank 3 holds {7000 - 3 * SP_MAX_SEQ // SP} prompt rows): "
        f"prefill_chunked(512) {sp['prefill_ms']:.1f} ms (world 1 "
        f"{w1['prefill_ms']:.1f} ms), last prefill logits max |SP - world "
        f"1| {d0.item():.4f}; decode at context 7008-7032: SP {sp_ms:.2f} "
        f"ms/step, world 1 {w1_ms:.2f} ms/step (the same tokens, one loop) "
        f"= {sp_ms / w1_ms:.3f}x")
    check_agreement("sp generator vs world 1", [counts], STRICT_MIN)
    return dict(sp_ms=sp_ms, w1_ms=w1_ms)


def sp_engine_phase(cfg, params, mesh):
    """Phase 14 (``mesh`` a World of SP ranks; None: the world-1 engine
    on the same mix, for the comparison): ``ServeEngine(kv_shard="seq")``
    with phase 5's knobs (page 16, 8 slots, prefill chunk 512) at max_seq
    SP_MAX_SEQ and 4,096 blocks (8.6 GB of pools): 8 requests of 300..7000
    prompt tokens (two past 6,144, so every partition holds pages) and
    32..64 new tokens, one every 2 steps.  Every request must finish, and
    under SP every partition must hold a page during the run.  Returns
    (streams by request id, prompts, summary line dict)."""
    import torch

    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.serve import (
        FinishReason,
        Request,
        SamplingParams,
        ServeEngine,
    )

    tag = "sp engine" if mesh is not None else "sp engine world-1 twin"
    rng = np.random.default_rng(14)
    lens = rng.permutation([300, 1200, 2300, 3400, 4500, 5600, 6400, 7000])
    news = rng.integers(32, 65, size=8)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)) for n in lens]
    gen = Generator(cfg, max_seq=SP_MAX_SEQ)
    eng = ServeEngine(gen, params, num_blocks=4096, page_size=16,
                      max_batch=8, prefill_chunk=512, mesh=mesh,
                      kv_shard="seq")
    reqs = [Request(f"r{i}", p, SamplingParams(max_new_tokens=int(n)))
            for i, (p, n) in enumerate(zip(prompts, news))]
    parts = set()
    t0 = time.perf_counter()
    outs, sub, steps = {}, 0, 0
    while eng.has_work() or sub < len(reqs):
        if steps % 2 == 0 and sub < len(reqs):
            eng.submit(reqs[sub])
            sub += 1
        for o in eng.step():
            outs[o.request_id] = o
        for rid in list(eng.bm._tables):
            parts |= {eng.bm.part_of_block(b) for b in eng.bm.table(rid)}
        steps += 1
        if steps > 2000:
            raise AssertionError(f"{tag} did not drain in 2000 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.metrics.summary()
    lat = s["latency"]
    n_out = sum(len(o.token_ids) for o in outs.values())
    line = dict(tok_s=n_out / wall, wall_s=wall, steps=steps,
                ttft_ms={k: lat["ttft"][k] * 1e3 for k in ("mean", "p50",
                                                          "p99")},
                itl_ms={k: lat["itl"][k] * 1e3 for k in ("mean", "p50",
                                                        "p99")},
                step_ms={k: lat["step"][k] * 1e3 for k in ("p50", "p99")},
                preemptions=s["preemptions"], partitions=sorted(parts))
    log(f"{tag}: {len(outs)} requests, prompts {sorted(lens.tolist())}, "
        f"{s['prefill_tokens']} prefill + {n_out} generated tokens in "
        f"{steps} steps, {wall:.2f} s wall ({line['tok_s']:.1f} tok/s); "
        f"ttft ms {_fmt(line['ttft_ms'])}, itl ms {_fmt(line['itl_ms'])}, "
        f"step ms {_fmt(line['step_ms'])}, preemptions {s['preemptions']}, "
        f"partitions that held pages {sorted(parts)}")
    for i, r in enumerate(reqs):
        o = outs.get(r.request_id)
        if (o is None or o.finish_reason is not FinishReason.LENGTH
                or len(o.token_ids) != int(news[i])):
            raise AssertionError(f"{tag}: {r.request_id} did not finish "
                                 f"({o and o.finish_reason})")
    if mesh is not None and parts != set(range(SP)):
        raise AssertionError(f"{tag}: partitions {sorted(parts)} held pages,"
                             f" not all {SP}")
    streams = {rid: list(o.token_ids) for rid, o in outs.items()}
    del eng, outs
    free_cuda()
    return streams, {r.request_id: p for r, p in zip(reqs, prompts)}, line


def _fmt(d):
    return "{" + ", ".join(f"{k} {v:.1f}" for k, v in d.items()) + "}"


def sp_phases(cfg, params):
    """Phases 13-14 on phase 4's weights, every launch counter zeroed just
    before and read just after; the SP engine's served tokens held to a
    world-1 teacher-forced forward (the flash kernel over prompt + served
    tokens) at the dense gates, the world-1 engine on the same mix run
    once beside (its agreement under the same reference, the greedy
    prefix match between the two).  Returns the phases' launch counts."""
    import torch

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd
    from triton_dist_tpu_torch.models.generate import _prompt_forward
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    counters = {"flash_fwd": fa.flash_attention,
                "decode": fd.gqa_decode_shard,
                "decode_paged": fd.gqa_decode_paged_shard,
                "sp_combine": fd.sp_combine_shard}
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        gen_line = sp_generator_phase(cfg, params)
        after_gen = {n: fn.launches for n, fn in counters.items()}
        free_cuda()
        streams, prompts, line = sp_engine_phase(cfg, params,
                                                 get_world(SP, "cuda"))
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"launches: sp generator {after_gen}, sp generator+engine "
        f"{launches}")
    for n in ("decode", "sp_combine"):
        if after_gen[n] <= 0:
            raise AssertionError(f"kernel {n} never launched by the SP "
                                 f"generator")
    for n in ("flash_fwd", "decode_paged", "sp_combine"):
        if launches[n] - after_gen[n] <= 0:
            raise AssertionError(f"kernel {n} never launched by the SP "
                                 f"engine")
    with torch.no_grad():
        w1_streams, _, w1_line = sp_engine_phase(cfg, params, None)

        def world1_logits(toks):
            return _prompt_forward(params, toks, cfg=cfg)[1]

        counts = {"sp": [], "world1": []}
        for rid, p in prompts.items():
            for tag, got in (("sp", streams), ("world1", w1_streams)):
                counts[tag].append(teacher_forced_agreement(
                    params, cfg, p, got[rid], logits_fn=world1_logits))
    check_agreement("sp engine world-1 twin vs world-1 forward",
                    counts["world1"], 0.0)
    check_agreement("sp engine vs world-1 forward", counts["sp"],
                    STRICT_MIN)
    match = []
    for rid, got in streams.items():
        want, n = w1_streams[rid], 0
        while n < min(len(got), len(want)) and got[n] == want[n]:
            n += 1
        match.append(n / len(want))
    log(f"sp engine vs world-1 engine: mean greedy prefix match "
        f"{np.mean(match):.4f} (per request {[round(x, 3) for x in match]})"
        f"; tok/s {line['tok_s']:.1f} vs {w1_line['tok_s']:.1f}, step p50 "
        f"{line['step_ms']['p50']:.1f} vs {w1_line['step_ms']['p50']:.1f} "
        f"ms, itl p50 {line['itl_ms']['p50']:.1f} vs "
        f"{w1_line['itl_ms']['p50']:.1f} ms")
    return launches, dict(generator=gen_line, engine=line,
                          engine_world1=w1_line)


# ---------------------------------------------------------------------------
# phases 15-16: W8A8 tensor parallelism and head-sharded serving over TP
# ranks (on phase 4's weights)
# ---------------------------------------------------------------------------


def w8a8_tp_phase(cfg, params):
    """Phase 15: Llama-3-8B at full width and 32 layers, W8A8 over TP ranks
    of the virtual world, on phase 4's float weights (``quantize_params_
    w8a8`` for TP, ``place_w8a8_params``), tokens [S 2048, B 1] from a
    seed: ``make_w8a8_forward(cfg, TP)`` with the int8 AG-GEMM, matmul_i8
    and flash_fwd counters zeroed just before (each > 0 after), timed and
    profiled (device busy, the int8 AG-GEMM's share); its logits against
    the float world-1 forward (cosine > 0.995; the median relative error
    printed) and its argmax against the same forward over the plain
    versions at the W8A8 floors (ties within QUANT_NEAR_TIE, AGREE_MIN
    with ties, QUANT_STRICT_MIN exact); then once at a ragged S 1,000 (250
    rows per rank: the masked row tail) against the float forward's first
    1,000 positions; then the first W8A8_GATE_LAYERS layers of the same
    weights at S 2048 and 1,000 at both W8A8 gates (median relative error
    < 0.05, cosine > 0.995).  Returns the forward's launch counts and its
    line."""
    from dataclasses import replace

    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import quant
    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models import llama_w8a8 as lw

    rng = np.random.default_rng(15)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(TRAIN_SEQ, 1)),
                          device="cuda")
    counters = {"ag_gemm_i8": agm.ag_gemm_i8, "matmul_i8": quant.matmul_i8,
                "flash_fwd": fa.flash_attention}

    def against_float(tag, got, ref, rel_gate=True):
        rel = ((got - ref).abs() / (ref.abs() + 1e-2)).median().item()
        cos = ((got * ref).sum() / (got.norm() * ref.norm())).item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"{tag} vs the float world-1 forward: median relative error "
            f"{rel:.4f} ({'tol 0.05' if rel_gate else 'not gated'}), "
            f"cosine {cos:.5f} (tol 0.995), argmax agreement {agree:.4f}")
        if not (torch.isfinite(got).all() and cos > 0.995
                and (rel < 0.05 or not rel_gate)):
            raise AssertionError(f"{tag}: against float {rel:.4f}, {cos:.5f}")

    with torch.no_grad():
        ref = llama.make_forward(cfg)(params, tok)
        t0 = time.perf_counter()
        qp = lw.place_w8a8_params(lw.quantize_params_w8a8(params, cfg, TP),
                                  cfg, TP)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        free_cuda()
        fwd = lw.make_w8a8_forward(cfg, TP)
        for fn in counters.values():
            fn.launches = 0
        quant.matmul_i8.mode_launches.update(wg=0, split_k=0)
        zero_off_path_counters()
        t0 = time.perf_counter()
        logits = fwd(qp, tok)
        torch.cuda.synchronize()
        t_first = (time.perf_counter() - t0) * 1e3
        launches = {n: fn.launches for n, fn in counters.items()}
        i8_modes = dict(quant.matmul_i8.mode_launches)
        record_model_path("w8a8_tp_forward")
        t0 = time.perf_counter()
        fwd(qp, tok)
        torch.cuda.synchronize()
        t_warm = (time.perf_counter() - t0) * 1e3
        busy, top = profile_once(lambda: fwd(qp, tok), top_n=12)
        plain = lw.make_w8a8_forward(cfg, TP, plain=True)(qp, tok)
    ag_ms = sum(ms for name, _, ms in top if "ag_gemm" in name)
    i8_ms = sum(ms for name, _, ms in top if "matmul_i8" in name)
    log(f"w8a8 tp forward: TP {TP}, {cfg.n_layers} layers, tokens "
        f"[{TRAIN_SEQ}, 1] (quantized and placed in {t_quant:.1f} s): first "
        f"call {t_first:.1f} ms, warm {t_warm:.1f} ms wall; profiled: "
        f"device busy {busy:.2f} ms, int8 AG-GEMM {ag_ms:.2f} ms "
        f"({ag_ms / busy:.3f} of it), matmul_i8 {i8_ms:.2f} ms "
        f"({i8_ms / busy:.3f}), idle share {1 - busy / t_warm:.3f}; "
        f"launches {launches}, matmul_i8 by kernel {i8_modes}")
    for name, n, ms in top:
        log(f"w8a8 tp forward   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} never launched by the W8A8 TP "
                                 f"forward")
    if tuple(logits.shape) != (TRAIN_SEQ, 1, cfg.vocab):
        raise AssertionError(f"w8a8 tp forward: logits "
                             f"{tuple(logits.shape)}")
    # the quantization error accumulates with depth: at 32 layers the
    # cosine holds the W8A8 gate and the median relative error is printed
    # (0.0719 on the first run, NVIDIA H100 80GB HBM3, 700 W: PERF.md);
    # both gates hold the first W8A8_GATE_LAYERS layers of the weights
    against_float("w8a8 tp forward", logits, ref, rel_gate=False)
    exact, ties = argmax_agreement(
        "w8a8 tp forward, kernels vs plain versions", logits, plain,
        near_tie=QUANT_NEAR_TIE)
    if ties < AGREE_MIN or exact < QUANT_STRICT_MIN:
        raise AssertionError(f"w8a8 tp forward vs plain: {exact:.4f} exact "
                             f"(floor {QUANT_STRICT_MIN}), {ties:.4f} with "
                             f"near-ties (floor {AGREE_MIN})")
    del logits, plain
    free_cuda()
    with torch.no_grad():
        n0 = agm.ag_gemm_i8.launches
        ragged = fwd(qp, tok[:1000])
        torch.cuda.synchronize()
    log(f"w8a8 tp forward, ragged S 1000 ({1000 // TP} rows per rank): "
        f"{agm.ag_gemm_i8.launches - n0} int8 AG-GEMM launches")
    if tuple(ragged.shape) != (1000, 1, cfg.vocab):
        raise AssertionError(f"w8a8 ragged: logits {tuple(ragged.shape)}")
    against_float("w8a8 tp forward, ragged S 1000", ragged, ref[:1000],
                  rel_gate=False)
    del ragged, ref, qp
    free_cuda()
    cut = dict(params, layers=params["layers"][:W8A8_GATE_LAYERS])
    cfg_cut = replace(cfg, n_layers=W8A8_GATE_LAYERS)
    with torch.no_grad():
        qp = lw.place_w8a8_params(lw.quantize_params_w8a8(cut, cfg_cut, TP),
                                  cfg_cut, TP)
        for n_tok in (TRAIN_SEQ, 1000):
            against_float(f"w8a8 tp forward, first {W8A8_GATE_LAYERS} "
                          f"layers, S {n_tok}", lw.make_w8a8_forward(
                              cfg_cut, TP)(qp, tok[:n_tok]),
                          llama.make_forward(cfg_cut)(cut, tok[:n_tok]))
    del qp
    free_cuda()
    return launches, dict(first_ms=t_first, warm_ms=t_warm, busy_ms=busy,
                          ag_gemm_i8_ms=ag_ms, matmul_i8_ms=i8_ms,
                          matmul_i8_mode_launches=i8_modes)


def heads_phase(cfg, params):
    """Phase 16: phase 5's mix and knobs through ``ServeEngine(mesh=
    World(TP), kv_shard="heads")`` on phase 4's weights, float then
    ``w8a8=True`` (float pools), each beside the world-1 engine on the
    same mix (tok/s, TTFT, ITL of both), every launch counter zeroed just
    before each run; the heads runs launch flash_fwd and decode_paged (and
    matmul_i8 under W8A8).  Every request finishes; the served tokens are
    held to a world-1 teacher-forced forward: the float runs to the flash
    prompt forward at the dense gates, the W8A8 runs to the world-1 W8A8
    model's chunk forward (``quantize_serve_params`` at world 1, the
    hooks on the kernels) at the W8A8 floors.  The sharded trees are freed
    after each run.  Returns the heads runs' launch counts."""
    import functools

    import torch

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd
    from triton_dist_tpu_torch.kernels import quant
    from triton_dist_tpu_torch.models import llama_w8a8 as lw
    from triton_dist_tpu_torch.models.generate import (
        Generator,
        _chunk_forward,
        _prompt_forward,
    )
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    counters = {"flash_fwd": fa.flash_attention,
                "decode_paged": fd.gqa_decode_paged_shard,
                "matmul_i8": quant.matmul_i8}
    gen = Generator(cfg, max_seq=2048)
    world = get_world(TP, "cuda")
    runs, launches = {}, {}
    for tag, mesh, w8a8 in (("world-1", None, False),
                            ("heads", world, False),
                            ("world-1 w8a8", None, True),
                            ("heads w8a8", world, True)):
        for fn in counters.values():
            fn.launches = 0
        with torch.no_grad():
            eng, reqs, outs, prompts, _ = engine_phase(
                cfg, params, gen, w8a8=w8a8, tag=f"{tag} engine", mesh=mesh,
                kv_shard="heads" if mesh is not None else None)
        if mesh is not None:
            launches[tag] = {n: fn.launches for n, fn in counters.items()}
            shards = eng.params["layers"][0]["wq"].shape[0]
            log(f"{tag} engine: weights in {shards} rank shards, pools "
                f"{tuple(eng._pools[0][0].shape)}; launches "
                f"{launches[tag]}")
            need = ("flash_fwd", "decode_paged") + (("matmul_i8",) if w8a8
                                                    else ())
            for n in need:
                if launches[tag][n] <= 0:
                    raise AssertionError(f"kernel {n} never launched by the "
                                         f"{tag} engine")
        lat = eng.metrics.summary()["latency"]
        n_out = sum(len(o.token_ids) for o in outs.values())
        runs[tag] = dict(
            streams={r.request_id: list(outs[r.request_id].token_ids)
                     for r in reqs},
            prompts={r.request_id: p for r, p in zip(reqs, prompts)},
            ttft_ms={k: lat["ttft"][k] * 1e3 for k in ("mean", "p50",
                                                        "p99")},
            itl_ms={k: lat["itl"][k] * 1e3 for k in ("mean", "p50",
                                                      "p99")})
        del eng, outs
        free_cuda()
    q1 = lw.quantize_serve_params(params, cfg)

    def w8a8_logits(toks):
        shape = (1, cfg.n_kv_heads, toks.shape[1], cfg.head_dim)
        caches = [(torch.zeros(shape, dtype=cfg.dtype, device="cuda"),
                   torch.zeros(shape, dtype=cfg.dtype, device="cuda"))
                  for _ in range(cfg.n_layers)]
        return _chunk_forward(q1, toks, caches, 0, cfg=cfg,
                              ffn=lw.w8a8_serve_ffn,
                              out_proj=lw.w8a8_serve_out_proj)[1]

    teachers = {False: lambda toks: _prompt_forward(params, toks,
                                                    cfg=cfg)[1],
                True: w8a8_logits}
    with torch.no_grad():
        for tag, run in runs.items():
            w8a8 = "w8a8" in tag
            run["counts"] = [teacher_forced_agreement(
                params, cfg, p, run["streams"][rid],
                logits_fn=teachers[w8a8],
                near_tie=QUANT_NEAR_TIE if w8a8 else NEAR_TIE)
                for rid, p in run["prompts"].items()]
    del q1
    free_cuda()
    for tag, run in runs.items():
        w8a8, twin = "w8a8" in tag, tag.startswith("world-1")
        check_agreement(
            f"{tag} engine vs world-1 {'w8a8 ' if w8a8 else ''}forward",
            run["counts"], 0.0 if twin else (QUANT_STRICT_MIN if w8a8
                                             else STRICT_MIN),
            QUANT_NEAR_TIE if w8a8 else NEAR_TIE)
    for kind in ("", " w8a8"):
        got, want = runs[f"heads{kind}"], runs[f"world-1{kind}"]
        match = []
        for rid, toks in got["streams"].items():
            ref, n = want["streams"][rid], 0
            while n < min(len(toks), len(ref)) and toks[n] == ref[n]:
                n += 1
            match.append(n / len(ref))
        log(f"heads{kind} engine vs world-1{kind} engine: mean greedy "
            f"prefix match {np.mean(match):.4f}; ttft ms "
            f"{_fmt(got['ttft_ms'])} vs {_fmt(want['ttft_ms'])}, itl ms "
            f"{_fmt(got['itl_ms'])} vs {_fmt(want['itl_ms'])}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix=""):
    """(name, leaf) in the order of ``runtime.utils.tree_leaves``."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key],
                                    f"{prefix}.{key}" if prefix else key)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def profile_once(fn, top_n=8):
    """One ``fn()`` under ``torch.profiler``: (device-busy ms — the sum of
    every kernel's and copy's own device time —, the top kernels as
    (name, count, ms))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_dist_tpu_torch.examples.serve import _device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if _device_us(e) > 0]
    busy = sum(_device_us(e) for e in evts) / 1e3
    top = sorted(evts, key=_device_us, reverse=True)[:top_n]
    return busy, [(e.key, e.count, _device_us(e) / 1e3) for e in top]


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def train_phase():
    """Phase 6 (a)-(d); returns the launch counts of (a)."""
    from dataclasses import replace

    import torch

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.models import llama, training

    cfg = llama.LlamaConfig.llama3_8b()
    rng = np.random.default_rng(5)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(TRAIN_SEQ, 1)),
                          device="cuda")
    tgt = torch.roll(tok, -1, dims=0)

    # (a) SGD, all 32 layers, with the launch counters zeroed just before
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"train: llama3_8b {cfg.n_layers} layers, random weights (seed 0) "
        f"in {time.perf_counter() - t0:.1f} s; tokens [{TRAIN_SEQ}, 1]")
    torch.cuda.reset_peak_memory_stats()
    step = llama.make_train_step(cfg, lr=SGD_LR)
    counters = {"flash_fwd": fa.flash_attention,
                "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv}
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        _, loss = step(params, tok, tgt)
        losses.append(float(loss))        # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train (a) SGD lr {SGD_LR}, {cfg.n_layers} layers: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in times]}, peak memory {peak:.2f} GiB; "
        f"launches {launches}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train (a): losses {losses} not finite and "
                             f"falling")
    for n, c in launches.items():     # (d)
        if c <= 0:
            raise AssertionError(f"kernel {n} never launched in training")
    # a fifth step under the profiler: where a step's device time goes
    # (its wall time is inflated by the profiler; the idle share divides
    # by the median unprofiled step)
    busy, top = profile_once(lambda: step(params, tok, tgt))
    wall = float(np.median(times[1:]))
    log(f"train (a) profiled step: device busy {busy:.1f} ms of a "
        f"{wall:.1f} ms step, idle share {1 - busy / wall:.3f}")
    for name, n, ms in top:
        log(f"train (a)   {ms:8.2f} ms  x{n:<5d} {name[:90]}")
    del params, step
    free_cuda()

    # (b) AdamW, 8 layers
    cfg8 = replace(cfg, n_layers=8)
    params = llama.init_params(cfg8, seed=0)
    torch.cuda.reset_peak_memory_stats()
    step, init = training.make_optim_train_step(llama, cfg8,
                                                training.adamw(ADAMW_LR))
    opt = init(params)
    losses, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        _, _, loss = step(params, opt, tok, tgt)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train (b) AdamW lr {ADAMW_LR}, 8 layers: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in times]}, peak memory {peak:.2f} GiB")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train (b): losses {losses} not falling")
    del params, step, opt
    free_cuda()

    # (c) one step's loss and gradients, kernels vs plain attention
    cfg2 = replace(cfg, n_layers=2)
    params = llama.init_params(cfg2, seed=0)
    loss_k, g_k = training.make_grads(llama, cfg2)(params, tok, tgt)
    loss_p, g_p = training.make_grads(llama, cfg2, plain=True)(params, tok,
                                                               tgt)
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = ("", 0.0)
    for (name, a), (_, b) in zip(named_leaves(g_k), named_leaves(g_p)):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        if not rel <= 2e-2:
            raise AssertionError(f"train (c): gradient {name} relative L2 "
                                 f"{rel:.3e} > 2e-2")
        worst = max(worst, (name, rel), key=lambda x: x[1])
    log(f"train (c) 2 layers, kernels vs plain attention: loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f} (relative "
        f"{rel_loss:.2e}, tol 1e-3); worst gradient leaf {worst[0]} "
        f"relative L2 {worst[1]:.3e} (tol 2e-2)")
    if not rel_loss <= 1e-3:
        raise AssertionError(f"train (c): loss relative {rel_loss:.2e}")
    del params, g_k, g_p
    free_cuda()
    return launches


# ---------------------------------------------------------------------------
# phases 7-10: the MoE family (Mixtral-8x7B widths)
# ---------------------------------------------------------------------------


def moe_noise_floor(params, cfg, tok):
    """What routing does to bf16 rounding: one forward with the kernels and
    one with the plain versions, each recording the experts every layer
    picked; the tokens whose top-2 expert set differs between the two at
    each layer, then max |d logit| and argmax agreement.  Returns (argmax
    agreement, max |d logit|)."""
    import torch

    from triton_dist_tpu_torch.models import moe

    routes_k, routes_p = [], []
    with torch.no_grad():
        lk, _ = moe.make_forward(cfg)(params, tok, routes=routes_k)
        lp, _ = moe.make_forward(cfg, plain=True)(params, tok,
                                                  routes=routes_p)
    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for a, b in zip(routes_k, routes_p)]
    lk, lp = lk.reshape(-1, cfg.vocab), lp.reshape(-1, cfg.vocab)
    diff = (lk - lp).abs()
    top2 = torch.topk(lp, 2, dim=-1).values
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"moe noise floor: {cfg.n_layers}-layer forward, kernels vs plain "
        f"versions: max |d logit| {diff.max().item():.4f}, mean "
        f"{diff.mean().item():.4f}, argmax agreement {agree:.4f}; reference "
        f"logit std {lp.std().item():.4f}, median top-2 gap "
        f"{(top2[:, 0] - top2[:, 1]).median().item():.4f}; tokens (of "
        f"{lk.shape[0]}) whose top-{cfg.topk} expert set differs, per layer: "
        f"{flips}")
    return agree, diff.max().item(), lk, routes_k


def moe_forward_phase(cfg, params, tok):
    """Phase 7: ``make_forward`` at 16 layers, S 2048, B 1, with the
    grouped-GEMM and all-to-all counters zeroed just before; then a
    profiled forward and the noise floor.  Returns (the launch counts, the
    kernels' logits [S, vocab] and routes, for phase 7b)."""
    import torch

    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.models import moe

    fwd = moe.make_forward(cfg)
    counters = {"group_gemm": gg.group_gemm,
                "all_to_all": a2a.fast_all_to_all_shard}
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, aux = fwd(params, tok)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    if (tuple(logits.shape) != (tok.shape[0], 1, cfg.vocab)
            or not torch.isfinite(logits).all() or not np.isfinite(
                float(aux))):
        raise AssertionError(f"moe forward: bad output {tuple(logits.shape)}"
                             f", aux {float(aux)}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} never launched by the MoE "
                                 f"forward")
    with torch.no_grad():
        t0 = time.perf_counter()
        fwd(params, tok)
        torch.cuda.synchronize()
        t_warm = (time.perf_counter() - t0) * 1e3
        busy, top = profile_once(lambda: fwd(params, tok), top_n=12)
    gg_ms = sum(ms for name, _, ms in top if "group_gemm" in name)
    log(f"moe forward: {cfg.n_layers} layers, tokens [{tok.shape[0]}, 1]: "
        f"aux {float(aux):.4f}, first call {t_first * 1e3:.1f} ms, warm "
        f"{t_warm:.1f} ms wall; profiled: device busy {busy:.2f} ms, "
        f"grouped GEMMs {gg_ms:.2f} ms ({gg_ms / busy:.3f} of it); "
        f"launches {launches}")
    for name, n, ms in top:
        log(f"moe forward   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    del logits
    agree, dmax, ref, routes = moe_noise_floor(params, cfg, tok)
    if agree < MOE_ARGMAX_MIN:
        raise AssertionError(f"moe forward: argmax agreement with the plain "
                             f"versions {agree:.4f} < {MOE_ARGMAX_MIN}")
    return launches, ref, routes


def moe_ep_forward_phase(cfg, params, tok, ref, routes):
    """Phase 7b: phase 7's tree sharded over EP ranks (``shard_params``:
    the expert stacks and replicated leaves shared, the attention weights
    cut) and ``make_forward(cfg, EP)`` with the all-to-all, grouped-GEMM
    and ring counters zeroed just before (each > 0 after), timed and
    profiled (device ms, idle share, the grouped GEMMs', all-to-all's and
    ring kernels' shares); then, routing pinned to phase 7's routes, its
    argmax against the world-1 forward's, beside the same comparison of the
    world-1 forward with the plain versions of every kernel, pinned alike
    (the noise floor); gated at STRICT_MIN exact and AGREE_MIN counting
    near-ties within NEAR_TIE.  Returns the launch counts."""
    import torch

    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.models import moe

    counters = {"all_to_all": a2a.fast_all_to_all_shard,
                "group_gemm": gg.group_gemm, "ag_gemm": agm.ag_gemm_shard,
                "gemm_rs": grs.gemm_rs_shard}
    p4 = moe.shard_params(params, cfg, EP)
    fwd = moe.make_forward(cfg, EP)
    for fn in counters.values():
        fn.launches = 0
    routes_ep = []
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, aux = fwd(p4, tok, routes=routes_ep)
        torch.cuda.synchronize()
        t_first = (time.perf_counter() - t0) * 1e3
    launches = {n: fn.launches for n, fn in counters.items()}
    if (tuple(logits.shape) != (tok.shape[0], 1, cfg.vocab)
            or not torch.isfinite(logits).all() or not np.isfinite(
                float(aux))):
        raise AssertionError(f"moe ep forward: bad output "
                             f"{tuple(logits.shape)}, aux {float(aux)}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} never launched by the EP "
                                 f"forward")
    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for a, b in zip(routes_ep, routes)]
    del logits, routes_ep
    with torch.no_grad():
        t0 = time.perf_counter()
        fwd(p4, tok)
        torch.cuda.synchronize()
        t_warm = (time.perf_counter() - t0) * 1e3
        busy, top = profile_once(lambda: fwd(p4, tok), top_n=1000)

    def share(*keys):
        return sum(ms for name, _, ms in top if any(k in name for k in keys))

    gg_ms, a2a_ms = share("group_gemm"), share("a2a_")
    ring_ms = share("ag_gemm", "gemm_rs")
    log(f"moe ep forward: EP {EP} (TP attention, expert-parallel FFN), "
        f"{cfg.n_layers} layers, tokens [{tok.shape[0]}, 1]: aux "
        f"{float(aux):.4f}, first call {t_first:.1f} ms, warm {t_warm:.1f} "
        f"ms wall; profiled: device busy {busy:.2f} ms, idle share "
        f"{1 - busy / t_warm:.3f}; grouped GEMMs {gg_ms:.2f} ms "
        f"({gg_ms / busy:.3f}), all-to-all {a2a_ms:.2f} ms "
        f"({a2a_ms / busy:.3f}), ring kernels {ring_ms:.2f} ms "
        f"({ring_ms / busy:.3f}); launches {launches}; tokens (of "
        f"{tok.shape[0]}) whose top-{cfg.topk} expert set differs from the "
        f"world-1 forward's, per layer: {flips}")
    for name, n, ms in top[:12]:
        log(f"moe ep forward   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    with torch.no_grad():
        floor, _ = moe.make_forward(cfg, plain=True)(params, tok,
                                                     routes=routes)
        argmax_agreement("moe ep noise floor: world-1 forward, kernels vs "
                         "plain versions, routed alike", floor, ref)
        del floor
        pinned, _ = fwd(p4, tok, routes=routes)
    exact, ties = argmax_agreement(
        f"moe ep forward vs world-1 forward, routed alike ({tok.shape[0]} "
        f"positions)", pinned, ref)
    if ties < AGREE_MIN or exact < STRICT_MIN:
        raise AssertionError(f"moe ep forward: agreement {exact:.4f} exact "
                             f"(floor {STRICT_MIN}), {ties:.4f} with "
                             f"near-ties (floor {AGREE_MIN})")
    del pinned, p4
    return launches


def moe_generator_phase(cfg, params):
    """Phase 8: MoEGenerator, batch 2, a 512-token prompt, 32 greedy
    tokens, with the attention counters zeroed just before; teacher-forced
    agreement against a prompt forward with the plain attention (its FFNs
    run no kernel)."""
    import torch

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd
    from triton_dist_tpu_torch.models.generate_moe import (
        MoEGenerator,
        _moe_prompt_forward,
    )

    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, size=(2, 512)).astype(np.int64)
    counters = {"flash_fwd": fa.flash_attention,
                "decode": fd.gqa_decode_shard}
    for fn in counters.values():
        fn.launches = 0
    gen = MoEGenerator(cfg, max_seq=2048)
    with torch.no_grad():
        t0 = time.perf_counter()
        st = gen.prefill(params, prompt)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, st = gen.generate(params, st, 32)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    toks = toks.cpu().numpy()
    if toks.shape != (2, 32) or not torch.isfinite(st.last_logits).all():
        raise AssertionError(f"moe generator: bad output {toks.shape}")
    log(f"moe generator: prefill 2x512 {t_pre * 1e3:.1f} ms, 32 decode "
        f"steps {t_dec * 1e3:.1f} ms ({t_dec / 32 * 1e3:.2f} ms/step); "
        f"launches {launches}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} never launched by the MoE "
                                 f"generator")
    # one more decode step under the profiler: where a step's time goes
    last = torch.as_tensor(toks[:, -1], device="cuda")
    with torch.no_grad():
        busy, top = profile_once(lambda: gen.step(params, st, last))
    log(f"moe generator profiled step: device busy {busy:.2f} ms of a "
        f"{t_dec / 32 * 1e3:.2f} ms step, idle share "
        f"{1 - busy / (t_dec / 32 * 1e3):.3f}")
    for name, n, ms in top:
        log(f"moe generator   {ms:8.3f} ms  x{n:<5d} {name[:90]}")

    def plain(t):
        with torch.no_grad():
            return _moe_prompt_forward(params, t, cfg=cfg, plain=True)[1]

    check_agreement("moe generator", [
        teacher_forced_agreement(params, cfg, prompt[b], toks[b],
                                 logits_fn=plain, near_tie=MOE_NEAR_TIE)
        for b in range(2)], MOE_STRICT_MIN, MOE_NEAR_TIE)


def moe_layer_phase():
    """Phase 9: DistributedMoELayer (E 8, H 4096, F 14336, top-2) at T
    2048 and T 8, bf16 then after quantize_weights(), each against the
    same layer with the plain grouped GEMM (routing given, so both see the
    same experts); the W8A8 output against the float one within the
    reference's tolerance; the same weights in the layer over EP ranks
    ("w4": the all-to-all's peer segments) at T 2048, bf16 and W8A8,
    against its plain versions.  Returns the int8 launch count."""
    import torch

    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.layers.moe_inference import (
        DistributedMoELayer,
    )

    layer = DistributedMoELayer(n_experts=8, topk=2, hidden=4096,
                                intermediate=14336)
    layer.init_weights(seed=0)
    layer_ep = DistributedMoELayer(n_experts=8, topk=2, hidden=4096,
                                   intermediate=14336, world=EP)
    g = torch.Generator(device="cuda").manual_seed(9)
    xs = {T: torch.randn((T, 4096), generator=g, device="cuda").bfloat16()
          for T in (2048, 8)}
    routes = {T: layer.route(x) for T, x in xs.items()}
    gg.group_gemm.launches = gg.group_gemm_i8.launches = 0
    floats = {}
    with torch.no_grad():
        for T, x in xs.items():
            for lay, tag in ((layer, ""), (layer_ep, f" w{EP}")):
                if lay is layer_ep and T != 2048:
                    continue
                lay.weights = layer.weights
                w, e = routes[T]
                got = lay.forward(x, e, w)
                torch.cuda.synchronize()
                want = lay.forward(x, e, w, plain=True)
                err = max_err(got, want)
                top = want.float().abs().max().item()
                l2 = ((got.float() - want.float()).norm()
                      / want.float().norm()).item()
                log(f"moe layer bf16 T{T}{tag}: max|kernel-plain| {err:.3e} "
                    f"(tol {GG_REL_TOL} x {top:.3e}), relative L2 {l2:.3e} "
                    f"(tol {GG_L2_TOL})")
                if not (torch.isfinite(got).all() and err <= GG_REL_TOL * top
                        and l2 <= GG_L2_TOL):
                    raise AssertionError(f"moe layer bf16 T{T}{tag} "
                                         f"disagrees")
                floats[T, tag] = got.float()
        layer.quantize_weights()
        for T, x in xs.items():
            for lay, tag in ((layer, ""), (layer_ep, f" w{EP}")):
                if lay is layer_ep and T != 2048:
                    continue
                lay.weights = layer.weights
                w, e = routes[T]
                got = lay.forward(x, e, w)
                torch.cuda.synchronize()
                want = lay.forward(x, e, w, plain=True)
                ref = floats[T, tag]
                rel = ((got.float() - ref).abs()
                       / (ref.abs() + 1e-2)).median()
                cos = ((got.float() * ref).sum()
                       / (got.float().norm() * ref.norm())).item()
                same = torch.equal(got, want)
                log(f"moe layer w8a8 T{T}{tag}: equal to the plain int8 "
                    f"GEMMs {same}; against float: median relative error "
                    f"{rel.item():.4f} (tol 0.05), cosine {cos:.5f} (tol "
                    f"0.995)")
                if not (same and rel < 0.05 and cos > 0.995):
                    raise AssertionError(f"moe layer w8a8 T{T}{tag} "
                                         f"disagrees")
    launches = {"group_gemm": gg.group_gemm.launches,
                "group_gemm_i8": gg.group_gemm_i8.launches}
    log(f"moe layer launches {launches}")
    if launches["group_gemm_i8"] <= 0:
        raise AssertionError("group_gemm_i8 never launched by the layer")
    return launches["group_gemm_i8"]


def moe_train_phase(cfg, world=1):
    """Phase 10 (world 1) and 10b (``world`` EP ranks: ``shard_params``,
    TP attention and expert-parallel FFNs): (a) MOE_SGD_STEPS in-place SGD
    steps at MOE_TRAIN_LAYERS layers, S 2048, B 1, with the grouped-GEMM
    and all-to-all counters (over EP ranks the ring kernels' too) zeroed
    just before: finite losses, the last below the first, peak memory;
    one more step under the profiler; (b) at 2 layers, the loss and every
    gradient leaf with the kernels against autograd through the plain
    versions of every kernel, the plain side routed as the kernels' side
    was (``routes``: a near-tie would otherwise send a token to another
    expert).  Returns the launch counts of (a)."""
    from dataclasses import replace

    import torch

    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.models import moe
    from triton_dist_tpu_torch.runtime.utils import value_and_grad

    tag = "moe train" if world == 1 else "moe ep train"

    rng = np.random.default_rng(5)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(TRAIN_SEQ, 1)),
                          device="cuda")
    tgt = torch.roll(tok, -1, dims=0)
    cfg8 = replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    params = moe.shard_params(moe.init_params(cfg8, seed=0), cfg8, world)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = moe.make_train_step(cfg8, world, lr=MOE_SGD_LR)
    counters = {"group_gemm": gg.group_gemm, "group_gemm_dx": gg.group_gemm_dx,
                "all_to_all": a2a.fast_all_to_all_shard}
    if world > 1:
        counters.update(ag_gemm=agm.ag_gemm_shard, gemm_rs=grs.gemm_rs_shard)
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(MOE_SGD_STEPS):
        t0 = time.perf_counter()
        _, loss = step(params, tok, tgt)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} (a) SGD lr {MOE_SGD_LR}, world {world}, {cfg8.n_layers} "
        f"layers, tokens [{TRAIN_SEQ}, 1]: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in times]}, peak memory {peak:.2f} GB; "
        f"launches {launches}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{tag} (a): losses {losses} not finite and "
                             f"falling")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} never launched in {tag}")
    busy, top = profile_once(lambda: step(params, tok, tgt), top_n=1000)
    wall = float(np.median(times[1:]))

    def share(*keys):
        return sum(ms for name, _, ms in top if any(k in name for k in keys))

    gg_ms, a2a_ms = share("group_gemm"), share("a2a_")
    ring_ms = share("ag_gemm", "gemm_rs")
    log(f"{tag} (a) profiled step: device busy {busy:.1f} ms of a "
        f"{wall:.1f} ms step, idle share {1 - busy / wall:.3f}; grouped "
        f"GEMM kernels {gg_ms:.1f} ms, all-to-all {a2a_ms:.2f} ms, ring "
        f"kernels {ring_ms:.1f} ms")
    for name, n, ms in top[:10]:
        log(f"{tag} (a)   {ms:8.2f} ms  x{n:<5d} {name[:90]}")
    del params, step
    free_cuda()

    cfg2 = replace(cfg, n_layers=2)
    params = moe.shard_params(moe.init_params(cfg2, seed=0), cfg2, world)
    routes = []
    loss_k, g_k = value_and_grad(moe.loss_shard, params, tok, tgt, cfg2,
                                 world=world, routes=routes)
    loss_p, g_p = value_and_grad(moe.loss_shard, params, tok, tgt, cfg2,
                                 world=world, plain=True, routes=routes)
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = ("", 0.0)
    for (name, a), (_, b) in zip(named_leaves(g_k), named_leaves(g_p)):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        if not rel <= 2e-2:
            raise AssertionError(f"{tag} (b): gradient {name} relative "
                                 f"L2 {rel:.3e} > 2e-2")
        worst = max(worst, (name, rel), key=lambda x: x[1])
    log(f"{tag} (b) world {world}, 2 layers, kernels vs plain versions, "
        f"routed alike: loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f} (relative "
        f"{rel_loss:.2e}, tol 1e-3); worst gradient leaf {worst[0]} "
        f"relative L2 {worst[1]:.3e} (tol 2e-2)")
    if not rel_loss <= 1e-3:
        raise AssertionError(f"{tag} (b): loss relative {rel_loss:.2e}")
    del params, g_k, g_p
    free_cuda()
    return launches


def moe_phases():
    """Phases 7-10b; returns each grouped-GEMM mode's launch count from the
    phase that drives it (forward, layer, train), the all-to-all's from
    the forward, and the EP-4 forward's (7b) and train steps' (10b)
    launches of every kernel they run."""
    from dataclasses import replace

    import torch

    from triton_dist_tpu_torch.models import moe
    from triton_dist_tpu_torch.runtime.utils import tree_leaves

    cfg = replace(moe.MoEConfig.mixtral_8x7b(), n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = moe.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"mixtral_8x7b: {cfg.n_layers} of 32 layers, dim {cfg.dim}, "
        f"{cfg.n_experts} experts of ffn {cfg.expert_ffn_dim}, top-"
        f"{cfg.topk}, random weights (seed 0, {n_bytes / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(TRAIN_SEQ, 1)),
                          device="cuda")
    zero_off_path_counters()
    fwd, ref, routes = moe_forward_phase(cfg, params, tok)
    record_model_path("moe_forward")
    zero_off_path_counters()
    ep_fwd = moe_ep_forward_phase(cfg, params, tok, ref, routes)
    record_model_path("moe_ep_forward")
    del ref, routes
    free_cuda()
    moe_generator_phase(cfg, params)
    del params
    free_cuda()
    i8_launches = moe_layer_phase()
    free_cuda()
    trained = moe_train_phase(cfg)
    ep_trained = moe_train_phase(cfg, EP)
    return ({"group_gemm": fwd["group_gemm"], "all_to_all": fwd["all_to_all"],
             "group_gemm_dx": trained["group_gemm_dx"],
             "group_gemm_i8": i8_launches}, ep_fwd, ep_trained)


# ---------------------------------------------------------------------------
# phases 11-12: tensor parallelism (Llama-3-8B, TP 4 on the virtual world)
# ---------------------------------------------------------------------------


def argmax_agreement(tag, got, ref, near_tie=NEAR_TIE):
    """(exact, counting near-ties) agreement of ``got``'s argmax with
    ``ref``'s over every position: a mismatch is a near-tie when ``ref``'s
    logit at ``got``'s argmax lies within ``near_tie`` of ``ref``'s
    maximum.  Prints max |d logit| beside."""
    import torch

    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    pg, pr = got.argmax(-1), ref.argmax(-1)
    gap = ref.gather(1, pr[:, None])[:, 0] - ref.gather(1, pg[:, None])[:, 0]
    exact = (pg == pr).float().mean().item()
    ties = (gap <= near_tie).float().mean().item()
    top2 = torch.topk(ref, 2, dim=-1).values
    log(f"{tag}: argmax agreement {exact:.4f} exact, {ties:.4f} counting "
        f"near-ties (gap <= {near_tie}); max |d logit| "
        f"{(got - ref).abs().max().item():.4f}, largest flip gap "
        f"{gap.max().item():.4f}, median top-2 gap "
        f"{(top2[:, 0] - top2[:, 1]).median().item():.4f}")
    return exact, ties


def tp_phases():
    """Phases 11-12: Llama-3-8B at full width and all 32 layers,
    tensor-parallel over TP ranks of the virtual world, random weights from
    seed 0, tokens [S 2048, B 1] from a seed.  11: the world-1 forward
    (cuBLAS projections) and, as the noise floor, the same with the plain
    attention; the tree sharded by ``shard_params``; the TP forward with
    the ring counters zeroed just before (each > 0 after; the dense GEMM's
    zeroed too and reported, on no model path), timed,
    profiled, and its argmax held to the world-1 forward's (ties within
    NEAR_TIE, >= AGREE_MIN with ties and >= STRICT_MIN exact).  12 (a):
    TP_SGD_STEPS in-place SGD steps, counters zeroed again (finite, falling
    losses; peak memory; a profiled step); (b) at 2 layers the loss and
    every gradient leaf with the kernels against the plain versions of
    every kernel (1e-3, 2e-2 relative L2).  Returns the launch counts of
    the forward and of the steps."""
    from dataclasses import replace

    import torch

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.runtime.utils import value_and_grad

    cfg = llama.LlamaConfig.llama3_8b()
    rng = np.random.default_rng(11)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(TRAIN_SEQ, 1)),
                          device="cuda")
    tgt = torch.roll(tok, -1, dims=0)
    counters = {"ag_gemm": agm.ag_gemm_shard, "gemm_rs": grs.gemm_rs_shard}
    off_path = {"matmul": gemm.matmul}

    # 11: forward
    params = llama.init_params(cfg, seed=0)
    with torch.no_grad():
        ref = llama.make_forward(cfg)(params, tok)
        floor = llama.make_forward(cfg, plain=True)(params, tok)
    argmax_agreement("tp noise floor: world-1 forward, flash kernel vs "
                     "plain attention", floor, ref)
    del floor
    tp = llama.shard_params(params, cfg, TP)
    del params
    free_cuda()
    fwd = llama.make_forward(cfg, TP)
    for fn in (*counters.values(), *off_path.values()):
        fn.launches = 0
    zero_off_path_counters()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = fwd(tp, tok)
        torch.cuda.synchronize()
        t_first = (time.perf_counter() - t0) * 1e3
    fwd_launches = {n: fn.launches
                    for n, fn in {**counters, **off_path}.items()}
    record_model_path("tp_forward")
    with torch.no_grad():
        t0 = time.perf_counter()
        fwd(tp, tok)
        torch.cuda.synchronize()
        t_warm = (time.perf_counter() - t0) * 1e3
        busy, top = profile_once(lambda: fwd(tp, tok), top_n=12)
    ring_ms = sum(ms for name, _, ms in top
                  if "ag_gemm" in name or "gemm_rs" in name)
    log(f"tp forward: TP {TP}, {cfg.n_layers} layers, tokens [{TRAIN_SEQ}, "
        f"1]: first call {t_first:.1f} ms, warm {t_warm:.1f} ms wall; "
        f"profiled: device busy {busy:.2f} ms, ring kernels {ring_ms:.2f} ms"
        f" ({ring_ms / busy:.3f} of it), idle share {1 - busy / t_warm:.3f};"
        f" launches {fwd_launches}")
    for name, n, ms in top:
        log(f"tp forward   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    for n in counters:
        if fwd_launches[n] <= 0:
            raise AssertionError(f"kernel {n} never launched by the TP "
                                 f"forward")
    if tuple(logits.shape) != (TRAIN_SEQ, 1, cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"tp forward: bad logits {tuple(logits.shape)}")
    exact, ties = argmax_agreement(
        f"tp forward vs world-1 forward ({TRAIN_SEQ} positions)", logits,
        ref)
    if ties < AGREE_MIN or exact < STRICT_MIN:
        raise AssertionError(f"tp forward: agreement {exact:.4f} exact "
                             f"(floor {STRICT_MIN}), {ties:.4f} with "
                             f"near-ties (floor {AGREE_MIN})")
    del logits, ref
    free_cuda()

    # 12 (a): SGD at 32 layers
    torch.cuda.reset_peak_memory_stats()
    step = llama.make_train_step(cfg, TP, lr=TP_SGD_LR)
    for fn in (*counters.values(), *off_path.values()):
        fn.launches = 0
    zero_off_path_counters()
    losses, times = [], []
    for _ in range(TP_SGD_STEPS):
        t0 = time.perf_counter()
        _, loss = step(tp, tok, tgt)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    train_launches = {n: fn.launches
                      for n, fn in {**counters, **off_path}.items()}
    record_model_path("tp_train")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"tp train (a) SGD lr {TP_SGD_LR}, TP {TP}, {cfg.n_layers} layers: "
        f"losses {[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in times]}, peak memory {peak:.2f} GiB; "
        f"launches {train_launches}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"tp train (a): losses {losses} not finite and "
                             f"falling")
    for n in counters:
        if train_launches[n] <= 0:
            raise AssertionError(f"kernel {n} never launched by TP training")
    busy, top = profile_once(lambda: step(tp, tok, tgt), top_n=12)
    wall = float(np.median(times[1:]))
    ring_ms = sum(ms for name, _, ms in top
                  if "ag_gemm" in name or "gemm_rs" in name)
    log(f"tp train (a) profiled step: device busy {busy:.1f} ms of a "
        f"{wall:.1f} ms step, idle share {1 - busy / wall:.3f}, ring "
        f"kernels {ring_ms:.1f} ms ({ring_ms / busy:.3f})")
    for name, n, ms in top:
        log(f"tp train (a)   {ms:8.2f} ms  x{n:<5d} {name[:90]}")
    del tp, step
    free_cuda()

    # 12 (b): 2-layer gradients, kernels vs plain versions
    cfg2 = replace(cfg, n_layers=2)
    p2 = llama.shard_params(llama.init_params(cfg2, seed=0), cfg2, TP)
    loss_k, g_k = value_and_grad(llama.loss_shard, p2, tok, tgt, cfg2,
                                 world=TP)
    loss_p, g_p = value_and_grad(llama.loss_shard, p2, tok, tgt, cfg2,
                                 world=TP, plain=True)
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = ("", 0.0)
    for (name, a), (_, b) in zip(named_leaves(g_k), named_leaves(g_p)):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        if not rel <= 2e-2:
            raise AssertionError(f"tp train (b): gradient {name} relative L2"
                                 f" {rel:.3e} > 2e-2")
        worst = max(worst, (name, rel), key=lambda x: x[1])
    log(f"tp train (b) TP {TP}, 2 layers, kernels vs plain versions: loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f} (relative "
        f"{rel_loss:.2e}, tol 1e-3); worst gradient leaf {worst[0]} "
        f"relative L2 {worst[1]:.3e} (tol 2e-2)")
    if not rel_loss <= 1e-3:
        raise AssertionError(f"tp train (b): loss relative {rel_loss:.2e}")
    del p2, g_k, g_p
    free_cuda()
    return fwd_launches, train_launches


# ---------------------------------------------------------------------------
# phases 3 (CP rows), 17-18: context parallelism, CP ranks of the virtual
# world at Llama-3-8B's published context
# ---------------------------------------------------------------------------


def cp_kernel_rows(dev, g):
    """Phase 3's context-parallel rows at Llama-3-8B CP 4 (W CP, S_loc
    CP_SEQ / CP = 2048, B 1, Hq 32, Hkv 8, D 128).  "1z" (flash_fwd_seg):
    the flash forward in its segmented mode, the four ranks of one zigzag
    ring step folded into the batch (q [4, 32, 2048, 128], rank r's two
    chunks against rank r - 1's, per-row block-start vectors), against the
    plain version on the same run starts (2e-2 / 1e-3), timed as CUDA-graph
    replays, SDPA with the same boolean mask as the yardstick.  "6z"
    (flash_bwd_dq_seg, flash_bwd_dkv_seg): dq and dkv on the same inputs
    with f32 gradients, by phase 3's gradient rule, SDPA's backward with
    the mask (K/V expanded to Hq heads) as the yardstick.  Row 21
    (ring_attn): the fused ring kernel at W 4, S_loc 2048, causal, in the
    contiguous layout (phase 17's fused forward) and the zigzag one (under
    "shapes"), against the dense ring (2e-2 absolute, and RING_L2_TOL /
    RING_TILE_L2_TOL relative L2 over the output and over each (rank,
    head, 64-row block)), timed eagerly between CUDA
    events (a launch carries its call's epoch), one causal SDPA call over
    the gathered 8,192-position sequence as the yardstick; then ten calls
    in a row on new inputs, each checked (slot reuse, epochs).  Bounds:
    the visible (query, key) pairs of these inputs."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    W, S, Hq, Hkv, D = CP, CP_SEQ // CP, 32, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    rows = {}
    q, k, v, do = (randn(W, Hq, S, D), randn(W, Hkv, S, D),
                   randn(W, Hkv, S, D), randn(W, Hq, S, D))
    kw = dict(causal=True, q_offset=ra._fold_starts(W, 1, S, True, 0),
              kv_offset=ra._fold_starts(W, 1, S, True, 1))
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, **kw)
    e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
    log(f"flash_fwd_seg (1z) W {W} folded, zigzag step 1, [{W}, {Hq}, {S}, "
        f"{D}]: max|out-plain| {e_out:.3e} (tol {OUT_TOL}), max|lse-plain| "
        f"{e_lse:.3e} (tol {LSE_TOL})")
    if not (e_out <= OUT_TOL and e_lse <= LSE_TOL):
        raise AssertionError("flash_fwd_seg disagrees with plain")
    del ref_out, ref_lse
    mask = fa._visibility_mask(S, S, causal=True, window=0,
                               q_offset=kw["q_offset"],
                               kv_offset=kw["kv_offset"], device=dev)
    visible = int(mask.sum())            # every rank's pairs per q-head
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
    eager = call_ms(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw),
                       iters=2, reps=2)
    amask = mask[:, None]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=amask, enable_gqa=True))
    io = (2 * q.numel() + 2 * k.numel()) * 2
    b_ms, b_by = bound_ms(io + W * Hq * S * 4, 4 * D * Hq * visible)
    log(f"flash_fwd_seg (1z): kernel {ms:.4f} ms (eager call {eager:.4f} "
        f"ms), plain {plain_ms:.4f} ms, "
        f"sdpa (boolean mask) {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"visible pairs {visible} of {W * S * S}")
    rows["flash_fwd_seg"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib,
                                 max_abs_err=e_out)

    got = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                 grad_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    errs = {}
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        err, top, l2, tile_l2 = grad_errors(gt, wt)
        log(f"flash_bwd_seg (6z) {name}: max|kernel-plain| {err:.3e}, "
            f"max|plain| {top:.3e} (tol {BWD_REL_TOL} x max|plain|); "
            f"relative L2 {l2:.3e} (tol {BWD_L2_TOL}), worst (head, 64-row "
            f"tile) {tile_l2:.3e} (tol {BWD_TILE_L2_TOL})")
        if not (torch.isfinite(gt).all() and err <= BWD_REL_TOL * top
                and l2 <= BWD_L2_TOL and tile_l2 <= BWD_TILE_L2_TOL):
            raise AssertionError(f"flash_bwd_seg {name} disagrees with "
                                 f"plain")
        errs[name] = err
    del got, want
    delta = fa.bwd_delta(out, do)
    bkw = dict(kw, scale=D ** -0.5, soft_cap=0.0, window=0,
               out_dtype=torch.float32)
    dq_ms = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **bkw))
    dkv_ms = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                              **bkw))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(
        q, k, v, out, lse, do, **kw), iters=1, reps=2)
    xs = [x.detach().clone().requires_grad_() for x in (
        q, k.repeat_interleave(Hq // Hkv, dim=1),
        v.repeat_interleave(Hq // Hkv, dim=1))]

    def fwd():
        return F.scaled_dot_product_attention(*xs, attn_mask=amask)

    lib = time_ms(lambda: torch.autograd.grad(fwd(), xs, do)) - time_ms(fwd)
    del xs
    prod = 2 * D * visible * Hq
    dq_b = bound_ms(io + 2 * W * Hq * S * 4 + q.numel() * 4, 3 * prod)
    dkv_b = bound_ms(io + 2 * W * Hq * S * 4 + 2 * k.numel() * 4, 4 * prod)
    log(f"flash_bwd_seg (6z): dq kernel {dq_ms:.4f} ms (bound "
        f"{dq_b[0]:.4f} ms, {dq_b[1]}), dkv kernel {dkv_ms:.4f} ms (bound "
        f"{dkv_b[0]:.4f} ms, {dkv_b[1]}), f32 gradients; plain gradient "
        f"{plain_ms:.4f} ms; sdpa backward (boolean mask, K/V expanded) "
        f"{lib:.4f} ms")
    common = dict(plain_ms=plain_ms, library_ms=lib)
    rows["flash_bwd_dq_seg"] = dict(common, ms=dq_ms, bound_ms=dq_b[0],
                                    bound_by=dq_b[1], max_abs_err=errs["dq"])
    rows["flash_bwd_dkv_seg"] = dict(
        common, ms=dkv_ms, bound_ms=dkv_b[0], bound_by=dkv_b[1],
        max_abs_err=max(errs["dk"], errs["dv"]))
    del q, k, v, do, out, lse, delta, mask, amask
    free_cuda()

    # row 21: the fused ring kernel
    q, k, v = randn(W, S, 1, Hq, D), randn(W, S, 1, Hkv, D), randn(W, S, 1,
                                                                   Hkv, D)
    gathered = [x.permute(2, 3, 0, 1, 4).reshape(1, x.shape[3], W * S, D)
                for x in (q, k, v)]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        *gathered, is_causal=True, enable_gqa=True))
    del gathered
    n = W * S
    b_ms, b_by = bound_ms((2 * q.numel() + 2 * k.numel()) * 2,
                          4 * D * Hq * (n * (n + 1) // 2))

    def check(tag, got, want):
        # [W, S, B, H, D] -> [W B, H, S, D]: grad_errors' blocks are then
        # (rank, batch, head, 64-row block)
        err, _, l2, tile_l2 = grad_errors(
            *(x.permute(0, 2, 3, 1, 4).flatten(0, 1) for x in (got, want)))
        log(f"ring_attn {tag}: max|kernel-plain| {err:.3e} (tol {OUT_TOL}), "
            f"relative L2 {l2:.3e} (tol {RING_L2_TOL}), worst (rank, head, "
            f"64-row block) {tile_l2:.3e} (tol {RING_TILE_L2_TOL})")
        if not (torch.isfinite(got).all() and err <= OUT_TOL
                and l2 <= RING_L2_TOL and tile_l2 <= RING_TILE_L2_TOL):
            raise AssertionError(f"ring_attn {tag} disagrees with plain")
        return err

    shapes, errs = {}, []
    for zz in (False, True):
        tag = "zigzag" if zz else "contiguous"
        got = ra.ring_attn(q, k, v, zigzag=zz)
        torch.cuda.synchronize()
        want = ra._ring_attention_dense(q, k, v, causal=True,
                                        scale=D ** -0.5, zigzag=zz)
        err = check(f"{tag} W {W}, S_loc {S}", got, want)
        errs.append(err)
        del got, want
        ms = event_ms(lambda: ra.ring_attn(q, k, v, zigzag=zz), iters=10)
        plain_ms = event_ms(lambda: ra._ring_attention_dense(
            q, k, v, causal=True, scale=D ** -0.5, zigzag=zz), iters=2)
        log(f"ring_attn {tag}: kernel {ms:.4f} ms (eager, between CUDA "
            f"events), plain {plain_ms:.4f} ms, sdpa over the gathered "
            f"{n} positions {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        shapes[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib, max_abs_err=err)
    stress = []
    for i in range(10):
        q, k, v = randn(W, S, 1, Hq, D), randn(W, S, 1, Hkv, D), randn(
            W, S, 1, Hkv, D)
        got = ra.ring_attn(q, k, v, zigzag=bool(i % 2))
        want = ra._ring_attention_dense(q, k, v, causal=True,
                                        scale=D ** -0.5, zigzag=bool(i % 2))
        stress.append(check(f"call {i + 1} of ten in a row (new inputs, "
                            f"{'zigzag' if i % 2 else 'contiguous'})",
                            got, want))
        del got, want
    rows["ring_attn"] = dict(shapes["contiguous"],
                             max_abs_err=max(errs + stress), shapes=shapes)
    del q, k, v
    free_cuda()
    return rows


def _cp_counters():
    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    return {"flash_fwd": (fa.flash_attention, "launches"),
            "flash_fwd_seg": (fa.flash_attention, "segmented_launches"),
            "flash_bwd_dq_seg": (fa.flash_bwd_dq, "segmented_launches"),
            "flash_bwd_dkv_seg": (fa.flash_bwd_dkv, "segmented_launches"),
            "ring_attn": (ra.ring_attn, "launches"),
            "all_to_all": (a2a.fast_all_to_all_shard, "launches")}


def _zero_cp_counters():
    for fn, attr in _cp_counters().values():
        setattr(fn, attr, 0)


def _read_cp_counters():
    return {n: getattr(fn, attr) for n, (fn, attr) in _cp_counters().items()}


def cp_forward_phase(cfg, params):
    """Phase 17: Llama-3-8B at full width and 32 layers on phase 4's
    weights, tokens [CP_SEQ 8192, 1] from a seed.  The world-1 forward at
    the same S (and, as its noise floor, the same with the plain
    attention), then ``make_cp_forward(cfg, CP)`` three ways: the ring
    under ``impl="auto"`` (the zigzag flash ring: the flash kernels'
    segmented mode), under ``impl="fused"`` (the contiguous layout through
    ``ring_attn``) and Ulysses (two all-to-alls per layer around one
    flash call), each with the CP launch counters zeroed just before and
    read just after (its kernel > 0), timed (first and warm call) and
    profiled (device busy, attention's share, the ring's rotation or the
    all-to-all's share), its argmax held to the world-1 forward's at the
    dense gates.  Returns each scheme's launch counts."""
    import torch

    from triton_dist_tpu_torch.models import cp, llama

    rng = np.random.default_rng(17)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(CP_SEQ, 1)),
                          device="cuda")
    with torch.no_grad():
        fwd1 = llama.make_forward(cfg)
        ref = fwd1(params, tok)
        t0 = time.perf_counter()
        fwd1(params, tok)
        torch.cuda.synchronize()
        w1_ms = (time.perf_counter() - t0) * 1e3
        busy1, top1 = profile_once(lambda: fwd1(params, tok), top_n=40)
        floor = llama.make_forward(cfg, plain=True)(params, tok)
    attn1 = sum(ms for name, _, ms in top1 if "flash_fwd" in name)
    log(f"cp world-1 forward: {cfg.n_layers} layers, tokens [{CP_SEQ}, 1]: "
        f"{w1_ms:.1f} ms wall, device busy {busy1:.2f} ms (idle share "
        f"{1 - busy1 / w1_ms:.3f}), flash_fwd {attn1:.2f} ms "
        f"({attn1 / busy1:.3f})")
    argmax_agreement(f"cp noise floor: world-1 forward at S {CP_SEQ}, flash "
                     f"kernel vs plain attention", floor, ref)
    del floor
    free_cuda()
    launches = {}
    for tag, attn, impl, key in (
            ("ring auto (zigzag flash ring)", "ring", "auto",
             "flash_fwd_seg"),
            ("ring fused (contiguous, ring_attn)", "ring", "fused",
             "ring_attn"),
            ("ulysses", "ulysses", "auto", "all_to_all")):
        fwd = cp.make_cp_forward(cfg, CP, attn=attn, impl=impl)
        _zero_cp_counters()
        with torch.no_grad():
            t0 = time.perf_counter()
            logits = fwd(params, tok)
            torch.cuda.synchronize()
            t_first = (time.perf_counter() - t0) * 1e3
        counts = _read_cp_counters()
        launches[attn if attn == "ulysses" else impl] = counts
        with torch.no_grad():
            t0 = time.perf_counter()
            fwd(params, tok)
            torch.cuda.synchronize()
            t_warm = (time.perf_counter() - t0) * 1e3
            busy, top = profile_once(lambda: fwd(params, tok), top_n=40)
        attn_ms = sum(ms for name, _, ms in top
                      if "flash_fwd" in name or "ring_attn" in name)
        comm_ms = sum(ms for name, _, ms in top
                      if "roll_cuda" in name or "a2a_" in name)
        log(f"cp forward {tag}: CP {CP}, {cfg.n_layers} layers, tokens "
            f"[{CP_SEQ}, 1]: first call {t_first:.1f} ms, warm "
            f"{t_warm:.1f} ms wall (world 1: {w1_ms:.1f}); profiled: device "
            f"busy {busy:.2f} ms (idle share {1 - busy / t_warm:.3f}), "
            f"attention kernels {attn_ms:.2f} ms ({attn_ms / busy:.3f}), "
            f"ring rotation / all-to-all {comm_ms:.2f} ms "
            f"({comm_ms / busy:.3f}); launches {counts}")
        for name, n, ms in top[:10]:
            log(f"cp forward   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
        if counts[key] <= 0:
            raise AssertionError(f"kernel {key} never launched by the CP "
                                 f"forward ({tag})")
        if tuple(logits.shape) != (CP_SEQ, 1, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"cp forward {tag}: bad logits")
        exact, ties = argmax_agreement(
            f"cp forward {tag} vs world-1 forward ({CP_SEQ} positions)",
            logits, ref)
        if ties < AGREE_MIN or exact < STRICT_MIN:
            raise AssertionError(f"cp forward {tag}: agreement {exact:.4f} "
                                 f"exact (floor {STRICT_MIN}), {ties:.4f} "
                                 f"with near-ties (floor {AGREE_MIN})")
        del logits
        free_cuda()
    del ref
    free_cuda()
    return launches


def cp_train_phase():
    """Phase 18 on its own tree (seed 0), tokens [CP_SEQ, 1] from a seed.
    (a) CP_SGD_STEPS in-place SGD steps at 32 layers through
    ``make_cp_train_step(cfg, CP, impl="auto", remat=True)`` (the zigzag
    flash ring forward and its reverse ring over the segmented backward
    kernels), the CP counters zeroed just before and read just after (the
    segmented flash forward and both backward kernels > 0): finite,
    falling losses, step ms, trained tokens per second, peak memory, a
    profiled step.  ``remat``: without it a step would hold every layer's
    activations (~2.4 GB a layer at S 8192, from phase 6's 34.87 GiB peak
    at S 2048) beside 32 GB of weights and gradients, past the card's 80
    GB.  (b) One Ulysses step at 32 layers (the all-to-all > 0).  (c) At 2
    layers and CP_GRAD_SEQ positions, the loss and every gradient leaf of
    each scheme (ring auto, ring fused, Ulysses) against the same scheme
    over the plain versions in the same layout (1e-3, 2e-2 relative L2):
    the plain versions hold S x S f32 scores, so this check runs at S
    4,096.  (d) What remat saves: the peak of one 2-layer gradient at
    CP_SEQ without and with it.  (e) One fused step at 2 layers and CP_SEQ
    (its backward is the dense VJP, [4, 32, 2048, 2048] f32 per ring step:
    the depth is cut, not the sequence).  Returns the launch counts of (a),
    (b) and (e)."""
    from dataclasses import replace

    import torch

    from triton_dist_tpu_torch.models import cp, llama
    from triton_dist_tpu_torch.runtime.utils import value_and_grad

    cfg = llama.LlamaConfig.llama3_8b()
    rng = np.random.default_rng(18)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(CP_SEQ, 1)),
                          device="cuda")
    tgt = torch.roll(tok, -1, dims=0)
    params = llama.init_params(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    step = cp.make_cp_train_step(cfg, CP, impl="auto", lr=SGD_LR,
                                 remat=True)
    _zero_cp_counters()
    losses, times = [], []
    for _ in range(CP_SGD_STEPS):
        t0 = time.perf_counter()
        _, loss = step(params, tok, tgt)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"sgd": _read_cp_counters()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = float(np.median(times[1:]))
    log(f"cp train (a) SGD lr {SGD_LR}, CP {CP}, {cfg.n_layers} layers, "
        f"tokens [{CP_SEQ}, 1], remat: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in times]} ({CP_SEQ / wall * 1e3:.0f} trained "
        f"tok/s), peak memory {peak:.2f} GiB; launches {launches['sgd']}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"cp train (a): losses {losses} not finite and "
                             f"falling")
    for n in ("flash_fwd_seg", "flash_bwd_dq_seg", "flash_bwd_dkv_seg"):
        if launches["sgd"][n] <= 0:
            raise AssertionError(f"kernel {n} never launched by CP training")
    busy, top = profile_once(lambda: step(params, tok, tgt), top_n=40)
    attn_ms = sum(ms for name, _, ms in top if "flash" in name)
    log(f"cp train (a) profiled step: device busy {busy:.1f} ms of a "
        f"{wall:.1f} ms step, idle share {1 - busy / wall:.3f}, flash "
        f"kernels {attn_ms:.1f} ms ({attn_ms / busy:.3f})")
    for name, n, ms in top[:12]:
        log(f"cp train (a)   {ms:8.2f} ms  x{n:<5d} {name[:90]}")
    del step
    free_cuda()

    # (b) one Ulysses step at 32 layers
    step = cp.make_cp_train_step(cfg, CP, attn="ulysses", lr=SGD_LR,
                                 remat=True)
    _zero_cp_counters()
    t0 = time.perf_counter()
    _, loss = step(params, tok, tgt)
    loss = float(loss)
    u_ms = (time.perf_counter() - t0) * 1e3
    launches["ulysses"] = _read_cp_counters()
    log(f"cp train (b) one Ulysses SGD step, {cfg.n_layers} layers: loss "
        f"{loss:.4f}, {u_ms:.1f} ms (a first call); launches "
        f"{launches['ulysses']}")
    if not np.isfinite(loss) or launches["ulysses"]["all_to_all"] <= 0:
        raise AssertionError("cp train (b): the Ulysses step failed")
    del params, step
    free_cuda()

    # (c) 2-layer gradients, each scheme against its plain versions
    cfg2 = replace(cfg, n_layers=2)
    p2 = llama.init_params(cfg2, seed=0)
    tok2, tgt2 = tok[:CP_GRAD_SEQ], tgt[:CP_GRAD_SEQ]
    for attn, impl in (("ring", "auto"), ("ring", "fused"),
                       ("ulysses", "auto")):
        zz = cp._pick_zigzag(None, attn, CP_GRAD_SEQ, CP, impl,
                             cfg.head_dim)
        kw = dict(world=CP, attn=attn, impl=impl, zigzag=zz)
        loss_k, g_k = value_and_grad(cp.cp_loss, p2, tok2, tgt2, cfg2, **kw)
        loss_p, g_p = value_and_grad(cp.cp_loss, p2, tok2, tgt2, cfg2,
                                     plain=True, **kw)
        rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        worst = ("", 0.0)
        for (name, a), (_, b) in zip(named_leaves(g_k), named_leaves(g_p)):
            rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
            if not rel <= 2e-2:
                raise AssertionError(f"cp train (c) {attn}/{impl}: gradient "
                                     f"{name} relative L2 {rel:.3e} > 2e-2")
            worst = max(worst, (name, rel), key=lambda x: x[1])
        log(f"cp train (c) {attn} {impl} (zigzag {zz}), 2 layers, S "
            f"{CP_GRAD_SEQ}, kernels vs plain versions: loss "
            f"{float(loss_k):.6f} vs {float(loss_p):.6f} (relative "
            f"{rel_loss:.2e}, tol 1e-3); worst gradient leaf {worst[0]} "
            f"relative L2 {worst[1]:.3e} (tol 2e-2)")
        if not rel_loss <= 1e-3:
            raise AssertionError(f"cp train (c) {attn}/{impl}: loss relative "
                                 f"{rel_loss:.2e}")
        del g_k, g_p
        free_cuda()

    # (d) what remat saves: one 2-layer gradient at the full sequence
    # without and with it (the peak above what was allocated before)
    peaks = {}
    for remat in (False, True):
        free_cuda()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value_and_grad(cp.cp_loss, p2, tok, tgt, cfg2, world=CP, remat=remat)
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    per_layer = peaks[False] - peaks[True]
    log(f"cp train (d) 2 layers, tokens [{CP_SEQ}, 1]: peak {peaks[False]:.2f}"
        f" GiB above the weights without remat, {peaks[True]:.2f} GiB with "
        f"it: ~{per_layer:.2f} GiB of activations per layer, so "
        f"{cfg.n_layers} layers without remat would hold "
        f"~{per_layer * cfg.n_layers:.1f} GiB beside the 29.9 GiB of weights "
        f"and gradients")
    free_cuda()

    # (e) the fused kernel's step at 2 layers, full sequence
    torch.cuda.reset_peak_memory_stats()
    step = cp.make_cp_train_step(cfg2, CP, impl="fused", lr=SGD_LR)
    _zero_cp_counters()
    t0 = time.perf_counter()
    _, loss = step(p2, tok, tgt)
    loss = float(loss)
    f_ms = (time.perf_counter() - t0) * 1e3
    launches["fused"] = _read_cp_counters()
    log(f"cp train (e) one fused-ring SGD step, 2 layers, tokens "
        f"[{CP_SEQ}, 1]: loss {loss:.4f}, {f_ms:.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{launches['fused']}")
    if not np.isfinite(loss) or launches["fused"]["ring_attn"] <= 0:
        raise AssertionError("cp train (e): the fused step failed")
    del p2, step
    free_cuda()
    return launches


# ---------------------------------------------------------------------------
# phases 3 (collective rows) and 19: the barrier, all-gather and
# reduce-scatter kernels over meshes of the virtual world, and
# pipeline-parallel training with the hierarchical gradient all-reduce
# ---------------------------------------------------------------------------


def _mesh(shape, names):
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    return Mesh(shape, names, "cuda")


def _timed(kind, tag, fn, key, n_bytes, plain_ms, lib_ms, lib_call,
           algo_bytes=None):
    """One collective's times: eager between CUDA events (a launch carries
    its call's epoch, so no CUDA graph) and the profiler's device time of
    its kernel, beside the bound (the function's bytes), the time the
    kernel's own traffic needs at the memory rate (``algo_bytes``: the
    schedule's reads and writes) and the yardsticks."""
    ms = event_ms(fn, iters=10)
    dev_ms = kernel_device_ms(fn, key, iters=10)
    b_ms, b_by = bound_ms(n_bytes, 0)
    row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms)
    algo = ""
    if algo_bytes is not None:
        row["algorithm_bound_ms"] = algo_bytes / HBM_BYTES_S * 1e3
        algo = (f", its own traffic {algo_bytes / 1e9:.2f} GB "
                f"({row['algorithm_bound_ms']:.4f} ms at the memory rate, "
                f"{algo_bytes / dev_ms / 1e6:.0f} GB/s achieved)")
    log(f"{kind} {tag}: kernel {ms:.4f} ms eager ({dev_ms:.4f} ms device), "
        f"plain {plain_ms:.4f} ms, library "
        f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms ({lib_call})'}, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB){algo}")
    return row


def collective_rows(dev, g):
    """Phase 3's rows 10-12 over meshes of the virtual world (eight ranks
    unless stated).  Row 10 (barrier): over tp at (2, 2, 2) and over a
    flat axis of 8, each rank's word back; latency only (its payload is W
    words), no PyTorch call is a cross-rank barrier.  Rows 11r / 11b / 11f
    (the all-gather's ring, bidir and full-mesh modes): the path's band
    [1,024,528, 128] f32 per rank over tp at (2, 2, 2) (four groups of
    two), T 4 over (2, 4) at [131,072, 128] f32, T 8 at [4,096, 128] bf16
    and an odd row count (37; bidir takes the ring there), each exactly
    equal to the plain version (a concatenation); library: one
    ``expand(...).contiguous()`` of the gathered view.  Rows 12r / 12b
    (the reduce-scatter's ring and bidir modes): the path's plane
    [2,049,056, 128] f32 per rank over tp at (2, 2, 2), T 4 at [4 x
    65,536, 128] f32, T 8 at [8 x 4,096, 128] bf16, and 5 and 1 rows per
    chunk, each bit-equal to the plain version in the reference's ring
    order; library: one ``sum`` over the rank dimension of the stacked
    view.  Bounds: every rank's input read once and output written once.
    Then ten bidir all-gathers and ten bidir reduce-scatters in a row on
    new inputs, each checked.  Rows report the path's shape; the others
    ride along under "shapes"."""
    import torch

    from triton_dist_tpu_torch.kernels import allgather as ag
    from triton_dist_tpu_torch.kernels import common_ops as co
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    m222 = _mesh((2, 2, 2), ("dcn", "pp", "tp"))
    m24 = _mesh((2, 4), ("dcn", "tp"))
    m8 = _mesh((8,), ("tp",))
    rows = {}

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # row 10: the barrier
    shapes = {}
    for tag, mesh in (("tp@2x2x2", m222), ("flat8", m8)):
        x = torch.arange(8, dtype=torch.int32, device=dev).reshape(mesh.shape)
        if not torch.equal(co.barrier_shard(x, mesh, "tp"), x):
            raise AssertionError(f"barrier {tag}: words differ")
        plain_ms = time_ms(lambda: co.barrier_ref(x))
        shapes[tag] = _timed("barrier", tag,
                             lambda: co.barrier_shard(x, mesh, "tp"),
                             "barrier_kernel", 2 * x.numel() * 4, plain_ms,
                             None, "")
    rows["barrier"] = dict(shapes["tp@2x2x2"], max_abs_err=0.0,
                           shapes=shapes)

    # rows 11r / 11b / 11f: the all-gather
    cases = [("band@tp2", m222, "tp", (1024528, 128), torch.float32),
             ("t4", m24, "tp", (131072, 128), torch.float32),
             ("t8_bf16", m8, "tp", (4096, 128), torch.bfloat16),
             ("odd37", m222, "tp", (37, 128), torch.float32)]
    inputs = {tag: randn((*m.shape, *shp), dt) for tag, m, _, shp, dt in cases}
    for meth, name in ((ag.AllGatherMethod.RING_1D, "ring"),
                       (ag.AllGatherMethod.RING_BIDIR, "bidir"),
                       (ag.AllGatherMethod.FULL_MESH_PUSH, "full_mesh")):
        shapes = {}
        for tag, mesh, axis, shp, dt in cases:
            x = inputs[tag]
            got = ag.all_gather_shard(x, mesh, axis, meth)
            torch.cuda.synchronize()
            if not torch.equal(got, ag.all_gather_ref(x, mesh, axis)):
                raise AssertionError(f"allgather {name} {tag}: differs from "
                                     f"the plain version")
            del got
            if tag == "odd37":
                continue
            nd, a = len(mesh.shape), mesh.dim(axis)
            T = mesh.axis_size(axis)
            gview = x.movedim(a, nd - 1).reshape(
                *[s for i, s in enumerate(mesh.shape) if i != a],
                T * shp[0], *shp[1:])
            lib = event_ms(lambda: gview.unsqueeze(a).expand(
                *mesh.shape, *gview.shape[nd - 1:]).contiguous(), iters=5)
            plain_ms = event_ms(lambda: ag.all_gather_ref(x, mesh, axis),
                                iters=5)
            n_bytes = x.numel() * x.element_size() * (1 + T)
            # every schedule reads T segments and writes T per rank
            shapes[tag] = _timed(f"allgather {name}", tag,
                                 lambda: ag.all_gather_shard(x, mesh, axis,
                                                             meth),
                                 "allgather_kernel", n_bytes, plain_ms, lib,
                                 "expand(...).contiguous()",
                                 algo_bytes=x.numel() * x.element_size()
                                 * 2 * T)
            free_cuda()
        rows[f"allgather_{name}"] = dict(shapes["band@tp2"], max_abs_err=0.0,
                                         shapes=shapes)
    del inputs
    free_cuda()

    # rows 12r / 12b: the reduce-scatter
    cases = [("plane@tp2", m222, "tp", 1024528, torch.float32),
             ("t4", m24, "tp", 65536, torch.float32),
             ("t8_bf16", m8, "tp", 4096, torch.bfloat16),
             ("rows5", m24, "tp", 5, torch.float32),
             ("rows1", m222, "tp", 1, torch.float32)]
    for meth, name in ((rs.ReduceScatterMethod.RING_1D, "ring"),
                       (rs.ReduceScatterMethod.RING_BIDIR, "bidir")):
        shapes = {}
        for tag, mesh, axis, r, dt in cases:
            T = mesh.axis_size(axis)
            x = randn((*mesh.shape, T * r, 128), dt)
            got = rs.reduce_scatter_shard(x, mesh, axis, meth)
            torch.cuda.synchronize()
            if not torch.equal(got, rs.reduce_scatter_ref(x, mesh, axis,
                                                          meth)):
                raise AssertionError(f"reduce_scatter {name} {tag}: not bit-"
                                     f"equal to the plain version")
            del got
            if tag.startswith("rows"):
                continue
            nd, a = len(mesh.shape), mesh.dim(axis)
            stacked = x.view(*mesh.shape[:a + 1], T, r, 128)
            lib = event_ms(lambda: stacked.sum(dim=a), iters=5)
            plain_ms = event_ms(lambda: rs.reduce_scatter_ref(x, mesh, axis,
                                                              meth), iters=3)
            n_bytes = x.numel() * x.element_size() * (T + 1) // T
            # the pull: per rank, the T partials of its band read once and
            # the band written once, the function's own bytes
            shapes[tag] = _timed(f"reduce_scatter {name}", tag,
                                 lambda: rs.reduce_scatter_shard(
                                     x, mesh, axis, meth),
                                 "reduce_scatter_kernel", n_bytes, plain_ms,
                                 lib, "sum over the rank dimension",
                                 algo_bytes=n_bytes)
            del x
            free_cuda()
        rows[f"reduce_scatter_{name}"] = dict(shapes["plane@tp2"],
                                              max_abs_err=0.0, shapes=shapes)

    # ten bidir calls of each in a row, on new inputs, each checked
    for i in range(10):
        x = randn((2, 2, 2, 65536, 128))
        a = ag.all_gather_shard(x, m222, "tp", ag.AllGatherMethod.RING_BIDIR)
        r = rs.reduce_scatter_shard(x, m222, "tp")
        torch.cuda.synchronize()
        if not (torch.equal(a, ag.all_gather_ref(x, m222, "tp")) and
                torch.equal(r, rs.reduce_scatter_ref(x, m222, "tp"))):
            raise AssertionError(f"collectives: call {i} of ten differs")
    log("collectives: ten bidir all-gathers and reduce-scatters in a row, "
        "each equal to its plain version")
    free_cuda()
    return rows


def _pp_counters():
    from triton_dist_tpu_torch.kernels import allgather as ag
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import common_ops as co
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    return {"barrier": (co.barrier_shard, None),
            "reduce_scatter_ring": (rs.reduce_scatter_shard, "ring"),
            "reduce_scatter_bidir": (rs.reduce_scatter_shard, "bidir"),
            "allgather_ring": (ag.all_gather_shard, "ring"),
            "allgather_bidir": (ag.all_gather_shard, "bidir"),
            "allgather_full_mesh": (ag.all_gather_shard, "full_mesh"),
            "ag_gemm": (agm.ag_gemm_shard, None),
            "gemm_rs": (grs.gemm_rs_shard, None),
            "flash_fwd": (fa.flash_attention, None),
            "flash_bwd_dq": (fa.flash_bwd_dq, None),
            "flash_bwd_dkv": (fa.flash_bwd_dkv, None)}


def _zero_pp_counters():
    for fn, mode in _pp_counters().values():
        if mode is None:
            fn.launches = 0
        else:
            fn.mode_launches[mode] = 0


def _read_pp_counters():
    return {n: fn.launches if mode is None else fn.mode_launches[mode]
            for n, (fn, mode) in _pp_counters().items()}


def pp_train_phase():
    """Phase 19: Mistral-7B at full width and PP_LAYERS layers on a dcn 2 x
    pp 2 x tp 2 mesh of the virtual world (the reference's hybrid mesh),
    tokens [S 2048, B 4] from a seed (S over tp, B over dcn, 2
    microbatches), remat, ``hier_dp_fast_axis="tp"``.  (a) PP_STEPS SGD
    steps at SGD_LR with the launch counters zeroed just before and read
    just after (one reduce-scatter in its bidir mode and one all-gather in
    its full-mesh mode per step, the ring and flash kernels > 0): finite,
    falling losses, step ms, trained tok/s, peak memory; then one profiled
    step (device busy, idle share, the RS and AG share, the ring kernels'
    and the flash kernels').  (b) Hierarchical against psum: the first two
    steps of (a) against two steps of the same fresh tree with
    ``hier_dp_fast_axis=None``: losses within 1e-3 relative, every updated
    leaf within 2e-2 relative L2.  (c) At 2 layers, the PP step's loss and
    gradients (``make_pp_grads``) against the port's non-PP
    ``llama.make_train_step(cfg, 2)`` loss over the same batch and against
    the PP step over the plain versions (1e-3; 2e-2 relative L2 per leaf).
    Returns the launch counts of (a)."""
    from dataclasses import replace

    import torch

    from triton_dist_tpu_torch.models import llama, pp
    from triton_dist_tpu_torch.runtime.bootstrap import create_hybrid_mesh
    from triton_dist_tpu_torch.runtime.utils import value_and_grad

    cfg = replace(llama.LlamaConfig.mistral_7b(), n_layers=PP_LAYERS)
    # the reference's hybrid mesh (__graft_entry__.py _dryrun_hybrid):
    # dcn 2 x pp 2 x tp 2, the slow axis leading
    mesh = create_hybrid_mesh({"pp": 2, "tp": 2}, n_slow=2, device="cuda")
    rng = np.random.default_rng(19)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(PP_SEQ, PP_BATCH)),
                          device="cuda")
    tgt = torch.roll(tok, -1, dims=0)
    kw = dict(dp_axis="dcn", n_micro=2, remat=True)

    def fresh():
        free_cuda()
        t0 = time.perf_counter()
        p = pp.place_pp_params(pp.init_pp_params(cfg, seed=0), cfg, mesh)
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    params, t_init = fresh()
    log(f"pp train: mistral_7b {cfg.n_layers} layers (dim {cfg.dim}, vocab "
        f"{cfg.vocab}), mesh dcn 2 x pp 2 x tp 2, random weights (seed 0, "
        f"placed) in {t_init:.1f} s; tokens [{PP_SEQ}, {PP_BATCH}], 2 "
        f"microbatches; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated")
    torch.cuda.reset_peak_memory_stats()
    step, _ = pp.make_pp_train_step(cfg, mesh, lr=SGD_LR,
                                    hier_dp_fast_axis="tp", **kw)
    _zero_pp_counters()
    zero_off_path_counters()
    losses, times, hier_leaves = [], [], None
    for i in range(PP_STEPS):
        t0 = time.perf_counter()
        _, loss = step(params, tok, tgt)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 1:      # (b): the tree after two steps, kept on the host
            hier_leaves = [t.to("cpu", copy=True)
                           for _, t in named_leaves(params)]
    launches = _read_pp_counters()
    record_model_path("pp_train")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = float(np.median(times[1:]))
    log(f"pp train (a) SGD lr {SGD_LR}: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in times]} ({PP_SEQ * PP_BATCH / wall * 1e3:.0f}"
        f" trained tok/s), peak memory {peak:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f}; "
        f"launches {launches}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"pp train (a): losses {losses} not finite and "
                             f"falling")
    # the barrier: no model path calls it (the reference's host barrier
    # only), so the step must not launch it either
    want = {"reduce_scatter_bidir": PP_STEPS, "allgather_full_mesh": PP_STEPS,
            "barrier": 0}
    for n, c in want.items():
        if launches[n] != c:
            raise AssertionError(f"pp train (a): {n} launched {launches[n]} "
                                 f"times in {PP_STEPS} steps, expected {c}")
    for n in ("ag_gemm", "gemm_rs", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkv"):
        if launches[n] <= 0:
            raise AssertionError(f"kernel {n} never launched by PP training")
    busy, top = profile_once(lambda: step(params, tok, tgt), top_n=60)

    def share(*keys):
        return sum(ms for name, _, ms in top if any(k in name for k in keys))

    rs_ms, ag_ms = share("reduce_scatter_kernel"), share("allgather_kernel")
    ring_ms, flash_ms = share("ag_gemm", "gemm_rs"), share("flash")
    log(f"pp train (a) profiled step: device busy {busy:.1f} ms of a "
        f"{wall:.1f} ms step, idle share {1 - busy / wall:.3f}; "
        f"reduce-scatter {rs_ms:.2f} ms + all-gather {ag_ms:.2f} ms "
        f"({(rs_ms + ag_ms) / busy:.4f} of busy), ring kernels "
        f"{ring_ms:.1f} ms ({ring_ms / busy:.3f}), flash kernels "
        f"{flash_ms:.1f} ms ({flash_ms / busy:.3f})")
    for name, n, ms in top[:14]:
        log(f"pp train (a)   {ms:8.2f} ms  x{n:<5d} {name[:90]}")
    del params, step

    # (b) the same two steps through the plain psum
    params, _ = fresh()
    step, _ = pp.make_pp_train_step(cfg, mesh, lr=SGD_LR,
                                    hier_dp_fast_axis=None, **kw)
    plain_losses = [float(step(params, tok, tgt)[1]) for _ in range(2)]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses[:2],
                                                       plain_losses))
    worst = ("", -1.0)
    for (name, a), b in zip(named_leaves(params), hier_leaves):
        b = b.to("cuda", torch.float32)
        rel = ((a.float() - b).norm() / b.norm()).item()
        if not rel <= 2e-2:
            raise AssertionError(f"pp train (b): leaf {name} relative L2 "
                                 f"{rel:.3e} > 2e-2")
        worst = max(worst, (name, rel), key=lambda x: x[1])
    log(f"pp train (b) hierarchical vs psum, 2 steps: losses "
        f"{[round(x, 6) for x in losses[:2]]} vs "
        f"{[round(x, 6) for x in plain_losses]} (relative {rel_loss:.2e}, "
        f"tol 1e-3); worst updated leaf {worst[0]} relative L2 "
        f"{worst[1]:.3e} (tol 2e-2)")
    if not rel_loss <= 1e-3:
        raise AssertionError(f"pp train (b): losses relative {rel_loss:.2e}")
    del params, step, hier_leaves

    # (c) 2 layers: the PP gradients against the non-PP step's and the
    # plain versions'
    free_cuda()
    cfg2 = replace(cfg, n_layers=2)
    stacked = pp.init_pp_params(cfg2, seed=0)
    flat = {k: v for k, v in stacked.items() if k != "layers"}
    flat["layers"] = [{k: v[i] for k, v in stacked["layers"].items()}
                      for i in range(2)]
    p2 = pp.place_pp_params(stacked, cfg2, mesh)
    loss_k, g_k = pp.make_pp_grads(cfg2, mesh, hier_dp_fast_axis="tp",
                                   **kw)(p2, tok, tgt)
    loss_p, g_p = pp.make_pp_grads(cfg2, mesh, hier_dp_fast_axis="tp",
                                   plain=True, **kw)(p2, tok, tgt)
    tp2 = llama.shard_params(flat, cfg2, 2)
    loss_t, g_t = value_and_grad(llama.loss_shard, tp2, tok, tgt, cfg2,
                                 world=2)
    checks = {"plain": [(n, a, b) for (n, a), (_, b) in
                        zip(named_leaves(g_k), named_leaves(g_p))],
              "non-pp": [(f"layers.{k}[{i}]", g_k["layers"][k][i], v)
                         for i, layer in enumerate(g_t["layers"])
                         for k, v in layer.items()]
              + [(k, g_k[k], g_t[k]) for k in ("embed", "final_norm",
                                                "lm_head")]}
    for tag, ref_loss in (("plain", loss_p), ("non-pp", loss_t)):
        rel_loss = abs(float(loss_k) - float(ref_loss)) / abs(float(ref_loss))
        worst = ("", 0.0)
        for name, a, b in checks[tag]:
            rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
            if not rel <= 2e-2:
                raise AssertionError(f"pp train (c) vs {tag}: gradient "
                                     f"{name} relative L2 {rel:.3e} > 2e-2")
            worst = max(worst, (name, rel), key=lambda x: x[1])
        log(f"pp train (c) 2 layers, PP kernels vs {tag}: loss "
            f"{float(loss_k):.6f} vs {float(ref_loss):.6f} (relative "
            f"{rel_loss:.2e}, tol 1e-3); worst gradient leaf {worst[0]} "
            f"relative L2 {worst[1]:.3e} (tol 2e-2)")
        if not rel_loss <= 1e-3:
            raise AssertionError(f"pp train (c) vs {tag}: loss relative "
                                 f"{rel_loss:.2e}")
    del p2, g_k, g_p, g_t, tp2, flat, stacked
    free_cuda()
    return launches


# ---------------------------------------------------------------------------
# phase 20: the TP ring GEMMs' host entries and ring modes
# ---------------------------------------------------------------------------

# the kernel rows of the ring modes: (module attribute, counter key)
RING_MODE_ROWS = {"ag_gemm_bidir": ("ag_gemm_shard", "bidir"),
                  "ag_gemm_wire": ("ag_gemm_shard", "wire"),
                  "ag_gemm_chunked": ("ag_gemm_shard", "chunked"),
                  "gemm_rs_bidir": ("gemm_rs_shard", "bidir"),
                  "gemm_rs_i8": ("gemm_rs_shard", "i8"),
                  "gemm_rs_i8_bidir": ("gemm_rs_shard", "i8_bidir")}
# the MoE overlap kernels' rows (phase 21): the counting function
MOE_TP_ROWS = {"ag_group_gemm": "ag_group_gemm_shard",
               "moe_rs": "moe_reduce_rs_shard"}
# the model paths that must launch none of them (their counts ride in the
# kernels line under "model_path_launches")
MODEL_PATH_COUNTS: dict = {}


def _off_path_fns():
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs

    return {"ag_gemm_shard": agm.ag_gemm_shard,
            "gemm_rs_shard": grs.gemm_rs_shard,
            "ag_group_gemm_shard": agg.ag_group_gemm_shard,
            "moe_reduce_rs_shard": mrs.moe_reduce_rs_shard}


def zero_off_path_counters():
    """Zero the counters of the kernels no model path launches: the ring
    modes' and the MoE overlap kernels'."""
    fns = _off_path_fns()
    for name in ("ag_gemm_shard", "gemm_rs_shard"):
        for k in fns[name].mode_launches:
            fns[name].mode_launches[k] = 0
    for name in MOE_TP_ROWS.values():
        fns[name].launches = 0


def read_ring_modes():
    fns = _off_path_fns()
    return {row: fns[f].mode_launches[k]
            for row, (f, k) in RING_MODE_ROWS.items()}


def read_moe_tp():
    fns = _off_path_fns()
    return {row: fns[f].launches for row, f in MOE_TP_ROWS.items()}


def record_model_path(phase):
    """Read the off-path counters after a model path (zeroed before it;
    the torus kernels' are never zeroed before phase 22, so theirs count
    the run so far): a model path passes no ring mode, calls no MoE
    overlap kernel and takes no torus schedule, so each must be 0."""
    counts = {**read_ring_modes(), **read_moe_tp(), **read_torus()}
    MODEL_PATH_COUNTS[phase] = counts
    log(f"{phase}: ring-mode, MoE overlap and torus launches {counts} "
        f"(expected 0: no model path takes them)")
    if any(counts.values()):
        raise AssertionError(f"{phase} launched an off-path kernel: {counts}")


def ring_modes_phase(dev, dims=(4096, 14336, (32 + 2 * 8) * 128),
                     sizes=(("prefill", 512), ("decode", 16)), ragged=250):
    """Phase 20: the TP ring GEMMs' host entries (``ag_gemm`` /
    ``ag_gemm_gathered`` / ``gemm_rs`` with contexts on a port Mesh of TP
    ranks) through the bidirectional, int8-wire and chunked ring modes at
    Llama-3-8B TP-4 widths, at the prefill size (S 2,048: m_loc 512) and a
    decode size (m_loc 16): (a) the AG-GEMM at QKV (N 6144) and gate/up
    (N 14336, K 4096) in modes bidir, wire, chunks 2 and chunks 4, the
    GEMM-RS at wo (k 4096) and down (k 14336, N 4096) in bidir and on int8
    operands in the uni and bidir modes; (b) ``ag_gemm_autotuned`` at
    gate/up and ``gemm_rs_autotuned`` at down, on bf16 and on int8
    operands, in one ``contextual_autotune`` region; the int8 rows also at
    a ragged m_loc (``ragged``, 250: "r250").
    The ring-mode counters are zeroed just before (a) and read just after
    (b): each new row's count.  Then every result is held against its
    plain version (the same context at ``impl="xla"``): the gathered A bit
    for bit, bf16 products by check_tiles over 128-row tiles, int8
    exactly; and each row is timed eagerly between CUDA events on the
    rank-stacked shard function (a launch carries its call's epoch: no
    graph) at every shape, beside its bound, its plain version and one
    PyTorch call of the same function where one exists.  ``dims`` (D,
    FFN, QKV width) and ``sizes`` (m_loc by name) are Llama-3-8B's unless
    a caller cuts them."""
    import torch

    from triton_dist_tpu_torch.autotuner import contextual_autotune
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    W, (D, F, QKV), sizes = TP, dims, dict(sizes)
    i8_sizes = {**sizes, "r250": ragged}
    mesh = Mesh((W,), ("tp",), dev)
    g = torch.Generator(device=dev).manual_seed(20)
    ag_modes = {"bidir": dict(ring_mode="bidir"),
                "wire": dict(wire_dtype="int8"),
                "chunks2": dict(chunks=2), "chunks4": dict(chunks=4)}
    ag_projs = {"qkv": (D, QKV), "gate_up": (D, F)}
    rs_projs = {"wo": (D, D), "down": (F, D)}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).bfloat16()

    def randi(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    inputs = {}
    for size, m_loc in sizes.items():
        for proj, (k, n) in ag_projs.items():
            inputs["ag", size, proj] = (randn(W * m_loc, k),
                                        randn(k, n, scale=k ** -0.5))
        for proj, (k, n) in rs_projs.items():
            inputs["rs", size, proj] = (randn(W * m_loc, k),
                                        randn(k, n, scale=k ** -0.5))
    for size, m_loc in i8_sizes.items():
        for proj, (k, n) in rs_projs.items():
            inputs["i8", size, proj] = (randi(W * m_loc, k), randi(k, n))

    # (a) + (b): the path, with the ring-mode counters zeroed first
    zero_off_path_counters()
    n_uni = (agm.ag_gemm_shard.launches, grs.gemm_rs_shard.launches)
    got = {}
    for key, (a, b) in inputs.items():
        kind, size, proj = key
        if kind == "ag":
            for mode, kw in ag_modes.items():
                got[key + (mode,)] = agm.ag_gemm_gathered(
                    a, b, agm.create_ag_gemm_context(mesh, **kw))
        elif kind == "rs":
            got[key] = grs.gemm_rs(a, b, grs.create_gemm_rs_context(
                mesh, ring_mode="bidir"))
        else:       # int8: the uni ring (row 15i) and the bidir (15bi)
            for mode in ("uni", "bidir"):
                got[key + (mode,)] = grs.gemm_rs(
                    a, b, grs.create_gemm_rs_context(mesh, ring_mode=mode))

    @contextual_autotune()     # the reference's 3 warm-up and 5 timed calls
    def tuned_op(x, w, x2, w2, x3, w3):
        ctx = grs.create_gemm_rs_context(mesh)
        return (agm.ag_gemm_autotuned(x, w, agm.create_ag_gemm_context(
            mesh)), grs.gemm_rs_autotuned(x2, w2, ctx),
            grs.gemm_rs_autotuned(x3, w3, ctx))

    t0 = time.perf_counter()
    tuned = tuned_op(*inputs["ag", "prefill", "gate_up"],
                     *inputs["rs", "prefill", "down"],
                     *inputs["i8", "prefill", "down"])
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches = read_ring_modes()
    uni = (agm.ag_gemm_shard.launches - n_uni[0],
           grs.gemm_rs_shard.launches - n_uni[1])
    log(f"ring modes: phase 20 launches {launches}; uni launches "
        f"(autotune sweeps) ag_gemm {uni[0]}, gemm_rs {uni[1]}")
    for row, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {row} never launched by phase 20")
    for tuner, name, dt in (
            (agm._ag_gemm_tunable, "ag_gemm_autotuned gate_up", "bfloat16"),
            (grs._gemm_rs_tunable, "gemm_rs_autotuned down", "bfloat16"),
            (grs._gemm_rs_tunable, "gemm_rs_autotuned down int8", "int8")):
        key = next(k for k in reversed(tuner.sweeps)
                   if any(f"torch.{dt}" in str(x) for x in k))
        sweep = tuner.sweeps[key]
        log(f"{name}: " + ", ".join(f"{c} {ms:.4f} ms" for c, ms in sweep)
            + f"; winner {tuner.cache[key]} (region {tune_s:.2f} s)")
        if dt == "int8" and not any(c.get("ring_mode") == "bidir"
                                    for c, _ in sweep):
            raise AssertionError(f"{name} timed no bidir config: {sweep}")

    # the checks, against the plain versions
    errs = {}

    def tiles(tag, c, want):
        return check_tiles(tag, c, want, min(128, want.shape[0]))

    for key, res in got.items():
        kind, size, proj = key[:3]
        a, b = inputs[key[:3]]
        tag = f"{'/'.join(key)} (W {W}, m_loc {i8_sizes[size]})"
        if kind == "ag":
            mode = key[3]
            full, c = res
            want_full, want_c = agm.ag_gemm_gathered(
                a, b, agm.create_ag_gemm_context(mesh, impl="xla",
                                                 **ag_modes[mode]))
            if not torch.equal(full, want_full):
                raise AssertionError(f"{tag}: gathered A differs")
            row = "ag_gemm_" + ("chunked" if "chunks" in mode else mode)
            errs[row, size, proj, mode] = tiles(tag, c, want_c)
        elif kind == "rs":
            want = grs.gemm_rs(a, b, grs.create_gemm_rs_context(
                mesh, impl="xla", ring_mode="bidir"))
            errs["gemm_rs_bidir", size, proj, "bidir"] = tiles(tag, res,
                                                               want)
        else:
            mode = key[3]
            want = grs.gemm_rs(a, b, grs.create_gemm_rs_context(
                mesh, impl="xla", ring_mode=mode))
            same = torch.equal(res, want)
            log(f"{tag}: int32 C exactly equal {same}")
            if not same:
                raise AssertionError(f"{tag} disagrees with plain")
            if mode == "uni":
                errs["gemm_rs_i8", size, proj, "i8"] = 0.0
            else:
                errs["gemm_rs_i8_bidir", size, proj, "i8_bidir"] = 0.0
    del got
    c, c2, c3 = tuned
    a, b = inputs["i8", "prefill", "down"]
    if not torch.equal(c3, grs.gemm_rs(a, b, grs.create_gemm_rs_context(
            mesh, impl="xla"))):
        raise AssertionError("gemm_rs_autotuned down int8 (winner) "
                             "disagrees with plain")
    a, b = inputs["ag", "prefill", "gate_up"]
    tiles("ag_gemm_autotuned gate_up (winner)", c, agm.ag_gemm(
        a, b, agm.create_ag_gemm_context(mesh, impl="xla")))
    a, b = inputs["rs", "prefill", "down"]
    tiles("gemm_rs_autotuned down (winner)", c2, grs.gemm_rs(
        a, b, grs.create_gemm_rs_context(mesh, impl="xla")))
    del tuned, c, c2, c3

    # the times, on the rank-stacked shard functions
    rows = {}
    for (row, size, proj, mode), err in errs.items():
        m_loc = i8_sizes[size]
        kind = "ag" if row.startswith("ag") else (
            "rs" if row == "gemm_rs_bidir" else "i8")
        ring = "bidir" if row == "gemm_rs_i8_bidir" else "uni"
        a, b = inputs[kind, size, proj]
        k, n = a.shape[1], b.shape[1]
        if kind == "ag":
            kw = ag_modes[mode]
            a_r = a.view(W, m_loc, k)
            b_r = b.view(k, W, n // W).permute(1, 0, 2).contiguous()
            ms = event_ms(lambda: agm.ag_gemm_shard(a_r, b_r, **kw), iters=10)
            plain = lambda: agm.ag_gemm_ref(a_r, b_r,  # noqa: E731
                                            wire="wire_dtype" in kw)
            ops = 2 * W * m_loc * n * k
            wire = "wire_dtype" in kw
            n_bytes = 2 * W * m_loc * k + 2 * k * n + 2 * W * m_loc * n + (
                W * W * m_loc * (k + 4) if wire else 2 * W * W * m_loc * k)
            if wire:
                lib, lib_call = None, ("no one PyTorch call quantizes "
                                       "each row to int8 before the product")
            else:
                af = a.view(1, W * m_loc, k).expand(W, -1, -1)
                lib = time_ms(lambda: torch.matmul(af, b_r), iters=5)
                lib_call = "batched torch.matmul of the gathered view"
            b_ms, b_by = bound_ms(n_bytes, ops)
        elif kind == "rs":
            a_r = a.view(W * m_loc, W, k // W).permute(1, 0, 2).contiguous()
            b_r = b.view(W, k // W, n)
            ms = event_ms(lambda: grs.gemm_rs_shard(a_r, b_r,
                                                    ring_mode="bidir"),
                          iters=10)
            plain = lambda: grs.gemm_rs_ref(a_r, b_r,  # noqa: E731
                                            ring_mode="bidir")
            ops = 2 * W * m_loc * n * k
            b_ms, b_by = bound_ms(2 * (W * m_loc * k + k * n + W * m_loc * n),
                                  ops)
            a4 = a_r.view(W, W, m_loc, k // W)
            lib = time_ms(lambda: torch.einsum("qrmk,qkn->rmn", a4, b_r),
                          iters=5)
            lib_call = "torch.einsum"
        else:
            a_r = a.view(W * m_loc, W, k // W).permute(1, 0, 2).contiguous()
            b_r = b.view(W, k // W, n)
            ms = event_ms(lambda: grs.gemm_rs_shard(a_r, b_r,
                                                    ring_mode=ring),
                          iters=10)
            plain = lambda: grs.gemm_rs_ref(a_r, b_r)  # noqa: E731
            ops = 2 * W * m_loc * n * k
            b_ms, b_by = bound_ms(W * m_loc * k + k * n + 4 * W * m_loc * n,
                                  ops, INT8_OPS_S)
            if W * m_loc > 16:
                b_cm = b.t().contiguous().t()
                lib = time_ms(lambda: torch._int_mm(a, b_cm), iters=5)
                lib_call = ("torch._int_mm of the rows against B "
                            "column-major: the sum over ranks is the "
                            "contraction")
            else:
                lib, lib_call = None, "cuBLASLt takes no m <= 16"
        headline = (size == "prefill" and proj in ("gate_up", "down")
                    and mode in ("bidir", "wire", "chunks2", "i8",
                                 "i8_bidir"))
        plain_ms = time_ms(plain, iters=2, reps=2) if headline else None
        log(f"{row} {proj} {mode} {size} (W {W}, m_loc {m_loc}, k {k}, N "
            f"{n}): kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
            f"{'TOP' if kind == 'i8' else 'TFLOP'}/s over {W} ranks), bound "
            f"{b_ms:.4f} ms ({b_by}), plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
            f"library {'null' if lib is None else f'{lib:.4f} ms'} "
            f"({lib_call})")
        entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                     max_abs_err=err)
        r = rows.setdefault(row, {"shapes": {}})
        r["shapes"][f"{proj}_{mode}_{size}"] = entry
        if headline:
            r.update(entry, plain_ms=plain_ms)
            if lib is None:
                r["library_null_reason"] = lib_call
    return rows, launches


# ---------------------------------------------------------------------------
# phase 21: the MoE overlap kernels at Mixtral-8x7B TP-4 widths
# ---------------------------------------------------------------------------

MOE_TP_ROUTINGS = ("balanced", "skewed", "empty")


def _grouped_mm_ms(a, w, te, block_m, n_experts):
    """(ms, None) of one ``torch._grouped_mm`` over the same assignments:
    a's row tiles sorted by expert (each segment's groups gathered per
    expert, padding as it is) against the whole [E, K, N] stack, timed
    eagerly; (None, reason) where this PyTorch lacks it or it fails."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "this PyTorch has no torch._grouped_mm"
    te = te.reshape(-1).long()
    order = torch.argsort(te, stable=True)
    rows = a.reshape(-1, block_m, a.shape[-1])[order].reshape(-1, a.shape[-1])
    offs = (torch.bincount(te, minlength=n_experts).cumsum(0) * block_m).to(
        torch.int32)
    try:
        torch._grouped_mm(rows, w, offs=offs)
        return event_ms(lambda: torch._grouped_mm(rows, w, offs=offs),
                        iters=10), None
    except Exception as e:   # a yardstick only: report why it is null
        return None, f"torch._grouped_mm failed: {str(e)[:120]}"


def moe_tp_phase(dev, dims=(4096, 14336, 8, 2),
                 sizes=(("prefill", 2048, None), ("prefill_bm128", 2048, 128),
                        ("decode", 32, None))):
    """Phase 21: the MoE overlap kernels' host entries on a port Mesh of TP
    ranks at Mixtral-8x7B's expert widths (D 4096, F 14336, F_loc 3584, E
    8, top-2, bf16; weights and tokens from seed 0), at each size (name,
    tokens, block_m: None takes the load-aware default) under balanced,
    skewed and one-empty-expert routing: (a) ``ag_group_gemm`` with the
    gate slabs [E, D, F] and ``moe_reduce_rs`` with the down slabs [E, F,
    D] on h built in the sorted layout from a seeded [T, F] activation;
    (b) ``ag_group_gemm_autotuned`` and ``moe_reduce_rs_autotuned`` in one
    ``contextual_autotune`` region (every config's time and the winner
    printed); (c) the host planner (``impl="native"``) on the prefill
    routing, equal to numpy.  The two kernels' counters are zeroed just
    before (a) and read just after (c): each row's count.  Then every host
    entry's output against the same context at ``impl="xla"``, and each
    kernel's wrapper against its plain version: the gathered sorted x bit
    for bit, the grouped outputs by check_tiles over 128-row tiles,
    padding rows exactly zero, ten calls in a row each equal to the
    first; each kernel timed eagerly between CUDA events (a launch
    carries its epoch: no graph) beside its bounds (useful work 2 T topk
    D F, the padded work the kernel does, and bytes), its plain version
    and one ``torch._grouped_mm`` of the same product."""
    import torch

    from triton_dist_tpu_torch.autotuner import contextual_autotune
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.kernels import moe_utils as mu
    from triton_dist_tpu_torch.runtime import host_ops
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    W, (D, F, E, topk) = TP, dims
    mesh = Mesh((W,), ("tp",), dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).bfloat16()

    w_gate = randn(E, D, F, scale=D ** -0.5)
    w_down = randn(E, F, D, scale=F ** -0.5)
    cases = {}
    for size, T, bm in sizes:
        for kind in MOE_TP_ROUTINGS:
            logits = torch.randn((T, E), generator=g, device=dev)
            if kind == "skewed":       # most assignments on experts 0, 1
                logits[:, :2] += 4.0
            elif kind == "empty":      # expert E - 1 gets no token
                logits[:, -1] = -1e9
            weights, experts = mu.topk_routing(logits, topk)
            block_m = bm or agg.resolve_block_m(
                agg.create_ag_group_gemm_context(mesh, E, topk), T)
            dest, te, m_pad = agg._segment_plans(
                experts.view(W, -1, topk), E, block_m)
            act = randn(T, F).view(W, T // W, F)
            h = torch.cat([mu.gather_sorted(act[s], dest[s], m_pad)
                           for s in range(W)])
            cases[size, kind] = dict(T=T, bm=bm, block_m=block_m,
                                     m_pad=m_pad, dest=dest, te=te,
                                     x=randn(T, D), weights=weights,
                                     experts=experts, h=h)
            log(f"moe tp {size} {kind}: T {T}, block_m {block_m}, m_pad "
                f"{m_pad} a segment ({W * m_pad} gathered rows for "
                f"{T * topk} assignments), experts used "
                f"{sorted(set(experts.flatten().tolist()))}")

    def ctxs(c, **kw):
        return (agg.create_ag_group_gemm_context(mesh, E, topk,
                                                 block_m=c["bm"], **kw),
                mrs.create_moe_rs_context(mesh, E, topk, block_m=c["bm"],
                                          **kw))

    # (a) - (c): the path, with the two kernels' counters zeroed first
    zero_off_path_counters()
    got = {}
    for key, c in cases.items():
        ag_ctx, rs_ctx = ctxs(c)
        got[key] = (agg.ag_group_gemm(c["x"], c["weights"], c["experts"],
                                      w_gate, ag_ctx),
                    mrs.moe_reduce_rs(c["h"], w_down, c["weights"],
                                      c["experts"], rs_ctx))
    c0 = cases["prefill", "balanced"]

    @contextual_autotune()     # the reference's 3 warm-up and 5 timed calls
    def tuned_op():
        ag_ctx, rs_ctx = ctxs(c0)
        return (agg.ag_group_gemm_autotuned(c0["x"], c0["weights"],
                                            c0["experts"], w_gate, ag_ctx),
                mrs.moe_reduce_rs_autotuned(c0["h"], w_down, c0["weights"],
                                            c0["experts"], rs_ctx))

    t0 = time.perf_counter()
    tuned = tuned_op()
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    ids = c0["experts"].cpu().numpy()
    plan = {impl: host_ops.moe_ag_scatter_align_block_size(
        ids, W, E, c0["block_m"], impl=impl) for impl in ("native", "numpy")}
    launches = read_moe_tp()
    log(f"moe tp: phase 21 launches {launches}")
    for row, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {row} never launched by phase 21")
    for tuner, name in ((agg._ag_group_gemm_tunable,
                         "ag_group_gemm_autotuned"),
                        (mrs._moe_reduce_rs_tunable,
                         "moe_reduce_rs_autotuned")):
        sweep = next(reversed(tuner.sweeps.values()))
        log(f"{name} prefill: " + ", ".join(f"{c} {ms:.4f} ms"
                                            for c, ms in sweep)
            + f"; winner {tuner.best_config} (region {tune_s:.2f} s)")
    same = all(np.array_equal(plan["native"][k], plan["numpy"][k])
               for k in plan["numpy"])
    log(f"host planner (native vs numpy, prefill routing, block_m "
        f"{c0['block_m']}): equal {same}, total_padded "
        f"{plan['native']['total_padded']}, rank_block_num "
        f"{plan['native']['rank_block_num'].tolist()}")
    if not same:
        raise AssertionError("the native host planner differs from numpy")

    # the checks, against the plain versions
    def tiles(tag, out, want):
        return check_tiles(tag, out, want, min(128, want.shape[0]))

    for key, (out_ag, out_rs) in got.items():
        c = cases[key]
        tag = f"{'/'.join(key)} (W {W}, T {c['T']}, block_m {c['block_m']})"
        ag_ctx, rs_ctx = ctxs(c, impl="xla")
        tiles(f"ag_group_gemm host {tag}", out_ag, agg.ag_group_gemm(
            c["x"], c["weights"], c["experts"], w_gate, ag_ctx))
        tiles(f"moe_reduce_rs host {tag}", out_rs, mrs.moe_reduce_rs(
            c["h"], w_down, c["weights"], c["experts"], rs_ctx))
    del got
    out_ag, out_rs = tuned
    ag_ctx, rs_ctx = ctxs(c0, impl="xla")
    tiles("ag_group_gemm_autotuned (winner)", out_ag, agg.ag_group_gemm(
        c0["x"], c0["weights"], c0["experts"], w_gate, ag_ctx))
    tiles("moe_reduce_rs_autotuned (winner)", out_rs, mrs.moe_reduce_rs(
        c0["h"], w_down, c0["weights"], c0["experts"], rs_ctx))
    del tuned, out_ag, out_rs

    w_r = w_gate.view(E, D, W, F // W).permute(2, 0, 1, 3)
    wd_r = w_down.view(E, W, F // W, D).permute(1, 0, 2, 3)
    rows = {}
    for key, c in cases.items():
        size, kind = key
        T, bm, m_pad, te, dest = (c["T"], c["block_m"], c["m_pad"], c["te"],
                                  c["dest"])
        tag = f"{size}/{kind} (W {W}, T {T}, block_m {bm}, m_pad {m_pad})"
        x_seg = c["x"].view(W, T // W, D)
        xs = torch.stack([mu.gather_sorted(x_seg[r], dest[r], m_pad)
                          for r in range(W)])
        h_r = c["h"].view(W * m_pad, W, F // W).permute(1, 0, 2)
        valid = torch.zeros((W, m_pad), dtype=torch.bool, device=dev)
        valid.scatter_(1, dest, torch.ones_like(dest, dtype=torch.bool))
        # the kernels against their plain versions, then ten calls each
        gathered, y = agg.ag_group_gemm_sorted(xs, w_r, te, block_m=bm)
        ys = mrs.moe_rs_sorted(h_r, wd_r, te, block_m=bm)
        torch.cuda.synchronize()
        want_g, want_y = agg.ag_group_gemm_ref(xs, w_r, te, block_m=bm)
        if not torch.equal(gathered, want_g):
            raise AssertionError(f"ag_group_gemm {tag}: gathered x differs")
        err_ag = max(tiles(f"ag_group_gemm {tag} rank {r}", y[r], want_y[r])
                     for r in range(W))
        del want_g, want_y
        want_ys = mrs.moe_rs_ref(h_r, wd_r, te, block_m=bm)
        err_rs = max(tiles(f"moe_rs {tag} rank {r}", ys[r], want_ys[r])
                     for r in range(W))
        del want_ys
        pad_zero = bool((y[:, ~valid.view(-1)] == 0).all()
                        and (ys[~valid] == 0).all())
        for _ in range(10):
            g2, y2 = agg.ag_group_gemm_sorted(xs, w_r, te, block_m=bm)
            ys2 = mrs.moe_rs_sorted(h_r, wd_r, te, block_m=bm)
            if not (torch.equal(g2, gathered) and torch.equal(y2, y)
                    and torch.equal(ys2, ys)):
                raise AssertionError(f"{tag}: a call of ten in a row "
                                     f"differs from the first")
        del g2, y2, ys2, gathered, y, ys
        log(f"moe tp {tag}: gathered x bit for bit, padding rows zero "
            f"{pad_zero}, ten calls in a row equal")
        if not pad_zero:
            raise AssertionError(f"{tag}: padding rows are not zero")

        # the times and bounds
        useful = 2 * T * topk * D * F
        padded = 2 * W * m_pad * D * F
        n_slabs = len(set(c["experts"].flatten().tolist()))
        slab_bytes = n_slabs * D * F * 2
        by_ag = (W * m_pad * D + W * W * m_pad * D + W * m_pad * F) * 2 \
            + slab_bytes
        by_rs = (W * m_pad * F + W * m_pad * D) * 2 + slab_bytes
        headline = kind == "balanced"
        for row, fn, plain, n_bytes, err, lib_args in (
                ("ag_group_gemm",
                 lambda: agg.ag_group_gemm_sorted(xs, w_r, te, block_m=bm),
                 lambda: agg.ag_group_gemm_ref(xs, w_r, te, block_m=bm),
                 by_ag, err_ag, (xs, w_gate)),
                ("moe_rs",
                 lambda: mrs.moe_rs_sorted(h_r, wd_r, te, block_m=bm),
                 lambda: mrs.moe_rs_ref(h_r, wd_r, te, block_m=bm),
                 by_rs, err_rs, (c["h"], w_down))):
            ms = event_ms(fn, iters=10)
            b_ms, b_by = bound_ms(n_bytes, useful)
            pad_ms = padded / BF16_FLOPS_S * 1e3
            slab_ms = slab_bytes / HBM_BYTES_S * 1e3
            plain_ms = event_ms(plain, iters=2) if headline else None
            lib, why = (_grouped_mm_ms(*lib_args, te, bm, E) if headline
                        else (None, "timed at balanced routing only"))
            log(f"{row} {size} {kind} (W {W}, T {T}, block_m {bm}, m_pad "
                f"{m_pad}): kernel {ms:.4f} ms ({padded / ms / 1e9:.1f} "
                f"TFLOP/s padded, {useful / ms / 1e9:.1f} useful), bound "
                f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, useful "
                f"{useful / 1e9:.1f} GFLOP), padded-work bound {pad_ms:.4f} "
                f"ms ({padded / 1e12:.3f} TFLOP), slab bytes {slab_ms:.4f} "
                f"ms ({n_slabs} slabs, {slab_bytes / 1e6:.1f} MB), plain "
                f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}"
                f", library {'null' if lib is None else f'{lib:.4f} ms'} "
                f"({why or 'torch._grouped_mm, rows sorted by expert, whole '
                 'F against the whole [E, ., .] stack'})")
            entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                         padded_ops_bound_ms=pad_ms, slab_bytes_ms=slab_ms,
                         library_ms=lib, max_abs_err=err, block_m=bm,
                         m_pad=m_pad)
            r = rows.setdefault(row, {"shapes": {}})
            r["shapes"][f"{size}_{kind}"] = entry
            if key == ("prefill", "balanced"):
                r.update(entry, plain_ms=plain_ms)
                if lib is None:
                    r["library_null_reason"] = why
            elif plain_ms is not None:
                entry["plain_ms"] = plain_ms
    del cases, w_gate, w_down, w_r, wd_r
    return rows, launches


# ---------------------------------------------------------------------------
# phase 22: the torus (multi-axis) collectives and ring GEMMs at Llama-3-8B
# TP-8 widths over the (2, 4), (4, 2) and (2, 2, 2) meshes
# ---------------------------------------------------------------------------

TORUS_MESHES = (((2, 4), ("x", "y")), ((4, 2), ("x", "y")),
                ((2, 2, 2), ("x", "y", "z")))
# the kernel rows of phase 22: (module, the counting function)
TORUS_ROWS = {"torus_ag": ("torus", "torus_all_gather_shard"),
              "torus_rs": ("torus", "torus_reduce_scatter_shard"),
              "torus_ag_gemm": ("allgather_gemm", "torus_ag_gemm"),
              "torus_ag_gemm_i8": ("allgather_gemm", "torus_ag_gemm_i8"),
              "torus_gemm_rs": ("gemm_reduce_scatter", "torus_gemm_rs"),
              "torus_gemm_rs_i8": ("gemm_reduce_scatter",
                                   "torus_gemm_rs_i8")}


def _torus_fns():
    import importlib

    return {row: getattr(importlib.import_module(
        f"triton_dist_tpu_torch.kernels.{mod}"), fn)
        for row, (mod, fn) in TORUS_ROWS.items()}


def read_torus():
    return {row: fn.launches for row, fn in _torus_fns().items()}


def torus_phase(dev, dims=(4096, 14336, 6144), tokens=2048, ragged=250):
    """Phase 22: the multi-axis (torus) schedules at Llama-3-8B TP-8 widths
    (D 4096, F 14336, QKV 6144; a 2,048-token prefill, 256 rows a rank;
    bf16, random from seed 0) on the virtual world's (2, 4), (4, 2) and
    (2, 2, 2) meshes, the tuple axis all of the mesh's axes.  The path,
    with the six kernels' counters zeroed just before and read just after
    (each > 0; each read 0 at the start of the phase, so no earlier phase
    took a torus schedule): on every mesh the host entries ``all_gather``
    ([2048, 4096]: 2 MiB a rank, the torus kernel), ``reduce_scatter``
    (stacked [8, 2048, 4096] partials, f32 and bf16), ``ag_gemm_gathered``
    at gate/up (N 14336) and in int8, ``ag_gemm`` at QKV, ``gemm_rs`` at
    down (K 14336), wo (K 4096) and in int8, then ``ag_gemm_autotuned`` /
    ``gemm_rs_autotuned`` in one ``contextual_autotune`` region.  Checks:
    every host entry against the same context's plain versions
    (``impl="xla"``; the gathers exactly, the GEMMs by check_tiles over
    128-row tiles, int8 exactly, the reduce-scatter against the f32 sum);
    each kernel's wrapper against its plain version on every mesh (the
    all-gather and the gathered A bit for bit, the reduce-scatter bit for
    bit in f32 and bf16, the GEMMs by check_tiles, int8 exactly); ten
    calls of each in a row on the (2, 4) mesh equal to the first; the int8
    GEMM-RS also at a ragged m_loc (``ragged`` rows a rank) on every mesh,
    exactly.  Times
    (eager between CUDA events: each launch carries its epoch) on the
    (2, 4) mesh beside the bound (the function's bytes or operations),
    the plain version and one PyTorch call: ``expand(...).contiguous()``
    of the gathered view (22a), one ``sum`` over the rank dimension
    (22r), a batched ``torch.matmul`` of the gathered view (14), one
    ``torch.einsum`` (16), ``torch._int_mm`` (14i, 16i).  Rows report
    (2, 4) at gate/up, down and f32; the rest ride under "shapes"."""
    import torch

    from triton_dist_tpu_torch.autotuner import contextual_autotune
    from triton_dist_tpu_torch.kernels import allgather as ag
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs
    from triton_dist_tpu_torch.kernels import torus

    (D, F, QKV), M, W = dims, tokens, 8
    before = read_torus()
    log(f"torus: launches before phase 22 {before} (expected 0: no earlier "
        f"phase takes a torus schedule)")
    if any(before.values()):
        raise AssertionError(f"a torus kernel launched before phase 22: "
                             f"{before}")
    g = torch.Generator(device=dev).manual_seed(0)

    def tiles(tag, got, want):
        return check_tiles(tag, got, want, min(128, want.shape[0]))

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def randi(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    x = randn(M, D)
    parts = {"f32": randn(W, M, D, dtype=torch.float32)}
    parts["bf16"] = parts["f32"].bfloat16()
    w = {"gate_up": randn(D, F, scale=D ** -0.5),
         "qkv": randn(D, QKV, scale=D ** -0.5),
         "down": randn(F, D, scale=F ** -0.5),
         "wo": randn(D, D, scale=D ** -0.5)}
    a_rs = {"down": randn(M, F), "wo": randn(M, D)}
    i8 = {"ag": (randi(M, D), randi(D, F)), "rs": (randi(M, F), randi(F, D))}
    meshes = [("x".join(map(str, shape)), names, _mesh(shape, names))
              for shape, names in TORUS_MESHES]

    # the path
    for fn in _torus_fns().values():
        fn.launches = 0
    got = {}
    for tag, axes, mesh in meshes:
        actx = agm.create_ag_gemm_context(mesh, axis=axes)
        rctx = grs.create_gemm_rs_context(mesh, axis=axes)
        got[tag, "ag"] = ag.all_gather(x, ag.create_allgather_context(
            mesh, axis=axes))
        for dt, p in parts.items():
            got[tag, f"rs_{dt}"] = rs.reduce_scatter(
                p, rs.create_reduce_scatter_context(mesh, axis=axes))
        got[tag, "gate_up"] = agm.ag_gemm_gathered(x, w["gate_up"], actx)
        got[tag, "qkv"] = agm.ag_gemm(x, w["qkv"], actx)
        got[tag, "ag_i8"] = agm.ag_gemm_gathered(*i8["ag"], actx)
        for proj in ("down", "wo"):
            got[tag, proj] = grs.gemm_rs(a_rs[proj], w[proj], rctx)
        got[tag, "rs_i8"] = grs.gemm_rs(*i8["rs"], rctx)
    mesh0, axes0 = meshes[0][2], meshes[0][1]

    @contextual_autotune(n_repeat=2, n_warmup=1)
    def tuned_op():
        return (agm.ag_gemm_autotuned(x, w["gate_up"],
                                      agm.create_ag_gemm_context(
                                          mesh0, axis=axes0)),
                grs.gemm_rs_autotuned(a_rs["down"], w["down"],
                                      grs.create_gemm_rs_context(
                                          mesh0, axis=axes0)))

    tuned = tuned_op()
    torch.cuda.synchronize()
    launches = read_torus()
    log(f"torus: phase 22 launches {launches}")
    for row, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {row} never launched by phase 22")
    for tuner, name in ((agm._ag_gemm_tunable, "ag_gemm_autotuned"),
                        (grs._gemm_rs_tunable, "gemm_rs_autotuned")):
        sweep = next(reversed(tuner.sweeps.values()))
        log(f"{name} (torus, 2x4): " + ", ".join(
            f"{c} {ms:.4f} ms" for c, ms in sweep)
            + f"; winner {tuner.best_config}")

    # the host entries against the plain versions
    for tag, axes, mesh in meshes:
        xctx = agm.create_ag_gemm_context(mesh, axis=axes, impl="xla")
        rxctx = grs.create_gemm_rs_context(mesh, axis=axes, impl="xla")
        same = torch.equal(got[tag, "ag"], x)
        for dt, p in parts.items():
            want = p.float().sum(0)
            err = (got[tag, f"rs_{dt}"].float() - want).abs().max().item()
            tol = (1e-4 if dt == "f32" else 4e-2) * want.abs().max().item()
            log(f"torus host reduce_scatter {dt} {tag}: max |err| against "
                f"the f32 sum {err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"torus host reduce_scatter {dt} {tag}")
        full, c = got[tag, "gate_up"]
        want_full, want_c = agm.ag_gemm_gathered(x, w["gate_up"], xctx)
        same = same and torch.equal(full, want_full)
        tiles(f"torus host ag_gemm gate_up {tag}", c, want_c)
        tiles(f"torus host ag_gemm qkv {tag}", got[tag, "qkv"],
                    agm.ag_gemm(x, w["qkv"], xctx))
        full, c = got[tag, "ag_i8"]
        want_full, want_c = agm.ag_gemm_gathered(*i8["ag"], xctx)
        same = same and torch.equal(full, want_full) and torch.equal(
            c, want_c)
        for proj in ("down", "wo"):
            tiles(f"torus host gemm_rs {proj} {tag}", got[tag, proj],
                        grs.gemm_rs(a_rs[proj], w[proj], rxctx))
        same = same and torch.equal(got[tag, "rs_i8"],
                                    grs.gemm_rs(*i8["rs"], rxctx))
        log(f"torus host entries {tag}: gathers and int8 exactly equal "
            f"{same}")
        if not same:
            raise AssertionError(f"torus host entries {tag} differ")
    c, c2 = tuned
    tiles("ag_gemm_autotuned (torus, winner)", c,
                got[meshes[0][0], "gate_up"][1])
    tiles("gemm_rs_autotuned (torus, winner)", c2,
                got[meshes[0][0], "down"])
    del got, tuned, c, c2
    free_cuda()

    # each wrapper against its plain version, then the times on (2, 4)
    rows = {row: {"shapes": {}} for row in TORUS_ROWS}

    def stacked(tag, mesh):
        """The rank-stacked operands of every row (the tuple is the mesh's
        axes in mesh order, so joint index = world rank)."""
        n_loc = {"gate_up": F // W, "qkv": QKV // W}
        k_loc = {"down": F // W, "wo": D // W}
        return dict(
            ag=(x.view(*mesh.shape, M // W, D),),
            rs_f32=(parts["f32"].view(*mesh.shape, M, D),),
            rs_bf16=(parts["bf16"].view(*mesh.shape, M, D),),
            **{p: (x.view(W, M // W, D), w[p].view(D, W, n).permute(
                1, 0, 2).contiguous()) for p, n in n_loc.items()},
            ag_i8=(i8["ag"][0].view(W, M // W, D), i8["ag"][1].view(
                D, W, F // W).permute(1, 0, 2).contiguous()),
            **{p: (a_rs[p].view(M, W, k).permute(1, 0, 2).contiguous(),
                   w[p].view(W, k, D)) for p, k in k_loc.items()},
            rs_i8=(i8["rs"][0].view(M, W, F // W).permute(
                1, 0, 2).contiguous(), i8["rs"][1].view(W, F // W, D)))

    calls = {"ag": ("torus_ag", torus.torus_all_gather_shard,
                    torus.torus_all_gather_ref),
             "rs_f32": ("torus_rs", torus.torus_reduce_scatter_shard,
                        torus.torus_reduce_scatter_ref),
             "rs_bf16": ("torus_rs", torus.torus_reduce_scatter_shard,
                         torus.torus_reduce_scatter_ref),
             "gate_up": ("torus_ag_gemm", agm.torus_ag_gemm,
                         agm.torus_ag_gemm_ref),
             "qkv": ("torus_ag_gemm", agm.torus_ag_gemm,
                     agm.torus_ag_gemm_ref),
             "ag_i8": ("torus_ag_gemm_i8", agm.torus_ag_gemm_i8,
                       agm.torus_ag_gemm_ref),
             "down": ("torus_gemm_rs", grs.torus_gemm_rs,
                      grs.torus_gemm_rs_ref),
             "wo": ("torus_gemm_rs", grs.torus_gemm_rs,
                    grs.torus_gemm_rs_ref),
             "rs_i8": ("torus_gemm_rs_i8", grs.torus_gemm_rs_i8,
                       grs.torus_gemm_rs_ref)}

    def agree(key, out, want):
        """0.0 for an exact row (bit for bit), else check_tiles' max
        |err|."""
        if key in ("ag", "rs_f32", "rs_bf16", "ag_i8", "rs_i8"):
            pairs = list(zip(out, want)) if isinstance(out, tuple) else [
                (out, want)]
            if not all(torch.equal(o, wnt) for o, wnt in pairs):
                raise AssertionError(f"torus {key}: not bit-equal to plain")
            return 0.0
        if isinstance(out, tuple):
            if not torch.equal(out[0], want[0]):
                raise AssertionError(f"torus {key}: gathered A differs")
            out, want = out[1], want[1]
        return tiles(f"torus {key}", out.reshape(-1, out.shape[-1]),
                           want.reshape(-1, want.shape[-1]))

    for tag, axes, mesh in meshes:
        ops = stacked(tag, mesh)
        for key, (row, fn, ref) in calls.items():
            args = ops[key]
            out = fn(*args, mesh, axes)
            torch.cuda.synchronize()
            err = agree(key, out, ref(*args, mesh, axes))
            del out
            if tag == "2x4":
                first = fn(*args, mesh, axes)
                for _ in range(9):
                    again = fn(*args, mesh, axes)
                    same = all(torch.equal(u, v) for u, v in zip(
                        again if isinstance(again, tuple) else (again,),
                        first if isinstance(first, tuple) else (first,)))
                    if not same:
                        raise AssertionError(f"torus {key}: a call of ten "
                                             f"in a row differs")
                del first, again
                rows[row]["shapes"][f"{key}_{tag}"] = _torus_times(
                    key, args, mesh, axes, fn, ref, err, W, M, D, F, QKV)
            free_cuda()
        log(f"torus {tag}: every kernel equal to its plain version"
            + (", ten calls in a row equal" if tag == "2x4" else ""))
        del ops
    r = min(ragged, M // W - 1)
    a8 = i8["rs"][0][:W * r].view(W * r, W, F // W).permute(
        1, 0, 2).contiguous()
    b8 = i8["rs"][1].view(W, F // W, D)
    for tag, axes, mesh in meshes:
        if not torch.equal(grs.torus_gemm_rs_i8(a8, b8, mesh, axes),
                           grs.torus_gemm_rs_ref(a8, b8, mesh, axes)):
            raise AssertionError(f"torus rs_i8 {tag} at m_loc {r}: not "
                                 f"equal to plain")
    log(f"torus rs_i8 at m_loc {r}: exactly equal to plain on every mesh")
    del a8, b8
    for row, key in (("torus_ag", "ag_2x4"), ("torus_rs", "rs_f32_2x4"),
                     ("torus_ag_gemm", "gate_up_2x4"),
                     ("torus_ag_gemm_i8", "ag_i8_2x4"),
                     ("torus_gemm_rs", "down_2x4"),
                     ("torus_gemm_rs_i8", "rs_i8_2x4")):
        rows[row].update(rows[row]["shapes"][key])
    return rows, launches


def _torus_times(key, args, mesh, axes, fn, ref, err, W, M, D, F, QKV):
    """One phase-22 entry on the (2, 4) mesh: the kernel eager between CUDA
    events (for the ~0.1 ms collectives the wrapper's host work between
    launches counts too), its plain version (eager), its bound and one
    PyTorch call."""
    import torch

    ms = event_ms(lambda: fn(*args, mesh, axes), iters=10)
    plain_ms = event_ms(lambda: ref(*args, mesh, axes), iters=2)
    a = args[0]
    if key == "ag":
        n_bytes = a.numel() * a.element_size() * (1 + W)
        ops, rate = 0, BF16_FLOPS_S
        view = a.reshape(1, M, D)
        lib = event_ms(lambda: view.expand(W, M, D).contiguous(), iters=5)
        lib_call = "expand(...).contiguous() of the gathered view"
    elif key.startswith("rs_") and key != "rs_i8":
        n_bytes = a.numel() * a.element_size() * (W + 1) // W
        ops, rate = 0, BF16_FLOPS_S
        view = a.view(W, W, M // W, D)
        lib = event_ms(lambda: view.sum(dim=0), iters=5)
        lib_call = "sum over the rank dimension"
    elif key in ("gate_up", "qkv", "ag_i8"):
        b = args[1]
        n = b.shape[0] * b.shape[2]
        ops = 2 * M * D * n
        el = a.element_size()
        n_bytes = el * (M * D + D * n + W * M * D) + (
            4 if key == "ag_i8" else 2) * M * n
        if key == "ag_i8":
            rate = INT8_OPS_S
            a2 = a.reshape(M, D)
            b_cm = b.permute(1, 0, 2).reshape(D, n).t().contiguous().t()
            lib = time_ms(lambda: torch._int_mm(a2, b_cm), iters=5)
            lib_call = "torch._int_mm, B column-major"
        else:
            rate = BF16_FLOPS_S
            af = a.reshape(1, M, D).expand(W, -1, -1)
            lib = time_ms(lambda: torch.matmul(af, b), iters=5)
            lib_call = "batched torch.matmul of the gathered view"
    else:
        b = args[1]
        k = W * b.shape[1]
        ops = 2 * M * k * D
        el = a.element_size()
        n_bytes = el * (M * k + k * D) + (4 if key == "rs_i8" else 2) * M * D
        if key == "rs_i8":
            rate = INT8_OPS_S
            a2 = a.permute(1, 0, 2).reshape(M, k)
            b_cm = b.reshape(k, D).t().contiguous().t()
            lib = time_ms(lambda: torch._int_mm(a2, b_cm), iters=5)
            lib_call = ("torch._int_mm of the rows against B column-major: "
                        "the sum over ranks is the contraction")
        else:
            rate = BF16_FLOPS_S
            a4 = a.view(W, W, M // W, b.shape[1])
            lib = time_ms(lambda: torch.einsum("qrmk,qkn->rmn", a4, b),
                          iters=5)
            lib_call = "torch.einsum"
    b_ms, b_by = bound_ms(n_bytes, ops, rate)
    log(f"torus {key} (2x4, Llama-3-8B TP-8): kernel {ms:.4f} ms"
        + (f" ({ops / ms / 1e9:.1f} T{'OP' if rate == INT8_OPS_S else 'FLOP'}"
           f"/s)" if ops else f" ({n_bytes / ms / 1e9:.2f} TB/s)")
        + f", plain {plain_ms:.4f} ms, library {lib:.4f} ms ({lib_call}), "
        f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 2 ** 20:.1f} MiB, "
        f"{ops / 1e9:.1f} G ops)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, max_abs_err=err)


# The wgmma kernels (csrc/sm90.cuh, csrc/sm90_gemm.cuh): each must hold
# GMMA instructions in its SASS (HGMMA in a bf16 instance, IGMMA in an
# int8 one), spill nothing, and draw no ptxas serialisation warning.
WGMMA_KERNELS = {"ring_attn": ("ring_attn_kernel",),
                 "flash_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
                 "flash_fwd": ("flash_fwd_wg_kernel",),
                 "ag_gemm": ("ag_gemm_wg_kernel", "ag_gemm_bidir_wg_kernel"),
                 "gemm_rs": ("gemm_rs_wg_kernel",
                             "gemm_rs_bidir_i8_wg_kernel"),
                 "moe_rs": ("moe_rs_wg_kernel",),
                 "ag_group_gemm": ("ag_group_gemm_wg_kernel",),
                 "group_gemm": ("group_gemm_wg_kernel",),
                 "matmul_i8": ("matmul_i8_wg_kernel",),
                 "gemm": ("matmul_wg_kernel",)}
# The mma.sync kernels whose SASS must hold HMMA instructions (the decode
# kernel: a stream, where wgmma's 64-row tiles would sit mostly idle).
HMMA_KERNELS = {"decode": ("decode_kernel",)}
# instance labels by template arguments (<SEGM, I8> of the flash forward,
# <SEGM> of the other attention kernels,
# <I8, B_NK, FLAT, TALL> of ag_gemm_wg_kernel (first: its WgParams<I8,
# B_NK> argument also reads as a two-flag key), <I8, B_NK, TALL> of
# group_gemm_wg_kernel, <I8, B_NK, MODE, TALL> of gemm_rs_wg_kernel,
# <TALL> of gemm_rs_bidir_i8_wg_kernel, <OutT> of matmul_wg_kernel); the
# int8 kernels' names (IGMMA expected)
SASS_MODES = (("matmul_wg_kernelIfEE", "f32 out"),
              ("matmul_wg_kernelI13__nv_bfloat16EE", "bf16 out"),
              ("ILb0ELb0ELb1ELb0EE", "bf16, B [K][n], flat world"),
              ("ILb0ELb1ELb1ELb0EE", "bf16, B^T [n][K], flat world"),
              ("ILb1ELb0ELb1ELb0EE", "int8, flat world"),
              ("ILb0ELb0ELb0ELb0EE", "bf16, B [K][n], torus group"),
              ("ILb0ELb1ELb0ELb0EE", "bf16, B^T [n][K], torus group"),
              ("ILb1ELb0ELb0ELb1EE", "int8, torus group, 256 x 128"),
              ("ILb1ELb0ELb0ELb0EE", "int8, torus group, 128 x 256"),
              ("fwd_wg_kernelILb0ELb0EE", "bf16 K/V, contiguous"),
              ("fwd_wg_kernelILb1ELb0EE", "bf16 K/V, segmented"),
              ("fwd_wg_kernelILb0ELb1EE", "K/V int8 -> bf16, contiguous"),
              ("fwd_wg_kernelILb1ELb1EE", "K/V int8 -> bf16, segmented"),
              ("ILb0ELb0ELi0ELb0EE", "bf16, B [K][n]"),
              ("ILb0ELb1ELi0ELb0EE", "bf16, B^T [n][K]"),
              ("ILb0ELb0ELi1ELb0EE", "bf16, B [K][n], group"),
              ("ILb0ELb1ELi1ELb0EE", "bf16, B^T [n][K], group"),
              ("ILb0ELb0ELi2ELb0EE", "bf16, B [K][n], torus order"),
              ("ILb0ELb1ELi2ELb0EE", "bf16, B^T [n][K], torus order"),
              ("ILb1ELb0ELi0ELb1EE", "int8, 256 x 128"),
              ("ILb1ELb0ELi0ELb0EE", "int8, 128 x 256"),
              ("ILb1ELb0ELi1ELb1EE", "int8, group, 256 x 128"),
              ("ILb1ELb0ELi1ELb0EE", "int8, group, 128 x 256"),
              ("bidir_i8_wg_kernelILb1EE", "int8 bidir, 256 x 128"),
              ("bidir_i8_wg_kernelILb0EE", "int8 bidir, 128 x 256"),
              ("ILb1ELb0ELb1EE", "int8, 256 x 128"),
              ("ILb1ELb0ELb0EE", "int8"),
              ("ILb0ELb0ELb0EE", "bf16, B [K][n]"),
              ("ILb0ELb1ELb0EE", "bf16, B^T [n][K]"),
              ("ILb1ELb0EE", "int8"), ("ILb0ELb0EE", "bf16, B [K][n]"),
              ("ILb0ELb1EE", "bf16, B^T [n][K]"), ("ILb1EE", "segmented"),
              ("ILb0EE", "contiguous"))
INT8_WGMMA = ("matmul_i8_wg_kernel",)
# ptxas's notes that it serialised a kernel's wgmma instructions
SERIALISED = ("C7512", "C7520")


def sass_check(_build):
    """Count the MMA instructions of each wgmma kernel (and of the
    mma.sync decode kernel) in ``cuobjdump --dump-sass`` of its built
    library, HGMMA, IGMMA and HMMA apart, beside its ptxas registers and
    spill bytes; a bf16 wgmma instance without HGMMA, an int8 one without
    IGMMA, a decode instance without HMMA, a spill or a ptxas
    serialisation warning
    (C7512 / C7520) in a library of these kernels fails the run.  Where
    the toolkit has no cuobjdump, the line says so."""
    tool = os.path.join(os.path.dirname(os.path.dirname(
        _build.nvcc_path())), "bin", "cuobjdump")
    report = _build.ptxas_report()
    checked = {**WGMMA_KERNELS, **HMMA_KERNELS}
    paths = _build.build(tuple(checked))
    for lib, kernels in checked.items():
        spill, regs, fn = {}, {}, None
        for line in report.get(lib, "").splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                spill[fn] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                regs[fn] = int(m.group(1))
            if any(code in line for code in SERIALISED):
                raise AssertionError(f"ptxas serialised wgmma in {lib}: "
                                     f"{line.strip()}")
        if not os.path.exists(tool):
            log(f"sass {lib}: no cuobjdump at {tool}: MMA not counted")
            continue
        sass = subprocess.run([tool, "--dump-sass", str(paths[lib])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = {"HGMMA": 0, "IGMMA": 0, "HMMA": 0}
            elif fn:
                m = re.search(r"\b(HGMMA|IGMMA|HMMA)\.", line)
                if m:
                    counts[fn][m.group(1)] += 1
        for kern in kernels:
            found = {f: c for f, c in counts.items() if kern in f}
            for f, c in sorted(found.items()):
                if lib in HMMA_KERNELS:
                    kw, ncw, i8 = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)EE",
                                            f).groups()
                    mode = (f"{kw}-key slices, {ncw} consumer warps, "
                            f"{'int8' if i8 == '1' else 'bf16'}")
                    want = "HMMA"
                else:
                    mode = next((m for key, m in SASS_MODES if key in f),
                                "one instance")
                    want = "IGMMA" if (mode.startswith("int8")
                                       or kern in INT8_WGMMA) \
                        else "HGMMA"
                log(f"sass {lib} {kern} ({mode}): {c['HGMMA']} HGMMA, "
                    f"{c['IGMMA']} IGMMA, {c['HMMA']} HMMA, ptxas registers "
                    f"{regs.get(f, 'not reported (prebuilt)')}, spill bytes "
                    f"{spill.get(f, 'not reported (prebuilt)')}")
                if c[want] == 0:
                    raise AssertionError(f"{kern} ({mode}): no {want} in "
                                         f"its SASS ({c})")
            if not found:
                raise AssertionError(f"{kern}: not in the SASS of {lib}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from triton_dist_tpu_torch.kernels import _build
        from triton_dist_tpu_torch.kernels import flash_attention as fa
        from triton_dist_tpu_torch.kernels import flash_decode as fd
        from triton_dist_tpu_torch.kernels import quant
        from triton_dist_tpu_torch.models.llama import (
            LlamaConfig,
            init_params,
        )
        from triton_dist_tpu_torch.runtime.utils import (
            use_full_precision_matmul,
        )
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    use_full_precision_matmul()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # phase 2: build
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    spills = []
    for name, text in _build.ptxas_report().items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"ptxas {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    sass_check(_build)

    # phase 3: kernels
    rows = kernel_phase(dev)
    log(f"kernels done at {time.perf_counter() - t_start:.1f} s")

    # phases 4-5: the main path, with the launch counters zeroed first
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"llama3_8b: {cfg.n_layers} layers, dim {cfg.dim}, random weights "
        f"(seed 0) in {time.perf_counter() - t0:.1f} s")
    counters = {"flash_fwd": fa.flash_attention,
                "decode": fd.gqa_decode_shard,
                "decode_paged": fd.gqa_decode_paged_shard}
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        gen = generator_phase(cfg, params)
        after_gen = {n: fn.launches for n, fn in counters.items()}
        eng, reqs, outs, prompts, line5 = engine_phase(cfg, params, gen,
                                                       sampled=True)
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"launches: generator {after_gen}, generator+engine {launches}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} never launched on the main "
                                 f"path")
    with torch.no_grad():
        noise_floor(params, cfg)
    check_agreement("engine", [
        teacher_forced_agreement(params, cfg, p,
                                 outs[r.request_id].token_ids)
        for r, p in zip(reqs, prompts)], STRICT_MIN)
    float_streams = {r.request_id: list(outs[r.request_id].token_ids)
                     for r in reqs}
    sampled5 = list(outs[SAMPLED_REQ].token_ids)
    with torch.no_grad():
        prof5 = decode_profile(eng, prompts, "engine", 16)
    del eng, outs
    free_cuda()

    # phase 5h: the decode horizon (H 8, pipeline 2) after warmup, rows 1
    # and 3 counted from zero (replays of captured graphs included)
    serve_launches = {}
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        eng, reqs, outs, prompts, line5h = engine_phase(
            cfg, params, gen, tag="horizon engine", sampled=True, horizon=8,
            pipeline=2, warmup=True)
    serve_launches["horizon"] = {n: fn.launches
                                 for n, fn in counters.items()}
    log(f"launches: horizon engine {serve_launches['horizon']}")
    check_agreement("horizon engine", [
        teacher_forced_agreement(params, cfg, p,
                                 outs[r.request_id].token_ids)
        for r, p in zip(reqs, prompts)], STRICT_MIN)
    match = []
    for rid, fl in float_streams.items():
        h_toks, n = outs[rid].token_ids, 0
        while n < min(len(fl), len(h_toks)) and fl[n] == h_toks[n]:
            n += 1
        match.append(n / len(fl))
    log(f"horizon engine vs engine (H 1): mean greedy prefix match "
        f"{np.mean(match):.4f} (per request {[round(x, 3) for x in match]});"
        f" sampled request (temperature 0.8, seed 2**40) "
        f"{'equal' if outs[SAMPLED_REQ].token_ids == sampled5 else 'DIFFERS'}"
        f" over {len(sampled5)} tokens")
    if outs[SAMPLED_REQ].token_ids != sampled5:
        raise AssertionError(f"horizon engine: the sampled request drew "
                             f"{outs[SAMPLED_REQ].token_ids}, the H 1 "
                             f"engine {sampled5}")
    if not line5h["warmup"]["graphs"] or line5h["new_misses"]:
        raise AssertionError(f"horizon engine: warmup captured "
                             f"{line5h['warmup']['graphs']} graphs, "
                             f"serving added {line5h['new_misses']} "
                             f"program signatures")
    for n in ("flash_fwd", "decode_paged"):
        if serve_launches["horizon"][n] <= 0:
            raise AssertionError(f"kernel {n} never launched by the horizon "
                                 f"engine")
    with torch.no_grad():
        prof5h = decode_profile(eng, prompts, "horizon engine", 2)
        decode_profile(eng, prompts, "horizon engine, one row sampled", 2,
                       sampled=True)
    log(f"serving H 1 vs H 8 ({smi}): tok/s {line5['tok_s']:.1f} vs "
        f"{line5h['tok_s']:.1f}, ttft {line5['ttft_ms']:.1f} vs "
        f"{line5h['ttft_ms']:.1f} ms, itl {line5['itl_ms']:.2f} vs "
        f"{line5h['itl_ms']:.2f} ms, dispatches a token "
        f"{line5['dispatches_per_token']:.4f} vs "
        f"{line5h['dispatches_per_token']:.4f}; decode step wall "
        f"{prof5['wall_ms']:.3f} vs {prof5h['wall_ms']:.3f} ms, device busy "
        f"{prof5['busy_ms']:.3f} vs {prof5h['busy_ms']:.3f} ms, idle share "
        f"{prof5['idle_share']:.3f} vs {prof5h['idle_share']:.3f}")
    del eng, outs
    free_cuda()

    # phase 5p: the prefix cache, rows 1 and 3 counted from zero
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        outs, prompts, line5p = prefix_phase(cfg, params, gen)
    serve_launches["prefix"] = {n: fn.launches for n, fn in counters.items()}
    log(f"launches: prefix engine {serve_launches['prefix']}")
    check_agreement("prefix engine", [
        teacher_forced_agreement(params, cfg, prompts[i],
                                 outs[f"p{i}"].token_ids)
        for i in range(8)], STRICT_MIN)
    log(f"prefix engine ({smi}): ttft warm {line5p['ttft_warm_ms']:.1f} ms "
        f"vs cold {line5p['ttft_cold_ms']:.1f} ms")
    del outs
    free_cuda()

    # phase 5s: speculative serving, rows 1-3 counted from zero for each
    # run; phase 5beam: beam search over shared pages
    spec_launches, spec_lines = spec_phase(cfg, params, gen, counters,
                                           float_streams, sampled5)
    for tag, c in spec_launches.items():
        serve_launches[f"spec_{tag}"] = c
    log(f"serving no draft vs spec ({smi}): tok/s {line5['tok_s']:.1f} vs "
        + ", ".join(f"{t} {x['tok_s']:.1f}" for t, x in spec_lines.items())
        + f"; itl {line5['itl_ms']:.2f} vs "
        + ", ".join(f"{t} {x['itl_ms']:.2f}" for t, x in spec_lines.items())
        + f" ms; ttft {line5['ttft_ms']:.1f} vs "
        + ", ".join(f"{t} {x['ttft_ms']:.1f}" for t, x in spec_lines.items())
        + " ms")
    with torch.no_grad():
        beam_phase(cfg, params, gen)
    del gen
    free_cuda()

    log(f"serving done at {time.perf_counter() - t_start:.1f} s")

    # phases 5b-5c: the quantized path, every counter zeroed first
    q_counters = {"flash_fwd_i8": fa.flash_fwd_i8,
                  "decode_i8": fd.decode_i8,
                  "decode_paged_i8": fd.decode_paged_i8,
                  "matmul_i8": quant.matmul_i8}
    for fn in list(counters.values()) + list(q_counters.values()):
        fn.launches = 0
    quant.matmul_i8.mode_launches.update(wg=0, split_k=0)
    with torch.no_grad():
        gen_q = quant_generator_phase(cfg, params)
        after_gen = {n: fn.launches for n, fn in q_counters.items()}
        eng_q, reqs, outs, prompts, _ = engine_phase(
            cfg, params, gen_q, w8a8=True, tag="quantized engine")
    q_launches = {n: fn.launches for n, fn in q_counters.items()}
    i8_modes = {"serving": dict(quant.matmul_i8.mode_launches)}
    log(f"launches: quantized generator {after_gen}, quantized generator+"
        f"engine {q_launches} (float kernels "
        f"{ {n: fn.launches for n, fn in counters.items()} })")
    for n in ("flash_fwd_i8", "decode_i8"):
        if after_gen[n] <= 0:
            raise AssertionError(f"kernel {n} never launched by the "
                                 f"quantized generator")
    for n in ("flash_fwd_i8", "decode_paged_i8", "matmul_i8"):
        if q_launches[n] - after_gen[n] <= 0:
            raise AssertionError(f"kernel {n} never launched by the "
                                 f"quantized engine")
    kv = eng_q.metrics.summary()["kv"]
    log(f"quantized engine kv_stats: {kv}")
    if kv["bytes_per_token"] != KV_BYTES_PER_TOKEN_I8 or not kv["quantized"]:
        raise AssertionError(f"int8 pools: {kv['bytes_per_token']} bytes "
                             f"per token, expected {KV_BYTES_PER_TOKEN_I8}")
    plain = quant_plain_logits(eng_q.params, cfg, w8a8=True)
    with torch.no_grad():
        quant_noise_floor(eng_q.params, cfg, plain)
    check_agreement("quantized engine", [
        teacher_forced_agreement(eng_q.params, cfg, p,
                                 outs[r.request_id].token_ids,
                                 logits_fn=plain, near_tie=QUANT_NEAR_TIE)
        for r, p in zip(reqs, prompts)], QUANT_STRICT_MIN, QUANT_NEAR_TIE)
    match = []
    for rid, fl in float_streams.items():
        q_toks, n = outs[rid].token_ids, 0
        while n < min(len(fl), len(q_toks)) and fl[n] == q_toks[n]:
            n += 1
        match.append(n / len(fl))
    log(f"quantized engine vs float engine: mean greedy prefix match "
        f"{np.mean(match):.4f} (per request "
        f"{[round(x, 3) for x in match]}; no gate: int8 error is real)")
    launches.update(q_launches)
    log(f"matmul_i8 launches by kernel, quantized serving: "
        f"{i8_modes['serving']}")
    del gen_q, eng_q, outs, plain   # plain holds the W8A8 tree
    free_cuda()

    log(f"quantized serving done at {time.perf_counter() - t_start:.1f} s")

    # phases 13-14: sequence-parallel serving on phase 4's weights, every
    # counter zeroed first; the combine's count comes from them, the
    # other serving kernels' SP counts ride along
    sp_launches, _ = sp_phases(cfg, params)
    launches["sp_combine"] = sp_launches["sp_combine"]
    free_cuda()
    log(f"sp serving done at {time.perf_counter() - t_start:.1f} s")

    # phases 15-16: W8A8 tensor parallelism and head-sharded serving on
    # phase 4's weights; the int8 AG-GEMM's count comes from phase 15's
    # forward, the heads engines' serving counts ride beside
    w8_launches, w8_stats = w8a8_tp_phase(cfg, params)
    launches["ag_gemm_i8"] = w8_launches["ag_gemm_i8"]
    i8_modes["w8a8_tp_forward"] = w8_stats["matmul_i8_mode_launches"]
    heads_launches = heads_phase(cfg, params)
    free_cuda()
    log(f"w8a8 tp and heads serving done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # phase 17: the context-parallel forward on phase 4's weights; the
    # segmented flash forward's count comes from its zigzag flash ring,
    # ring_attn's from its fused forward
    cp_fwd = cp_forward_phase(cfg, params)
    launches.update(flash_fwd_seg=cp_fwd["auto"]["flash_fwd_seg"],
                    ring_attn=cp_fwd["fused"]["ring_attn"])
    del params
    free_cuda()
    log(f"cp forward done at {time.perf_counter() - t_start:.1f} s")

    # phase 6: training; the backward kernels' counts come from it (the
    # flash_fwd row keeps the serving path's count, printed beside)
    trained = train_phase()
    launches.update(flash_bwd_dq=trained["flash_bwd_dq"],
                    flash_bwd_dkv=trained["flash_bwd_dkv"])

    log(f"training done at {time.perf_counter() - t_start:.1f} s")

    # phase 18: context-parallel training on its own tree; the segmented
    # backward kernels' counts come from its SGD steps
    cp_train = cp_train_phase()
    launches.update(flash_bwd_dq_seg=cp_train["sgd"]["flash_bwd_dq_seg"],
                    flash_bwd_dkv_seg=cp_train["sgd"]["flash_bwd_dkv_seg"])
    log(f"cp training done at {time.perf_counter() - t_start:.1f} s")

    # phases 7-10b: the MoE family; each grouped-GEMM mode's count comes
    # from the phase that drives it, the EP-4 counts ride along
    moe_launches, ep_fwd, ep_train = moe_phases()
    launches.update(moe_launches)
    log(f"moe done at {time.perf_counter() - t_start:.1f} s")

    # phases 11-12: tensor parallelism; the ring kernels' counts come from
    # the SGD steps (the forward's ride along), the dense GEMM's 0 too
    tp_fwd, tp_train = tp_phases()
    launches.update(tp_train)
    log(f"tp done at {time.perf_counter() - t_start:.1f} s")

    # phase 19: pipeline-parallel training with the hierarchical gradient
    # all-reduce; the collectives' counts come from its SGD steps (the
    # barrier's 0 too: no model path calls it), the ring and flash
    # kernels' ride beside under "pp_launches"
    pp_launches = pp_train_phase()
    for n in ("barrier", "allgather_ring", "allgather_bidir",
              "allgather_full_mesh", "reduce_scatter_ring",
              "reduce_scatter_bidir"):
        launches[n] = pp_launches[n]
    log(f"pp done at {time.perf_counter() - t_start:.1f} s")

    # phase 20: the ring GEMMs' host entries and ring modes; each mode's
    # count comes from it (0 on every model path, beside)
    mode_rows, mode_launches = ring_modes_phase(dev)
    rows.update(mode_rows)
    launches.update(mode_launches)
    log(f"ring modes done at {time.perf_counter() - t_start:.1f} s")

    # phase 21: the MoE overlap kernels' host entries; each kernel's count
    # comes from it (0 on every model path, beside)
    moe_tp_rows, moe_tp_launches = moe_tp_phase(dev)
    rows.update(moe_tp_rows)
    launches.update(moe_tp_launches)
    free_cuda()
    log(f"moe tp done at {time.perf_counter() - t_start:.1f} s")

    # phase 22: the torus (multi-axis) collectives and ring GEMMs; each
    # kernel's count comes from it (0 before it, and on every model path)
    torus_rows, torus_launches = torus_phase(dev)
    rows.update(torus_rows)
    launches.update(torus_launches)
    free_cuda()
    log(f"torus done at {time.perf_counter() - t_start:.1f} s")

    src = {"flash_fwd": ("triton_dist_tpu_torch/csrc/flash_fwd.cu",
                         "triton_dist_tpu/kernels/flash_attention.py:116"),
           "decode": ("triton_dist_tpu_torch/csrc/decode.cu",
                      "triton_dist_tpu/kernels/flash_decode.py:164"),
           "decode_paged": ("triton_dist_tpu_torch/csrc/decode.cu",
                            "triton_dist_tpu/kernels/flash_decode.py:766"),
           "flash_bwd_dq": ("triton_dist_tpu_torch/csrc/flash_bwd.cu",
                            "triton_dist_tpu/kernels/flash_attention.py:347"),
           "flash_bwd_dkv": ("triton_dist_tpu_torch/csrc/flash_bwd.cu",
                             "triton_dist_tpu/kernels/flash_attention.py:388"),
           "decode_i8": ("triton_dist_tpu_torch/csrc/decode.cu",
                         "triton_dist_tpu/kernels/flash_decode.py:246"),
           # the reference has no Pallas kernel for int8 pages (XLA math)
           "decode_paged_i8": ("triton_dist_tpu_torch/csrc/decode.cu",
                               "triton_dist_tpu/kernels/flash_decode.py:692"),
           "flash_fwd_i8": ("triton_dist_tpu_torch/csrc/flash_fwd.cu",
                            "triton_dist_tpu/kernels/flash_attention.py:209"),
           "matmul_i8": ("triton_dist_tpu_torch/csrc/matmul_i8.cu",
                         "triton_dist_tpu/kernels/quant.py:52"),
           "group_gemm": ("triton_dist_tpu_torch/csrc/group_gemm.cu",
                          "triton_dist_tpu/kernels/group_gemm.py:204"),
           "group_gemm_dx": ("triton_dist_tpu_torch/csrc/group_gemm.cu",
                             "triton_dist_tpu/kernels/group_gemm.py:204"),
           "group_gemm_i8": ("triton_dist_tpu_torch/csrc/group_gemm.cu",
                             "triton_dist_tpu/kernels/group_gemm.py:204"),
           "all_to_all": ("triton_dist_tpu_torch/csrc/all_to_all.cu",
                          "triton_dist_tpu/kernels/all_to_all.py:108"),
           "matmul": ("triton_dist_tpu_torch/csrc/gemm.cu",
                      "triton_dist_tpu/kernels/gemm.py:192"),
           "ag_gemm": ("triton_dist_tpu_torch/csrc/ag_gemm.cu",
                       "triton_dist_tpu/kernels/allgather_gemm.py:240"),
           "gemm_rs": ("triton_dist_tpu_torch/csrc/gemm_rs.cu",
                       "triton_dist_tpu/kernels/gemm_reduce_scatter.py:103"),
           "ag_gemm_i8": ("triton_dist_tpu_torch/csrc/ag_gemm.cu",
                          "triton_dist_tpu/kernels/allgather_gemm.py:240"),
           "sp_combine": ("triton_dist_tpu_torch/csrc/sp_combine.cu",
                          "triton_dist_tpu/kernels/flash_decode.py:851"),
           # the segmented (zigzag) mode of rows 1 and 6
           "flash_fwd_seg": ("triton_dist_tpu_torch/csrc/flash_fwd.cu",
                             "triton_dist_tpu/kernels/flash_attention.py:116"),
           "flash_bwd_dq_seg": (
               "triton_dist_tpu_torch/csrc/flash_bwd.cu",
               "triton_dist_tpu/kernels/flash_attention.py:347"),
           "flash_bwd_dkv_seg": (
               "triton_dist_tpu_torch/csrc/flash_bwd.cu",
               "triton_dist_tpu/kernels/flash_attention.py:388"),
           "ring_attn": ("triton_dist_tpu_torch/csrc/ring_attn.cu",
                         "triton_dist_tpu/kernels/ring_attention.py:409"),
           "barrier": ("triton_dist_tpu_torch/csrc/barrier.cu",
                       "triton_dist_tpu/kernels/common_ops.py:34"),
           "allgather_ring": ("triton_dist_tpu_torch/csrc/allgather.cu",
                              "triton_dist_tpu/kernels/allgather.py:109"),
           "allgather_bidir": ("triton_dist_tpu_torch/csrc/allgather.cu",
                               "triton_dist_tpu/kernels/allgather.py:146"),
           "allgather_full_mesh": (
               "triton_dist_tpu_torch/csrc/allgather.cu",
               "triton_dist_tpu/kernels/allgather.py:185"),
           "reduce_scatter_ring": (
               "triton_dist_tpu_torch/csrc/reduce_scatter.cu",
               "triton_dist_tpu/kernels/reduce_scatter.py:73"),
           "reduce_scatter_bidir": (
               "triton_dist_tpu_torch/csrc/reduce_scatter.cu",
               "triton_dist_tpu/kernels/reduce_scatter.py:134"),
           "ag_gemm_bidir": ("triton_dist_tpu_torch/csrc/ag_gemm.cu",
                             "triton_dist_tpu/kernels/allgather_gemm.py:108"),
           # the int8-wire mode and the chunked forward of row 13
           "ag_gemm_wire": ("triton_dist_tpu_torch/csrc/ag_gemm.cu",
                            "triton_dist_tpu/kernels/allgather_gemm.py:240"),
           "ag_gemm_chunked": (
               "triton_dist_tpu_torch/csrc/ag_gemm.cu",
               "triton_dist_tpu/kernels/allgather_gemm.py:240"),
           "gemm_rs_bidir": (
               "triton_dist_tpu_torch/csrc/gemm_rs.cu",
               "triton_dist_tpu/kernels/gemm_reduce_scatter.py:205"),
           # the int8 (quantized) mode of row 15
           "gemm_rs_i8": (
               "triton_dist_tpu_torch/csrc/gemm_rs.cu",
               "triton_dist_tpu/kernels/gemm_reduce_scatter.py:103"),
           # the int8 mode of the bidir ring (row 15bi)
           "gemm_rs_i8_bidir": (
               "triton_dist_tpu_torch/csrc/gemm_rs.cu",
               "triton_dist_tpu/kernels/gemm_reduce_scatter.py:205"),
           "ag_group_gemm": (
               "triton_dist_tpu_torch/csrc/ag_group_gemm.cu",
               "triton_dist_tpu/kernels/allgather_group_gemm.py:103"),
           "moe_rs": ("triton_dist_tpu_torch/csrc/moe_rs.cu",
                      "triton_dist_tpu/kernels/moe_reduce_rs.py:106"),
           "torus_ag": ("triton_dist_tpu_torch/csrc/torus.cu",
                        "triton_dist_tpu/kernels/torus.py:104"),
           "torus_rs": ("triton_dist_tpu_torch/csrc/torus.cu",
                        "triton_dist_tpu/kernels/torus.py:311"),
           "torus_ag_gemm": ("triton_dist_tpu_torch/csrc/ag_gemm.cu",
                             "triton_dist_tpu/kernels/allgather_gemm.py:428"),
           # the torus kernels' int8 modes (int8 A, int32 C)
           "torus_ag_gemm_i8": (
               "triton_dist_tpu_torch/csrc/ag_gemm.cu",
               "triton_dist_tpu/kernels/allgather_gemm.py:428"),
           "torus_gemm_rs": (
               "triton_dist_tpu_torch/csrc/gemm_rs.cu",
               "triton_dist_tpu/kernels/gemm_reduce_scatter.py:326"),
           "torus_gemm_rs_i8": (
               "triton_dist_tpu_torch/csrc/gemm_rs.cu",
               "triton_dist_tpu/kernels/gemm_reduce_scatter.py:326")}
    kernels = []
    for name, r in rows.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": src[name][0], "replaces": src[name][1],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **({"forward_launches": tp_fwd[name]}
                           if name in tp_fwd else {}),
                        **({"ep4_forward_launches": ep_fwd[name],
                            "ep4_train_launches": ep_train[name]}
                           if name == "all_to_all" else {}),
                        **({"sp_launches": sp_launches[name]}
                           if name in sp_launches and name != "sp_combine"
                           else {}),
                        **({"serve_launches": {t: c[name] for t, c in
                                               serve_launches.items()}}
                           if name in ("flash_fwd", "decode", "decode_paged")
                           else {}),
                        **({"heads_launches": {t: c[name] for t, c in
                                               heads_launches.items()}}
                           if name in ("flash_fwd", "decode_paged",
                                       "matmul_i8") else {}),
                        **({"w8a8_tp_launches": w8_launches[name]}
                           if name in ("matmul_i8", "flash_fwd") else {}),
                        **({"mode_launches": i8_modes}
                           if name == "matmul_i8" else {}),
                        **({"cp_launches": {
                            "forward": {t: c[name] for t, c in
                                        cp_fwd.items()},
                            "train": {t: c[name] for t, c in
                                      cp_train.items()}}}
                           if name in ("flash_fwd", "flash_fwd_seg",
                                       "flash_bwd_dq_seg",
                                       "flash_bwd_dkv_seg", "ring_attn",
                                       "all_to_all") else {}),
                        **({"pp_launches": pp_launches[name]}
                           if name in pp_launches else {}),
                        **({"model_path_launches": {
                            ph: c[name] for ph, c in
                            MODEL_PATH_COUNTS.items()}}
                           if name in RING_MODE_ROWS or name in MOE_TP_ROWS
                           or name in TORUS_ROWS else {}),
                        **{k: r[k] for k in ("m8", "t8", "tp_down", "bm512",
                                             "shapes", "algorithm_bound_ms",
                                             "device_ms",
                                             "library_null_reason")
                           if k in r}})
    for name, r in rows.items():
        for tag, x in (r.get("shapes") or {"": r}).items():
            if x.get("library_ms"):
                log(f"ratio {name}{' ' + tag if tag else ''}: kernel "
                    f"{x['ms']:.4f} ms / library {x['library_ms']:.4f} ms = "
                    f"{x['ms'] / x['library_ms']:.2f}x")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
