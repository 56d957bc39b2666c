"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

  1. device  — name, capability, ``nvidia-smi`` name and power limit;
  2. build   — compile every kernel of ``src/repro_torch/csrc`` (one nvcc
               per source, all started together); ptxas' registers and
               spills, each K4b kernel's registers and spills by name
               (bf16 / f16 / f32 at hd 32, 64, 80, 96, 128 and 256; the
               tensor-core kernels must spill nothing below hd 256), and
               each
               library's count of tensor-core (HMMA / HGMMA)
               instructions in its SASS (K1's, K3's, K4's and K4b's must
               be > 0);
  3. kernels — K1 (awq_matmul) at Qwen2.5-0.5B's four (K, N) pairs ×
               M ∈ {1, 4, 16, 64, 1024}, GS 64, unscaled with f32 output
               (the TPU function) and with an AWQ input scale and bf16
               output (the model's call), and its rows at M 1, 4, 7, 8,
               16, 64 and 200 bit-identical to the same rows of an M 1024
               launch; K3 (awq_gateup) at the
               gate/up pair 896→4864, GS 64, M ∈ {1, 4, 16, 64, 1024}, with
               and without AWQ input scales, in both output modes (f32, the
               TPU function; bf16, the model's rounding), and its rows at
               M 1, 4, 7, 8, 16, 64 and 200 bit-identical to the same rows
               of an M 1024 launch, and the count of its bf16 elements
               that differ from the unfused front (two K1 calls, silu,
               product); K2 (paged_attention_chunk) at
               Hkv 2, G 7, hd 64, page 16, B 4, C ∈ {1, 16}, contexts up to
               512 with padding rows, and C = 8 with a token tree's
               ancestor mask, logical positions and a sliding window; each
               held against its plain version, and timed beside it and a
               library yardstick;
               K4 (flash_attention) at Qwen2.5's 14 q / 2 kv heads, hd 64,
               bf16: the calibration forward (B 2, S 64), the launcher's
               prefill (B 4, S 256), the one-shot engine's longest
               prefill (B 1, S 200), a ragged S 1000, a 128-token window
               and a bidirectional case; then K1 - K4 at the other dense
               models' shapes (``dense_models`` on the same line): K1 at
               their 16 (K, N) pairs and K3 at smollm's and glm4's SiLU
               fronts (M 4 and 1024, the model's call), K2 at hd 256 with
               and without gemma3's 1,024-token window, G 8 over one kv
               head, G 16 at hd 128 and G 3 (C 1 and 16, contexts up to
               1,500), K4 at hd 256 (S 1,400 with and without the window,
               B 2 × S 1,100), gemma-2b's MQA, glm4's G 16 and smollm's
               G 3; K4b (flash_attention_bwd, the gradient of K4) at the
               train phase's shape (B 8, S 512, 14 / 2 heads, hd 64,
               bf16) and gemma3's windowed layers (hd 256, S 1,400,
               window 1,024), from K4's own output and lse, held against
               its plain version, two calls bit-equal, timed beside the
               plain version and SDPA's backward kernels (profiler), and
               at train_families' attention (hubert hd 80 bidirectional,
               phi-3-vision hd 96, hymba G 5 global and windowed,
               qwen2-moe hd 128 G 1), each with ptxas' spill bytes; K4b
               runs its five products on tensor cores in two launches
               (dQ with D, then dK / dV); the MoE family's shapes: K1 at
               qwen2-moe's and deepseek-v2-lite's linears outside the
               experts (deepseek's dense down K 10,944, kv_down N 576,
               kv_up K 512), K3 at their shared / dense fronts, K2 and K4
               at qwen2-moe's G 1, hd 128, and (``moe_experts``) K3 and K1
               over each model's 60 / 64 routed experts in one launch
               (the expert axis) at 4, 64 and 1,024 rows an expert, held
               against the plain versions, timed beside them and
               `torch.bmm` on the dequantized bf16 experts; the SSM
               family's shapes: K1 at mamba2-130m's and hymba-1.5b's ten
               (K, N) pairs (N 16 and 24 narrower than one 64-column
               block) at M 1, 4, 64 and 1,024, K3 at hymba's SiLU front,
               K2 and K4 at hymba's G 5 (25 q over 5 kv heads, hd 64)
               with and without its 1,024-token window; the encoder's
               and the VLM's: K1 at hubert-xlarge's four and
               phi-3-vision's two (K, N) at M 1, 4, 64 and 2,048, K3 at
               phi-3-vision's 3072 -> 8192, K2 at its 32 kv heads of 96
               (C 1 and 16, contexts up to 456), K4 at hubert's
               bidirectional forward (16 heads of 80, B 2 x S 1,024) and
               phi-3-vision's prefill with images (32 heads of 96, S
               456), each in bf16 and in f32; K2-TP
               (paged_attention_chunk_sharded: K2 once a shard of a 2-way
               mesh on one card) at K2's three Qwen cases, its shards
               joined bit-equal to one K2 launch over both heads, timed
               beside it, its plain version and SDPA;
  4. serve   — full-width Qwen2.5-0.5B (4 of its 24 layers, cut for the
               time limit, as are phases 5-18; random weights from a
               seed), RTN int4 GS 64, int8 KV pages, 8 greedy requests
               through `GenerationEngine.submit` / `step` / `drain`; the
               K1, K2 and K3 launch counters must grow during this run,
               and their launches per decode-only step and their
               launches in steps with prefill rows are reported;
  5. serve_oneshot — the same requests on the one-shot path
               (``chunked_prefill=False``, int8 pages): each admission a
               dense prefill (K4, K1, K3 at M = the prompt's length), a
               commit into the pages and the first token; then decode
               steps over all 4 slots (K2, K1, K3 at M = 4). All four
               counters must grow, K4 once per layer per request (32);
               8 admitted and finished, no page in use after `drain()`,
               ``prefill_tokens`` 0 (counted on the chunked path only);
               decode tokens/s, decode step ms, host ms per
               prefill-commit and the `stats()` byte fields are reported;
  6. oneshot_identity — the same requests one-shot over bf16 pages,
               each stream against `generate()` at B 1, under the default
               hybrid threshold and with every quantized linear on K1 /
               K3 (which separates the linears from the attention): the
               first tokens must be equal; identical streams are counted,
               and each other stream's first differing position and
               generate()'s logit margin there are reported;
  7. parallel — greedy ``submit(prompt, 32, n=4)`` on the chunked int8
               engine with the 200-token prompt, under the default
               hybrid threshold (the streams are compared and reported)
               and with every quantized linear on K1 / K3 (all four must
               be identical);
               the followers must alias 3 × 12 pages and skip 3 × 192
               prompt tokens, and no page may stay in use;
  8. preempt — SLO preemption on the serve engine (``preemption=True``,
               full pool): the four longest prompts (200, 190, 150, 120)
               at priority 0 with 64 new tokens, after 4 steps the four
               shortest (16, 33, 45, 77) at priority 1 with 16; the short
               ones spill long ones to pinned host memory (every parked
               strip is checked to lie there), which come back at their
               commit watermark. Gated: preemptions ≥ 1, restores equal
               to them, spilled pages equal to restored pages, nothing
               left spilled or in use, the spilled bytes equal to the
               spilled pages × 17,408 B (an int8 page of 16), K1, K2 and
               K3 launched, and, with every quantized linear on K1 / K3,
               all 8 streams equal to the same traffic on an engine that
               never preempts; under the default threshold the streams
               are compared and reported;
  9. optimistic — the same with ``admission="optimistic"`` on 48 pages,
               which the long requests' reserved worst case (59) does not
               fit: pressure relief must spill at least once;
 10. disagg  — a `DisaggController` (the serve shape on both sides, int8
               pools, ``handoff_min_tokens=64``) serving the 8 serve
               prompts, 32 new each: 5 hand off (48 pages, 5,013,504 wire
               bytes), 3 go direct, no page stays in use, K1/K2/K3 launch
               on both sides, and the streams equal a unified engine's
               with every quantized linear on K1 / K3; ``"auto"``'s split
               report is printed;
 11. spec_ngram — adaptive n-gram speculation (``spec_decode="ngram"``,
               ``spec_k=4``, ``spec_adaptive=True``) on the serve engine:
               8 greedy requests of 32 new tokens, each prompt a seeded
               24-token motif repeated to a serve length (16 … 200).
               Gated: drafts proposed and verified, every rollback one
               `KVPager.truncate`, K1 / K2 / K3 launched, and with every
               quantized linear on K1 / K3 all 8 streams equal to the
               same traffic on the engine without speculation; under the
               default threshold compared and reported. Acceptance,
               tokens per verify row, rollbacks, ``spec_k_now``, decode
               tokens/s and the host ms of a step with verify rows are
               reported;
 12. spec_tree — the same with token trees (``spec_tree=True``, fanout
               2, int8 pools): every tree verify step launches K2 with
               its ancestor mask and logical positions once a layer; then
               a drafter whose accepted node is always a depth-1
               alternate, so `_tree_compact` must move one KV position
               per accepted token. Gated as above, plus tree steps run;
 13. spec_draft — draft-model speculation with the served model as its
               own draft (``draft_model=model``): K4 must launch in the
               draft's dense prefills; streams gated equal under
               ``offload_min_flops=0``; the acceptance rate and the
               draft's host ms a step (``spec_k + 1`` dense decode steps)
               are reported;
 14. profile — decode steps of 4 slots (chunked, then one-shot over the
               same pages' layout), then chunk steps (4 rows of 16
               prompt tokens at contexts 64–448), then verify steps (4
               rows of 1 + 4 tokens whose drafts the plain engine's
               stream gives), timed bare and under torch.profiler:
               device busy time, idle share, top kernels, each port
               kernel's device time and launches a step, all device
               launches a step, and tokens emitted per verify row;
 15. check   — one unified `chunk_step` on the card (K1 + K2) against the
               same step on CPU copies (plain versions);
 15b. tp     — tensor-parallel serving on one card: the serve phase's 8
               requests through `GenerationEngine(mesh=...)` over a 2-way
               ``model`` mesh whose shards share cuda:0 (`serving_mesh(2,
               devices=[cuda:0, cuda:0])`; each shard its q / kv heads,
               its half of the int8 pools, K2-TP reading them), under the
               default threshold and with every quantized linear on K1 /
               K3. Gated: K2-TP launched, each shard's pool bytes half the
               unsharded engine's, first tokens equal to the serve phase's
               where generate()'s margin clears the `check` rule, no page
               in use; the `check` phase's two steps on the mesh within its
               rule against its CPU logits (K2-TP once a layer a step); a
               spill → restore round trip on the mesh bit-exact (the
               strips are the shards' pieces joined, in pinned memory); the
               `disagg` traffic with a mesh-2 prefill side and an
               unsharded decode side, whose wire bytes must equal the
               unsharded pair's. Streams equal to the unsharded engine's
               are counted, not gated (row-parallel sums change the bf16
               function, as in the reference). A decode step of 4 slots
               is profiled beside the `profile` phase's unsharded one;
 15c. sp_decode — SP-decode: the one-shot decode cache (B 8, 512
               prefilled tokens, 528 positions) striped along the
               sequence over a (1 × 2) mesh whose shards share cuda:0,
               then 4 greedy decode steps, each stripe's partials
               combined in f64 in shard order, against the unsharded
               one-shot decode by the `check` rule and within 1e-5 of
               the largest magnitude; step times and the collective
               counter's bytes;
 15d. tp_oneshot — the placed one-shot step: the same model, prompts
               and cache on the same (1 × 2) mesh with the parameters
               placed by `param_pspec` (`shard_params`) and the cache by
               `cache_pspec` (`place_cache`), prefill (K4 on each
               shard's 7 heads) and 4 decode steps fed the unsharded
               run's tokens, every quantized linear on K1 / K3 on the
               shards' stripes; against the unsharded run by the `check`
               rule and within 1.2e-2 of the largest magnitude; the
               fused-sample head's tokens; collective bytes of the
               prefill and a step, step times; then deepseek-v2-lite
               (2 / 27 layers), mamba2-130m (4 / 24) and hymba-1.5b
               (2 / 32) at full width, RTN, B 2 × 256, 8 steps each;
 16. launch  — the launcher's AWQ path at full width,
               `repro_torch.launch.serve.main` with ``--arch qwen25-05b
               --quant awq --batch 4 --prompt-len 256 --max-new 32``:
               calibration forward (K4 in every layer), AWQ search + pack
               of all 168 linears, `generate()` (K4 prefill, K1 decode);
               K4 must launch in both the calibration forward and
               `generate()`, K1 in `generate()`; all 168 linears are
               serialized into AWQ_MACRO bytes, which must total the
               report's packed size, and one of each (K, N) must parse
               back bit for bit;
 17. check_prefill — one `Model.prefill` (B 1, S 64) on the launcher's
               AWQ-packed weights (all 24 layers) on the card (K4 + K1 +
               K3) against the same prefill on CPU copies (plain
               versions);
 18. fleet   — the launcher's fleet path at full width and 4 of Qwen's
               24 layers (the serving phases' depth),
               `repro_torch.launch.serve.main` with ``--arch qwen25-05b
               --quant awq --replicas 2 --mesh-axis 1 --batch 4
               --prompt-len 256 --max-new 32``: AWQ calibrate + pack, two
               paged replicas behind the prefix-affinity Router, pinned
               cluster prefixes, 8 greedy requests; its placement
               integers (placements, affinity and session hits, prefill
               tokens skipped) must equal the reference launcher's for the
               same flags, and K1 and K3 must launch;
 19. fleet_disagg — the same with ``--disagg``: each replica a
               `DisaggController` (bf16 pools on both sides), which the
               Router scores by its sides' queues and the decode side's
               headroom; ``"auto"`` hands nothing off at this shape
               (crossover 32, ``disaggregate`` false), so every request is
               served direct by a decode engine. The same gates (no
               prefill tokens skipped: a pair reports none, as the
               reference's does), and its streams must equal the
               unified fleet's (same placements, same steps);
 20-29. gemma3-4b (d 2560, 8 q / 4 kv heads, hd 256, d_ff 10,240,
               V 262,144, a 1,024-token window; 6 of its 34 layers, one
               of them global), smollm-360m (2 of 32 layers), gemma-2b (2
               of 18), glm4-9b (2 of 40), then the MoE family:
               qwen2-moe-a2.7b (60 experts top-4 + 4 shared, 16 heads of
               128; 2 of 24 layers) and deepseek-v2-lite-16b (MLA + 64
               experts top-6 + 2 shared, its first layer dense; 2 of 27),
               then the SSM family:
               mamba2-130m (SSD layers, no attention, no MLP; 4 of its
               24) and hymba-1.5b (attention ∥ SSD, 25 q / 5 kv heads,
               2 of its 32 layers: global layer 0, one windowed), each
               at full width with
               its depth cut for the time limit (the phase line lists the
               layers), from random weights (seed 0): the launcher's AWQ
               path (``--arch
               <name> --quant awq``: calibration with K4, AWQ search and
               pack of every linear, `generate()` with K4 prefills, and on
               gemma3 and hymba their rings past the window: 2 × 1,100
               prompt tokens; the MoE models' routed experts at RTN, on
               K3 and K1's expert axis; mamba2's 4 × 512 tokens two SSD
               chunks); a serve burst (8 greedy requests of 12 new
               tokens, 32 before the tp_families phase came, over int8
               pages of 16, 4 slots, on the engine's
               default path: chunked, or one-shot for the models with
               per-slot state: deepseek's MLA latents, the SSM states,
               hymba's rings; gemma3's and hymba's prompts include 1,100
               and 1,400 tokens, so gemma3's windowed layers' K2 reads
               mask keys that slid out of the window and hymba's slots'
               rings wrap; mamba2's include 1,024) under the default
               threshold (this model's serving path: counts from 0) and
               with every quantized linear on K1 / K3, each stream against
               generate() at B 1 (first tokens gated equal by the
               `check` rule: where generate()'s top-2 margin clears 2 ×
               5 % of its logits' scale; streams and near ties reported
               with logit margins; mamba2's streams all gated equal);
               K1 launched, K2 where page pools are read (the chunked
               path, hymba's global layers), K4 in the one-shot path's
               prefills of attention layers (hymba), K3 on the SiLU GLU
               models only (gemma's GeGLU fronts are two K1 calls), the
               expert axis on the MoE models; and `check` (the one-shot
               models: a prefill and decode step) / `check_prefill` on a
               2-layer cut of the served model (gemma3: its first
               windowed and first global layer; hymba: its layer 0 and
               first windowed one; deepseek: its dense layer and a MoE
               one; qwen2-moe, all MoE: its first layer) against CPU
               copies, the CPU side taking the card's MoE routing
               (`RouteTie`: routing flips counted and reported);
               gemma3's line adds a profiled decode step of 4 slots at
               contexts ~1,100; smollm's, glm4's, qwen2-moe's and
               hymba's lines add `oneshot_bf16`: the serve prompts
               through the one-shot engine over bf16 pools with every
               quantized linear on K1 / K3, all 8 streams gated equal to
               generate()'s at B 1 (ROADMAP Queue 3). Then the encoder,
               hubert-xlarge at full size (48 layers, d 1,280, 16 heads
               of 80, bidirectional, plain GELU MLP of 5,120, a head over
               504 codewords): the launcher (calibration over stub frame
               features [2, 64, 512], AWQ and pack of 289 linears,
               ``frame_proj`` at RTN; an encoder ends there), its
               serving output on the pipeline's features of B 2 x S
               1,024 (`forward_logits` and a timed `Model.prefill`,
               bit-equal; K4 once a layer, every call bidirectional; K1
               on every quantized linear; frames/s and peak memory) and
               `check_prefill` of a 2-layer cut over 64 frames; and the
               VLM, phi-3-vision-4.2b at full width, 8 of its 32 layers
               (32 heads of 96, SiLU GLU of 8,192, V 32,064): the
               launcher (calibration over tokens [2, 64] and 256 stub
               patches a sequence; 56 quantized, ``patch_proj`` and the
               head float; text-only generate()), `generate()` with
               images (B 2, 256 patches + 200 tokens, K4 at S 456, 32
               new tokens from position 456), the chunked engine over
               the text as above, and `check` (a prefill with images and
               a decode step at position 272) and `check_prefill` with
               images on a 2-layer cut. After qwen2-moe's line, tp_moe:
               its AWQ params served tensor-parallel (the serve burst
               through the chunked engine on a 2-way ``model`` mesh, both
               shards on cuda:0; K3 / K1 on each shard's expert stripe:
               F 704 and D 1,024): every shard launches K3 and K1 over
               its experts wherever the unsharded engine launched them
               once, K2-TP launched, per-shard expert and pool bytes half
               the unsharded ones, first tokens equal to the unsharded
               engine's under the `check` rule (streams counted), the
               `check` steps sharded against the CPU (`RouteTie`; the
               first layer), and
               the packed `forward_logits` under a (data 2 × model 2)
               mesh against the unsharded forward;
 30. train   — Qwen2.5-0.5B training at full width and 8 of its 24
               layers (all 24 before the tp_families phase came: cut for
               the time limit, as is train_mesh) from seed 0: B 8 × S 512,
               bf16 gradient casts, AdamW (lr 3e-3, warmup 2, decay 200,
               no weight decay: the reference's descent test), per-block
               remat, 10 steps. Gated: every parameter receives a finite
               gradient at step 0, every loss finite, the last below the
               first by more than 0.3, K4 twice a layer a step (forward
               and recompute) and K4b once. Reported: losses, host ms a
               step, tokens/s, peak memory, one profiled step (busy ms,
               idle share, top kernels); then a 2-layer full-width cut's
               loss and gradients on the card against CPU copies (5 % of
               each leaf's largest magnitude);
 31. train_resume — `repro_torch.launch.train.main` at full width,
               4 of Qwen's 24 layers (cut from 24 to 12, then to 4, for
               the time limit;
               ``--steps 8 --batch 8 --seq 512 --ckpt-every 4
               --simulate-failure-at 6``, checkpoints under the
               git-ignored build/, deleted after): one recovery from step
               4's checkpoint, the redone steps' losses equal bit for
               bit, LATEST 8; then a synchronous save and a restore
               (timed) equal to the saved state bit for bit, and a step
               from each giving the same loss;
 32. train_families — every other family trained at full width from
               seed 0, float weights, bf16 casts, remat, AdamW lr 3e-3,
               4 steps of the pipeline's batches (hubert: 6 at 1e-4,
               its random codeword labels), each model's state
               freed before the next: qwen2-moe-a2.7b (2 of 24 layers,
               B 2 × S 1,024: 2,048 tokens, the capacity-factor region),
               deepseek-v2-lite-16b (2 of 27: its dense layer and a MoE
               one; MLA, no K4), mamba2-130m (24 of 24, B 8 × S 512; no
               attention), hymba-1.5b (4 of 32: global layer 0, three
               windowed; B 2 × S 1,536), hubert-xlarge (48 of 48, B 2 ×
               1,024 frames; K4 / K4b bidirectional at hd 80) and
               phi-3-vision-4.2b (8 of 32, B 2 × (256 patches + 256
               tokens); hd 96). Gated: finite losses, the last below the
               first, no leaf without a gradient, K4 twice and K4b once a
               step in each attention layer, and a 2-layer cut's loss and
               gradients on the card within 5 % of CPU copies (the MoE
               models' CPU side on the card's routing). Reported: step ms
               and tokens / frames a second beside the port cost model's
               compute and memory seconds for that step, peak memory;
 33. tp_families — the five families whose tensor parallelism is
               newest (deepseek-v2-lite-16b: MLA + MoE; mamba2-130m: SSD;
               hymba-1.5b: attention ∥ SSD; hubert-xlarge: the encoder;
               phi-3-vision-4.2b: patches before the text) on a (data 1 ×
               model 2) mesh, both shards on cuda:0, at train_families'
               depth, B × S, lr and seed: 2 steps each (losses within
               1e-3 relative of train_families' first two, K4 twice and
               K4b once a step in each attention layer on every shard
               whose heads split (hymba's 25 q heads stay on the first
               shard), every split leaf exactly half its bytes a shard,
               replicated leaves bit-equal to the first shard's), then
               the RTN int4 model's `forward_logits` over the mesh (B 2 ×
               S 64; phi-3-vision's 256 patches) against the unsharded
               packed forward by the `check` rule, under the default
               threshold and with every quantized linear on K1 / K3
               (then no generic call, every kernel call one K1 or K3
               launch on a shard's stripe); the stripes' K1 / K3 shapes
               are on the kernel_shapes line (``tp_stripes``: N 8, 12, 25,
               deepseek's flipped down, the GLU fronts' stripes);
 34. train_mesh — training over a (data 2 × model 2) mesh, four shards
               on cuda:0: train's model (8 of 24 layers) from its seed
               and settings, 4 steps (losses within 2e-2 of train's, K4
               twice and K4b once a layer a shard a step, replicas
               bit-equal after the last step, ZeRO-1 moments half a data
               replica), then a step bare and one profiled (busy, idle,
               launches); a save at (2 × 2) restored onto (1 × 2), whose
               next step's loss matches within 2e-2; the int8
               error-feedback arm (`make_dp_train_step`, data 2: losses
               falling, residuals within half their scale, int8 on the
               wire); qwen2-moe's float experts at 1 of 24 layers, B 2 ×
               S 512 a replica, 2 steps (step 0's loss within 2e-2 of
               the unsharded loss).
 35. glm4_smoke — glm4-9b's smoke config (head dim 32) through the
               launchers on the card: `launch.train --smoke` 8 steps (K4,
               K4b at hd 32; a finite, falling loss, no recovery),
               `launch.serve --smoke --quant awq` (K4 in calibration and
               generate()), the engine's greedy burst over int8 pages (K2
               at hd 32) and the `check` rule against the CPU (run after
               tp_moe); the hd-32 instances' kernel checks are on the
               `kernel_shapes` line (glm4 smoke's shapes and B 4 × S 512)
               and the `kernels` line's ``hd32`` fields;
 36. dryrun  — the dry run's bytes a device of Qwen2.5-0.5B's AWQ params
               on a (1 × 2) serving mesh against the allocator's growth
               when `shard_params` puts both shards on cuda:0 (within 512
               B an allocation), then one dry-run cell (Qwen's decode_32k
               on the 16 × 16 production mesh of ``meta`` devices) with no
               kernel launched.

Each phase prints one JSON line. The end-to-end numbers are repeated on
a short ``summary`` line, followed by the ``kernels`` line (what each
kernel's numbers cover, its tolerances and the per-shape results are on
the ``kernel_shapes`` line before them) and, last,
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero
before it. Without CUDA the script exits 1 at once. ``--out PATH`` also
writes every phase line to PATH as one JSON object. ``--profile-only``
builds and profiles Qwen2.5's steps, then a gemma3-4b decode step.
``--k4b-only`` builds, checks and times K4b (``check_k4b``) and profiles
train steps; ``--k4b-only CU`` does so with another K4b source of the same
entry point (a parent commit's, unpacked into a git-ignored directory),
so two versions are compared in one call, in turns.
``--tp-families-only`` builds, runs the stripes' kernel shapes, the five
families' `train_families` runs and `tp_families`; ``--tp-oneshot-only``
builds and runs `tp_oneshot`.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import qlinear  # noqa: E402
from repro_torch.core.packing import (PackedLinear, dequantize_int4,  # noqa: E402
                                      pack_linear, packed_linear_macro_bytes,
                                      parse_awq_macro_bytes, unpack_int4)
from repro_torch.core.pipeline import quantize_params  # noqa: E402
from repro_torch.core.quantize import QuantConfig, quantize_groupwise  # noqa: E402
from repro_torch.kernels import awq_matmul as k1  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import paged_attention as k2  # noqa: E402
from repro_torch.bridge import ef_to_arrays, state_to_arrays  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.data.pipeline import make_dataset  # noqa: E402
from repro_torch.distributed import (TrainSharding,  # noqa: E402
                                     replica_meshes, serving_mesh,
                                     shard_params)
from repro_torch.distributed.sharding import (Mesh, place_cache,  # noqa: E402
                                              shard_cache)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as dryrun_specs  # noqa: E402
from repro_torch.roofline.analysis import (collective_costs,  # noqa: E402
                                           count_collectives)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.roofline import costmodel  # noqa: E402
from repro_torch.serving.disagg import DisaggController  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step  # noqa: E402
from repro_torch.training.dp_compressed import (init_dp_state,  # noqa: E402
                                                make_dp_train_step)
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             loss_and_grads, missing_grads,
                                             train_state_shapes)
from repro_torch.utils.tree import flatten_with_paths, layer_parts  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_OPS_PER_S = 989e12        # dense bf16 tensor cores
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
COLD_BYTES = 64 << 20          # rotate copies past the 50 MB L2
TIME_ITERS = 40                # calls `time_ms` times by default
GS = 64
QWEN_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
# one decode layer's K1 calls at M = num_slots = 4: q, o, down (k and v,
# 2·4·896·128 < 2^20 flops, stay on the generic path; gate and up are K3)
LAYER_K1 = [(896, 896), (896, 896), (4864, 896)]
# a chunk step's layer at M = 64 (4 rows x 16 tokens): q, k, v, o, down
CHUNK_K1 = [(896, 896), (896, 128), (896, 128), (896, 896), (4864, 896)]


PHASES: dict[str, dict] = {}
T_START = time.perf_counter()
# each kernel wrapper's launch count (one per launch of its kernel)
COUNTERS = {"awq_matmul": k1.COUNTER, "paged_attention_chunk": k2.COUNTER,
            "awq_gateup": k1.GATEUP_COUNTER, "flash_attention": k4.COUNTER}
# K2-TP: calls that launched K2 once a shard (each shard's launch also
# counts under paged_attention_chunk)
TP_COUNTERS = {"paged_attention_chunk_sharded": k2.TP_COUNTER}
# K1's and K3's launches over a MoE layer's stacked experts (the expert
# axis; each is counted under its kernel's name too)
EXPERT_COUNTERS = {"awq_matmul_experts": k1.EXPERT_COUNTER,
                   "awq_gateup_experts": k1.GATEUP_EXPERT_COUNTER}
# K4b launches only on the train path
ALL_COUNTERS = {**COUNTERS, **EXPERT_COUNTERS, **TP_COUNTERS,
                "flash_attention_bwd": k4.BWD_COUNTER}


def reset_counts() -> None:
    for c in ALL_COUNTERS.values():
        c.count = 0


def read_counts(names=COUNTERS) -> dict:
    return {n: ALL_COUNTERS[n].count for n in names}


def phase(phase_name: str, **fields) -> None:
    """Print one phase line; ``at_s`` is the script's wall time so far."""
    fields = dict(fields, at_s=time.perf_counter() - T_START)
    PHASES[phase_name] = fields
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


def cold_copies(nbytes: int) -> int:
    """Copies of an input of ``nbytes`` whose rotation passes the L2
    (`COLD_BYTES`), at most `TIME_ITERS`: `time_ms` reads no more."""
    return max(1, min(TIME_ITERS, COLD_BYTES // nbytes))


def time_ms(fn, n_inputs: int, iters: int = TIME_ITERS) -> float:
    """Mean device ms per call of ``fn(i)``, cycling inputs i (cold L2).

    A launch from Python costs the host tens of µs, more than a small
    kernel runs, so timing launches as they are issued would measure the
    host. The stream is first held by a spin kernel long enough for the
    host to enqueue every call (sized from three calls after a warm-up
    call, so a first call's set-up does not stretch the hold); the events
    then see the calls run back to back."""
    fn(0)                   # first-call set-up (library handles, kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t0) / 3     # host + device, upper bound
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # cycles at the H100's top SM clock (1.98 GHz): a lower clock only
    # lengthens the hold
    torch.cuda._sleep(int(1.5 * iters * per_call_s * 2.0e9) + 1000)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_mma_count(lib: pathlib.Path) -> dict | None:
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in a built
    library's SASS, by ``cuobjdump --dump-sass``; None without it."""
    tool = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return {op: sass.count(f" {op}.") for op in ("HMMA", "HGMMA")}


def ptxas_by_kernel(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by kernel name, element type and head dim (``dq_mma_kernel<bf16,
    64>``): ptxas names the entry function, then its spills, then its
    registers."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?_Z\w*?\d((?:[a-z]+_)*kernel)I(\w+)", ln)
        if m:
            kind = ("bf16" if "bfloat16" in m.group(2) else "f16"
                    if "__half" in m.group(2) else "f32")
            hd = re.search(r"Li(\d+)E", m.group(2))
            name = f"{m.group(1)}<{kind}, {hd.group(1) if hd else '-'}>"
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def bound(nbytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The least time for moving ``nbytes`` and doing each ``(ops, peak
    rate)`` part of the work on the units its types allow, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops / peak for ops, peak in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ phase 3
def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v.float()), e - 8)


def _rel_err_vs_f64(outs, exact) -> list[float]:
    """max |output - exact| / max |exact| of each output."""
    return [float((o.double() - exact).abs().max() / exact.abs().max())
            for o in outs]


def check_k1(gen) -> tuple[dict, dict]:
    """K1 at Qwen2.5's four (K, N) pairs, GS 64: the TPU function
    (unscaled, f32 output) and the model's call (the linear's AWQ input
    scale, bf16 output), each held against the plain version and timed
    beside it and a library yardstick; then the summation rule (rows of an
    M 1024 launch equal the same rows at smaller M)."""
    cfg = QuantConfig(group_size=GS)
    # the launcher's prefill rows (M 1024) draw from their own generator,
    # and so do the model's input scales and the row-identity inputs, so
    # every other check keeps the inputs it had before they were added
    prefill_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model_gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes, identity = [], []
    for k, n in QWEN_KN:
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        p = pack_linear(*quantize_groupwise(w, cfg), None, None, cfg)
        wbytes = p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
        copies = cold_copies(wbytes)
        packs = [(p.qweight.clone(), p.scales.clone(), p.zeros.clone())
                 for _ in range(copies)]
        w_bf16 = dequantize_int4(p.qweight, p.scales, p.zeros, GS,
                                 torch.bfloat16)
        lib_w = [w_bf16.clone()
                 for _ in range(cold_copies(w_bf16.nbytes))]
        iscale = torch.rand(k, generator=model_gen, device="cuda") + 0.5
        model_kw = dict(input_scale=iscale, out_dtype=torch.bfloat16)
        for m in (1, 4, 16, 64, 1024):
            x = torch.randn(m, k, generator=gen if m < 1024 else prefill_gen,
                            device="cuda").to(torch.bfloat16)
            out = k1.awq_matmul(x, p.qweight, p.scales, p.zeros, GS)
            ref = k1.awq_matmul_ref(x, p.qweight, p.scales, p.zeros, GS,
                                    torch.bfloat16)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            if not err <= tol:
                raise AssertionError(f"K1 {k}x{n} M={m}: err {err} > {tol}")
            vs_f64 = _rel_err_vs_f64((out, ref), x.double() @ w_bf16.double())
            # the model's call: f32 tolerance plus one bf16 ulp of |plain|
            out_m = k1.awq_matmul(x, *packs[0], GS, **model_kw)
            ref_m = k1.awq_matmul_ref(x, *packs[0], GS, torch.bfloat16,
                                      **model_kw)
            torch.cuda.synchronize()
            err_m = (out_m.float() - ref_m.float()).abs()
            lim_m = 1e-4 * float(ref_m.float().abs().max()) + bf16_ulp(ref_m)
            if not bool((err_m <= lim_m).all()):
                raise AssertionError(
                    f"K1 {k}x{n} M={m} input scale, bf16 out: err exceeds "
                    f"its tolerance by {float((err_m - lim_m).max())}")
            ms = time_ms(lambda i: k1.awq_matmul(x, *packs[i], GS), copies)
            plain = time_ms(lambda i: k1.awq_matmul_ref(
                x, *packs[i], GS, torch.bfloat16), copies)
            lib = time_ms(lambda i: torch.matmul(x, lib_w[i]), len(lib_w))
            model_ms = time_ms(lambda i: k1.awq_matmul(
                x, *packs[i], GS, **model_kw), copies)
            model_plain = time_ms(lambda i: k1.awq_matmul_ref(
                x, *packs[i], GS, torch.bfloat16, **model_kw), copies)
            nbytes = x.nbytes + wbytes + m * n * 4
            b_ms, b_by = bound(nbytes, (2 * m * k * n, BF16_OPS_PER_S))
            mb_ms, mb_by = bound(nbytes + iscale.nbytes - m * n * 2,
                                 (2 * m * k * n, BF16_OPS_PER_S))
            shapes.append(dict(
                k=k, n=n, m=m, max_abs_err=err, tol=tol,
                f32_err_vs_f64=vs_f64, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by,
                span_block=k1.span_block(m, k, n),
                model=dict(max_abs_err=float(err_m.max()),
                           least_tol=float(lim_m.min()), ms=model_ms,
                           plain_ms=model_plain, bound_ms=mb_ms,
                           bound_by=mb_by)))
        # the summation rule: a row's bits do not depend on M
        x_full = torch.randn(1024, k, generator=model_gen,
                             device="cuda").to(torch.bfloat16)
        for scaled in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = dict(input_scale=iscale if scaled else None,
                          out_dtype=out_dtype)
                full = k1.awq_matmul(x_full, *packs[0], GS, **kw)
                for m in (1, 4, 7, 8, 16, 64, 200):
                    part = k1.awq_matmul(x_full[:m].contiguous(), *packs[0],
                                         GS, **kw)
                    differ = int((part != full[:m]).sum())
                    if differ:
                        raise AssertionError(
                            f"K1 {k}x{n} scaled={scaled} {out_dtype}: "
                            f"{differ} elements of rows 0..{m - 1} differ "
                            f"between M={m} and M=1024")
                    identity.append(m)

    def at(m, pairs):
        rows = [next(s for s in shapes if (s["k"], s["n"], s["m"]) == (k, n, m))
                for k, n in pairs]
        return {key: sum(r["model"][key] for r in rows)
                for key in ("ms", "plain_ms", "bound_ms")} | dict(
            library_ms=sum(r["library_ms"] for r in rows),
            tpu_function_ms=sum(r["ms"] for r in rows))

    layer, chunk = at(4, LAYER_K1), at(64, CHUNK_K1)
    entry = dict(
        name="awq_matmul", route="cuda",
        source="src/repro_torch/csrc/awq_matmul.cu",
        replaces="src/repro/kernels/awq_matmul.py:99",
        max_abs_err=max(max(s["max_abs_err"], s["model"]["max_abs_err"])
                        for s in shapes),
        ms=layer["ms"], plain_ms=layer["plain_ms"],
        bound_ms=layer["bound_ms"], bound_by="bytes",
        library_ms=layer["library_ms"],
        tpu_function_ms=layer["tpu_function_ms"], chunk_step_m64=chunk)
    detail = dict(
        at="one decode layer at M=4: q, o, down with input scales and bf16 "
           "output, the model's call (sums; gate and up run in K3); "
           "tpu_function_ms: the same unscaled with f32 output; "
           "chunk_step_m64: a chunk step's layer at M=64 (q, k, v, o, down)",
        tolerance="per shape: f32 output 1e-4 x max|plain| (shapes[].tol); "
                  "bf16 output that plus one bf16 ulp of |plain| per "
                  "element (shapes[].model.least_tol)",
        f32_err_vs_f64="shapes[].f32_err_vs_f64: [kernel, plain] max "
                       "|f32 output - the same function summed in f64| / "
                       "max |f64|",
        rows_identical_to_m1024=dict(
            m=sorted(set(identity)), checks=len(identity),
            cases="four (K, N) pairs x with and without input scale x f32 "
                  "and bf16 output; torch.equal of rows 0..M-1"),
        span_block="shapes[].span_block: spans a block takes (fewer than "
                   "ceil(K/128): split over blocks, a merge launch adds "
                   "the partials in span order; two launches, counted as "
                   "one)",
        library_call="torch.matmul on the pre-dequantized bf16 weight "
                     "(not the same function: it skips the int4 unpack "
                     "and the input scale)",
        shapes=shapes)
    return entry, detail


def k3_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per-element tolerance of K3 against its plain version: the f32
    output (the TPU function) differs only by the order of sums (1e-4 of
    the output scale, as K1); the bf16 output rounds g, u, silu(g) and the
    product as the two-linear MLP does, and a sum a few f32 ulps off may
    round to a neighbouring value at each step (1e-5 of the output scale
    plus 2^-6 of the value: four bf16 ulps)."""
    scale = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        return torch.full_like(ref, 1e-4 * scale)
    return 1e-5 * scale + 2 ** -6 * ref.float().abs()


def _k3_f64(x, wg, wu, sc) -> torch.Tensor:
    """K3's f32 function with every sum in f64 (products of the bf16
    operands are exact there): the yardstick of both f32 sum orders."""
    xg, xu = ((x.float() * s).to(torch.bfloat16) for s in sc) if sc else (x, x)
    return (torch.nn.functional.silu(xg.double() @ wg.double())
            * (xu.double() @ wu.double()))


def check_k3(gen) -> tuple[dict, dict]:
    """K3 at the gate/up pair of every Qwen2.5 layer (896 → 4864, GS 64):
    each M with and without AWQ input scales, held against the plain
    version in both output modes; timed in the mode its caller uses
    (scaled: the model's bf16 output; unscaled: the TPU function's f32)."""
    cfg = QuantConfig(group_size=GS)
    k, n = 896, 4864
    g, u = (pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k), cfg),
        None, None, cfg) for _ in range(2))
    wbytes = sum(t.nbytes for p in (g, u)
                 for t in (p.qweight, p.scales, p.zeros))
    copies = cold_copies(wbytes)
    packs = [tuple(t.clone() for p in (g, u)
                   for t in (p.qweight, p.scales, p.zeros))
             for _ in range(copies)]
    wg, wu = (dequantize_int4(p.qweight, p.scales, p.zeros, GS,
                              torch.bfloat16) for p in (g, u))
    lib_w = [(wg.clone(), wu.clone())
             for _ in range(cold_copies(2 * wg.nbytes))]
    iscales = (torch.rand(k, generator=gen, device="cuda") + 0.5,
               torch.rand(k, generator=gen, device="cuda") + 0.5)
    shapes = []
    for m in (1, 4, 16, 64, 1024):
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        for scaled in (False, True):
            sc = iscales if scaled else None
            errs = {}
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = dict(input_scales=sc, out_dtype=out_dtype)
                out = k1.awq_gateup(x, *packs[0], GS, **kw)
                ref = k1.awq_gateup_ref(x, *packs[0], GS, torch.bfloat16, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                lim = k3_tolerance(ref)
                if not bool((err <= lim).all()):
                    raise AssertionError(
                        f"K3 M={m} scaled={scaled} {out_dtype}: err exceeds "
                        f"its tolerance by {float((err - lim).max())}")
                errs[str(out_dtype).split(".")[-1]] = [
                    float(err.max()), float(lim.min())]
                if out_dtype == torch.float32:
                    exact = _k3_f64(x, wg, wu, sc)
                    vs_f64 = [float((o.double() - exact).abs().max()
                                    / exact.abs().max()) for o in (out, ref)]
            kw = dict(input_scales=sc, out_dtype=(torch.bfloat16 if scaled
                                                  else torch.float32))
            ms = time_ms(lambda i: k1.awq_gateup(x, *packs[i], GS, **kw),
                         copies)
            plain = time_ms(lambda i: k1.awq_gateup_ref(
                x, *packs[i], GS, torch.bfloat16, **kw), copies, iters=10)
            lib = time_ms(lambda i: torch.nn.functional.silu(
                x @ lib_w[i][0]) * (x @ lib_w[i][1]), len(lib_w))
            out_bytes = m * n * (2 if scaled else 4)
            nbytes = (x.nbytes + wbytes + out_bytes
                      + (2 * k * 4 if scaled else 0))
            b_ms, b_by = bound(nbytes, (2 * 2 * m * k * n, BF16_OPS_PER_S))
            shapes.append(dict(m=m, input_scales=scaled, max_abs_err=errs,
                               f32_err_vs_f64=vs_f64, ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by))
    # the summation rule: a row's bits do not depend on M (rows of one x
    # from its own generator, so the checks above keep their inputs)
    x_full = torch.randn(1024, k, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 2)).to(torch.bfloat16)
    identity = []
    for scaled in (False, True):
        for out_dtype in (torch.float32, torch.bfloat16):
            kw = dict(input_scales=iscales if scaled else None,
                      out_dtype=out_dtype)
            full = k1.awq_gateup(x_full, *packs[0], GS, **kw)
            for m in (1, 4, 7, 8, 16, 64, 200):
                part = k1.awq_gateup(x_full[:m].contiguous(), *packs[0], GS,
                                     **kw)
                differ = int((part != full[:m]).sum())
                if differ:
                    raise AssertionError(
                        f"K3 scaled={scaled} {out_dtype}: {differ} elements "
                        f"of rows 0..{m - 1} differ between M={m} and M=1024")
                identity.append(m)
    # K3 against the unfused front at the model's rounding: two K1 calls
    # with bf16 output, silu, product (reported, not gated)
    unfused = []
    for scaled in (False, True):
        sg, su = iscales if scaled else (None, None)
        for m in (4, 64, 1024):
            xm = x_full[:m].contiguous()
            fused = k1.awq_gateup(xm, *packs[0], GS,
                                  input_scales=iscales if scaled else None,
                                  out_dtype=torch.bfloat16)
            g_out = k1.awq_matmul(xm, *packs[0][:3], GS, input_scale=sg,
                                  out_dtype=torch.bfloat16)
            u_out = k1.awq_matmul(xm, *packs[0][3:], GS, input_scale=su,
                                  out_dtype=torch.bfloat16)
            front = torch.nn.functional.silu(g_out) * u_out
            unfused.append(dict(m=m, input_scales=scaled,
                                elements=fused.numel(),
                                differ=int((fused != front).sum())))
    dec = next(s for s in shapes if s["m"] == 4 and s["input_scales"])
    entry = dict(
        name="awq_gateup", route="cuda",
        source="src/repro_torch/csrc/awq_gateup.cu",
        replaces="src/repro/kernels/awq_matmul.py:171",
        max_abs_err=max(e[0] for s in shapes
                        for e in s["max_abs_err"].values()),
        ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
        bound_by=dec["bound_by"], library_ms=dec["library_ms"])
    detail = dict(
        at="one decode layer's gate/up pair at M=4 with AWQ input scales, "
           "bf16 output (the model path)",
        tolerance="f32 output: 1e-4 x max|plain|; bf16 output: 1e-5 x "
                  "max|plain| + 2^-6 x |plain| per element "
                  "(shapes[].max_abs_err: [max error, least tolerance])",
        f32_err_vs_f64="shapes[].f32_err_vs_f64: [kernel, plain] max "
                       "|f32 output - the same function summed in f64| / "
                       "max |f64|",
        rows_identical_to_m1024=dict(
            m=sorted(set(identity)), checks=len(identity),
            cases="with and without input scales x f32 and bf16 output; "
                  "torch.equal of rows 0..M-1"),
        library_call="silu(x @ Wg) * (x @ Wu) with torch.matmul on the "
                     "pre-dequantized bf16 weights (not the same function: "
                     "it skips the int4 unpack and the input scales)",
        vs_unfused_front=dict(
            cases=unfused,
            what="bf16 elements where K3 differs from two K1 calls with "
                 "bf16 output, torch silu and product on the rows of the "
                 "row-identity input (reported, not gated)"),
        shapes=shapes)
    return entry, detail


# K2's tree case: in-row parent of each node of an 8-node token tree (node
# 0 is the root, the slot's last sampled token), as tree speculation lays
# a verify row out
TREE_PARENTS = [-1, 0, 1, 2, 0, 4, 1, 6]


def _tree_mask(pos: torch.Tensor, window: int):
    """rpos (logical positions: base + depth) and amask (ancestor closure)
    for every row of ``pos`` holding TREE_PARENTS; row 0's node 5 is given
    an empty ancestor row and no committed keys, so it must come out 0."""
    c = len(TREE_PARENTS)
    anc = torch.zeros(c, c, dtype=torch.bool)
    depth = [0] * c
    for j, par in enumerate(TREE_PARENTS):
        if par >= 0:
            anc[j] = anc[par]
            depth[j] = depth[par] + 1
        anc[j, j] = True
    b = pos.shape[0]
    amask = (anc[None].expand(b, c, c).to(pos.device)
             & (pos >= 0)[:, None, :]).contiguous()
    amask[0, 5] = False
    rpos = torch.where(pos >= 0, pos[:, :1] + torch.tensor(
        depth, dtype=torch.int32, device=pos.device)[None], pos)
    return dict(rpos=rpos.to(torch.int32).contiguous(), amask=amask,
                window=window)


def _k2_inputs(gen, c: int, tree: bool = False):
    """q, pool copies (int8 codes + f32 strips, enough to pass the L2),
    page table, positions and visibility options (rpos / amask / window)
    for B 4 slots of 32 pages of 16 tokens."""
    b, hkv, g, hd, page, nblk = 4, 2, 7, 64, 16, 32
    npages = b * nblk + 1
    copies = cold_copies(2 * npages * page * hkv * (hd + 4))
    pools = []
    for _ in range(copies):
        kp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=gen,
                           device="cuda", dtype=torch.int8)
        vp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=gen,
                           device="cuda", dtype=torch.int8)
        ks = torch.rand(npages, page, hkv, generator=gen, device="cuda") / 50
        vs = torch.rand(npages, page, hkv, generator=gen, device="cuda") / 50
        pools.append((kp, ks, vp, vs))
    table = (torch.randperm(npages - 1, generator=gen, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    if c == 1:
        pos = torch.tensor([[-1], [137], [300], [511]], dtype=torch.int32,
                           device="cuda")                 # row 0: padding
    elif tree:
        base = torch.tensor([0, 137, 300, 0], dtype=torch.int32,
                            device="cuda")
        pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                           device="cuda")[None]
        pos[3] = -1                                       # padding row
    else:
        base = torch.tensor([0, 137, 300, 512 - c], dtype=torch.int32,
                            device="cuda")
        pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                           device="cuda")[None]
        pos[2, c // 2:] = -1                              # padded tail
    q = torch.randn(b, c, hkv, g, hd, generator=gen, device="cuda")
    kw = _tree_mask(pos, window=128) if tree else {}
    return q, pools, table, pos, kw


def _k2_yardstick(q, pools, table, pos, kw) -> tuple[float, float, str]:
    """(library ms, bound ms, bound by) of one K2 call: SDPA over K/V
    already gathered and dequantized (bf16), with the visibility as a
    boolean mask — not the same function — and the bound on the bytes
    this data needs (q, out, and for every row the int8 codes + f32
    scales of the keys its queries can see, per kv head) and its f32
    operations."""
    b, c, hkv, g, hd = q.shape
    s_slot = table.shape[1] * 16
    vis = k2.chunk_visibility_ref(pos, s_slot=s_slot, **kw)
    mask = vis[:, None].expand(b, hkv * g, c, s_slot)
    kv = []
    for kp, ks, vp, vs in pools:
        kk = (kp.float() * ks[..., None])[table.long()].reshape(
            b, s_slot, hkv, hd).transpose(1, 2).to(torch.bfloat16)
        vv = (vp.float() * vs[..., None])[table.long()].reshape(
            b, s_slot, hkv, hd).transpose(1, 2).to(torch.bfloat16)
        kv.append((kk.contiguous(), vv.contiguous()))
    qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, c, hd).to(
        torch.bfloat16)
    lib = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qs, *kv[i], attn_mask=mask, enable_gqa=True), len(pools))
    keys = int(vis.any(dim=1).sum())             # (row, key) pairs
    visible = int(vis.sum())                     # (query, key) pairs
    nbytes = (2 * q.nbytes + keys * hkv * (2 * hd + 8)
              + table.nbytes + pos.nbytes
              + sum(t.nbytes for t in kw.values()
                    if isinstance(t, torch.Tensor)))
    b_ms, b_by = bound(nbytes, (4 * visible * hkv * g * hd, F32_OPS_PER_S))
    return lib, b_ms, b_by


def check_k2(gen) -> tuple[dict, dict]:
    per_c = []
    for case, c in (("decode", 1), ("chunk", 16), ("tree", 8)):
        q, pools, table, pos, kw = _k2_inputs(gen, c, tree=case == "tree")
        copies = len(pools)

        def run(i, fn):
            kp, ks, vp, vs = pools[i]
            return fn(q, kp, ks, vp, vs, table, pos, **kw)

        out = run(0, k2.paged_attention_chunk)
        ref = run(0, k2.paged_attention_chunk_ref)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        if not err <= tol:
            raise AssertionError(f"K2 {case} C={c}: err {err} > {tol}")
        vis = k2.chunk_visibility_ref(pos, s_slot=table.shape[1] * 16, **kw)
        empty = ~vis.any(dim=-1)                     # padding + empty rows
        if case == "tree" and not bool(empty[0, 5]):
            raise AssertionError("K2 tree: row 0 node 5 should see nothing")
        if out[empty].abs().max() != 0:
            raise AssertionError(f"K2 {case}: rows that see nothing must "
                                 f"give exact 0")
        ms = time_ms(lambda i: run(i, k2.paged_attention_chunk), copies)
        plain = time_ms(lambda i: run(i, k2.paged_attention_chunk_ref),
                        copies, iters=10)
        lib, b_ms, b_by = _k2_yardstick(q, pools, table, pos, kw)
        per_c.append(dict(case=case, c=c, max_abs_err=err, tol=tol, ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by))
    dec = per_c[0]
    entry = dict(
        name="paged_attention_chunk", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:240",
        max_abs_err=max(s["max_abs_err"] for s in per_c),
        ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
        bound_by=dec["bound_by"], library_ms=dec["library_ms"])
    detail = dict(
        at="decode, C=1, B=4, contexts 137/300/511 + a padding row",
        design=f"keys split in spans of {k2.SPAN}, a block per span, kv "
               f"head and 8 query rows (4 warps of 32 keys; "
               f"{k2.smem_bytes(64)} B of shared memory at hd 64), then a "
               f"merge pass in span order: 2 kernel launches per call, "
               f"counted as 1",
        tolerance="per shape: 1e-5 x max(1, max|plain|) (shapes[].tol)",
        library_call="torch SDPA over gathered, dequantized bf16 K/V with "
                     "a boolean mask (not the same function)",
        shapes=per_c)
    return entry, detail


def _split_heads(t: torch.Tensor, dim: int, n: int) -> list[torch.Tensor]:
    """``t`` cut into n pieces along ``dim``, each its own contiguous
    allocation (a shard's stripe)."""
    return [p.contiguous() for p in torch.chunk(t, n, dim=dim)]


def tp_mesh():
    """The tp checks' 2-way ``model`` mesh, both shards on cuda:0."""
    return serving_mesh(2, devices=["cuda:0", "cuda:0"])


def check_k2_tp(gen) -> tuple[dict, dict]:
    """K2-TP at Qwen2.5's decode shape cut over a 2-way mesh (Hkv 2 → 1
    kv head a shard, G 7, hd 64, B 4, contexts to 512 with padding rows):
    C 1 and 16, and C 8 with a token tree's mask, logical positions and
    a window. Its shards joined over heads must equal one K2 launch over
    both heads bit for bit (K2's blocks are per slot and kv head), and
    its plain version within K2's tolerance. Timed beside K2 over all
    heads (the same work and bytes, so the same bound) and SDPA over the
    gathered heads."""
    mesh = tp_mesh()
    per_c = []
    for case, c in (("decode", 1), ("chunk", 16), ("tree", 8)):
        q, pools, table, pos, kw = _k2_inputs(gen, c, tree=case == "tree")
        copies = len(pools)
        cut = [([_split_heads(q, 2, 2)] + [
            _split_heads(t, dim, 2) for t, dim in zip(pl, (-2, -1, -2, -1))])
               for pl in pools]

        def tp(i, fn=k2.paged_attention_chunk_sharded):
            return fn(*cut[i], table, pos, mesh=mesh, **kw)

        def whole(i):
            kp, ks, vp, vs = pools[i]
            return k2.paged_attention_chunk(q, kp, ks, vp, vs, table, pos,
                                            **kw)

        before = (k2.TP_COUNTER.count, k2.COUNTER.count)
        outs = tp(0)
        torch.cuda.synchronize()
        if (k2.TP_COUNTER.count - before[0],
                k2.COUNTER.count - before[1]) != (1, 2):
            raise AssertionError("K2-TP: one call must launch K2 once a "
                                 "shard and count one K2-TP launch")
        joined = torch.cat(outs, dim=2)
        full = whole(0)
        torch.cuda.synchronize()
        if not torch.equal(joined, full):
            raise AssertionError(f"K2-TP {case}: shards joined differ from "
                                 f"K2 over all heads by "
                                 f"{float((joined - full).abs().max())}")
        ref = torch.cat(tp(0, k2.paged_attention_chunk_sharded_ref), dim=2)
        err = float((joined - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        if not err <= tol:
            raise AssertionError(f"K2-TP {case} C={c}: err {err} > {tol}")
        ms = time_ms(tp, copies)
        k2_ms = time_ms(whole, copies)
        plain = time_ms(lambda i: tp(i, k2.paged_attention_chunk_sharded_ref),
                        copies, iters=10)
        # K2's bytes and operations over both heads: the shards split them
        lib, b_ms, b_by = _k2_yardstick(q, pools, table, pos, kw)
        per_c.append(dict(case=case, c=c, max_abs_err=err, tol=tol,
                          bit_equal_to_k2=True, ms=ms, k2_all_heads_ms=k2_ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by))
    dec = per_c[0]
    entry = dict(
        name="paged_attention_chunk_sharded", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:255",
        max_abs_err=max(s["max_abs_err"] for s in per_c),
        ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
        bound_by=dec["bound_by"], library_ms=dec["library_ms"])
    detail = dict(
        at="decode, C=1, B=4, contexts 137/300/511 + a padding row, "
           "Hkv 2 over a 2-way mesh on one card (1 kv head a shard)",
        design="K2 launched once a shard on its KV-head stripe (each "
               "stripe its own contiguous pool), tables and positions "
               "replicated; no new CUDA: the wrapper "
               "src/repro_torch/kernels/paged_attention.py",
        tolerance="bit-equal to K2 over all heads; 1e-5 x max(1, "
                  "max|plain|) against its plain version",
        library_call="torch SDPA over gathered, dequantized bf16 K/V of "
                     "both heads with a boolean mask (not the same "
                     "function)",
        shapes=per_c)
    return entry, detail


# K4 cases: name, B, S, causal, window (H 14, Hkv 2, hd 64, bf16)
K4_CASES = [("calibration", 2, 64, True, 0), ("prefill", 4, 256, True, 0),
            ("oneshot_prefill", 1, 200, True, 0),
            ("ragged", 1, 1000, True, 0), ("window", 1, 1000, True, 128),
            ("bidirectional", 4, 256, False, 0)]


def check_k4(gen) -> tuple[dict, dict]:
    """K4 at the shapes the launcher gives it. q, k and v are the
    [B, S, H, hd] projections passed as ``transpose(1, 2)`` views, as
    `attention()` passes them, and sit in L2 as the prefill leaves them."""
    h, hkv, hd, dt = 14, 2, 64, torch.bfloat16
    per_case = []
    for case, b, s, causal, window in K4_CASES:
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
                   .to(dt).transpose(1, 2) for n in (h, hkv, hkv))
        kw = dict(causal=causal, window=window)
        out = k4.flash_attention(q, k, v, **kw)
        ref = k4.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lim = 1e-5 + torch.finfo(dt).eps * ref.float().abs()
        if not bool((err <= lim).all()):
            raise AssertionError(f"K4 {case}: err exceeds 1e-5 + eps|ref| by "
                                 f"{float((err - lim).max())}")
        ms = time_ms(lambda i: k4.flash_attention(q, k, v, **kw), 1)
        plain = time_ms(lambda i: k4.flash_attention_ref(q, k, v, **kw), 1,
                        iters=10)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        mask = k4.visibility(s, causal=causal, window=window, device="cuda")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_kw = (dict(attn_mask=mask) if window
                  else dict(is_causal=causal))
        lib = time_ms(lambda i: sdpa(qc, kc, vc, enable_gqa=True, **lib_kw), 1)
        nbytes = q.nbytes + k.nbytes + v.nbytes + out.nbytes
        # per visible pair and head: QK^T's 2*hd flops on bf16 operands
        # (exact on tensor cores, f32 sums), and PV's 2*hd on f32
        # probabilities, which tensor cores take exactly as two bf16
        # halves (hi, lo) against the bf16 V: 2 x 2*hd
        pair_flops = 2 * hd * h * b * int(mask.sum())
        b_ms, b_by = bound(nbytes, (3 * pair_flops, BF16_OPS_PER_S))
        per_case.append(dict(case=case, b=b, s=s, causal=causal,
                             window=window, max_abs_err=float(err.max()),
                             ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=b_ms, bound_by=b_by))
    pre = next(c for c in per_case if c["case"] == "prefill")
    entry = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:108",
        max_abs_err=max(c["max_abs_err"] for c in per_case),
        ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by=pre["bound_by"], library_ms=pre["library_ms"])
    detail = dict(
        at="the launcher's prefill: B 4, S 256, H 14 / Hkv 2, hd 64, bf16, "
           "causal",
        tolerance="per element: 1e-5 + bf16 eps (2^-7) x |plain|",
        bound="the larger of: bytes of Q, K, V, O at 3.35 TB/s; per "
              "visible (query, key) pair and head, QK^T's 2*hd flops plus "
              "PV's 2 x 2*hd (the f32 probabilities as two bf16 halves, "
              "exact against bf16 V) at 989 TFLOP/s; the kernel runs all "
              "three products on tensor cores (mma.sync)",
        library_call="torch SDPA (is_causal / boolean mask, enable_gqa) on "
                     "the same bf16 tensors, made contiguous",
        shapes=per_case)
    return entry, detail


# ------------------------------------------------------------------ phase 4
SERVE_LENS = [16, 200, 45, 120, 77, 190, 33, 150]


def serve_prompts(vocab: int) -> list[np.ndarray]:
    """The serving phases' 8 seeded prompts."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in SERVE_LENS]


def check_streams(label: str, out: dict, rids, vocab: int,
                  n: int = 32) -> None:
    for rid in rids:
        toks = out[rid]
        if toks.shape != (n,) or not ((toks >= 0) & (toks < vocab)).all():
            raise AssertionError(f"{label}: request {rid}: bad stream {toks}")


def _serve_burst(eng, prompts, names, new: int = 32) -> dict:
    """Submit ``prompts`` (``new`` tokens each) and step ``eng`` until
    idle: each step's host time, and the launches of ``names`` in steps
    with decode rows only and in steps with prefill rows."""
    t0 = time.perf_counter()
    rids = [eng.submit(p, new) for p in prompts]
    decode_s, decode_tokens, decode_steps, steps, prefilled = 0.0, 0, 0, 0, 0
    decode_launches = dict.fromkeys(names, 0)
    prefill_launches = dict.fromkeys(names, 0)
    while not eng.idle:
        before = read_counts(names)
        ts = time.perf_counter()
        events = eng.step()                 # ends in a device→host copy
        dt = time.perf_counter() - ts
        steps += 1
        now = eng.stats().prefill_tokens
        into = prefill_launches
        if now == prefilled:                # a step with decode rows only
            decode_s += dt
            decode_tokens += len(events)
            decode_steps += 1
            into = decode_launches
        for n, v in read_counts(names).items():
            into[n] += v - before[n]
        prefilled = now
    out = eng.drain()
    return dict(rids=rids, out=out, serve_s=time.perf_counter() - t0,
                steps=steps, decode_s=decode_s, decode_tokens=decode_tokens,
                decode_steps=decode_steps, decode_launches=decode_launches,
                prefill_launches=prefill_launches,
                launches=read_counts(names))


def serve(model, params) -> dict:
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, prefill_chunk=16, kv_quant="int8")
    prompts = serve_prompts(model.cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the serve path's kernels (K4 is not on it)
    names = ("awq_matmul", "awq_gateup", "paged_attention_chunk")
    # the main path: counts start at 0 here and are read right after
    reset_counts()
    qlinear.COUNTS.kernel = qlinear.COUNTS.generic = 0
    run = _serve_burst(eng, prompts, names)
    rids, out, launches = run["rids"], run["out"], run["launches"]
    decode_steps, steps = run["decode_steps"], run["steps"]
    paths = {"kernel": qlinear.COUNTS.kernel,
             "generic": qlinear.COUNTS.generic}
    check_streams("serve", out, rids, model.cfg.vocab_size)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    st = eng.stats()
    return dict(requests=len(rids), generated=32 * len(rids), steps=steps,
                dispatches=st.dispatches, serve_s=run["serve_s"],
                decode_tokens_per_s=run["decode_tokens"] / run["decode_s"],
                decode_steps=decode_steps,
                decode_step_ms=1e3 * run["decode_s"] / max(1, decode_steps),
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                kv_pool_bytes=st.kv_pool_bytes, weight_bytes=st.weight_bytes,
                launches=launches,
                launches_per_decode_step={
                    n: v / max(1, decode_steps)
                    for n, v in run["decode_launches"].items()},
                prefill_steps=steps - decode_steps,
                launches_in_decode_steps=run["decode_launches"],
                launches_in_prefill_steps=run["prefill_launches"],
                qlinear_calls=paths, streams=[out[r] for r in rids])


# -------------------------------------------------------------- phases 5-7
def serve_oneshot(model, params) -> dict:
    """The one-shot path on the serve phase's requests: each admission
    runs a dense prefill of the whole prompt (K4, K1, K3 at M = its
    length), commits its KV into int8 pages and samples the first token;
    every step then decodes one token for all 4 slots over the pages (K2,
    K1, K3 at M = 4). A step that admitted nobody is a decode-only step;
    each prefill-commit ends in a device→host copy of its first token,
    so the host clock around it covers its device work."""
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, kv_quant="int8",
                           chunked_prefill=False)
    prompts = serve_prompts(model.cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the one-shot path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, 32) for p in prompts]
    sched = eng._scheduler
    commit_s = []
    prefill_commit = sched._prefill_commit

    def timed_commit(*args):
        t = time.perf_counter()
        tok = prefill_commit(*args)
        commit_s.append(time.perf_counter() - t)
        return tok

    sched._prefill_commit = timed_commit
    decode_s, decode_tokens, decode_steps, steps = 0.0, 0, 0, 0
    while not eng.idle:
        admitted = sched.stats.admitted
        ts = time.perf_counter()
        events = eng.step()                 # ends in a device→host copy
        dt = time.perf_counter() - ts
        steps += 1
        if sched.stats.admitted == admitted:
            decode_s += dt
            decode_tokens += len(events)
            decode_steps += 1
    out = eng.drain()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    check_streams("serve_oneshot", out, rids, model.cfg.vocab_size)
    if min(launches.values()) <= 0:
        raise AssertionError(f"serve_oneshot: a kernel of the path never "
                             f"ran: {launches}")
    k4_want = model.cfg.num_layers * len(prompts)
    if launches["flash_attention"] != k4_want:
        raise AssertionError(f"serve_oneshot: K4 launched "
                             f"{launches['flash_attention']} times, want one "
                             f"per layer per request ({k4_want})")
    st, sst = eng.stats(), eng.scheduler_stats
    if not (sst.admitted == sst.finished == len(prompts)
            and sched.pager.pages_in_use == 0 and st.prefill_tokens == 0):
        raise AssertionError(
            f"serve_oneshot: admitted {sst.admitted}, finished "
            f"{sst.finished}, pages in use {sched.pager.pages_in_use}, "
            f"prefill_tokens {st.prefill_tokens} (want 8, 8, 0, 0: the "
            f"reference counts prompt tokens on the chunked path only)")
    return dict(requests=len(rids), generated=32 * len(rids), steps=steps,
                serve_s=total_s, decode_tokens_per_s=decode_tokens / decode_s,
                decode_steps=decode_steps,
                decode_step_ms=1e3 * decode_s / max(1, decode_steps),
                prefill_commits=len(commit_s),
                prefill_commit_ms=1e3 * sum(commit_s) / len(commit_s),
                prefill_commit_ms_by_prompt=[1e3 * t for t in commit_s],
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, admitted=sst.admitted,
                finished=sst.finished,
                pages_in_use=sched.pager.pages_in_use,
                **{k: getattr(st, k) for k in (
                    "dispatches", "prefill_tokens", "kv_pool_bytes",
                    "kv_bytes_per_token", "weight_bytes",
                    "weight_bytes_per_token", "padding_waste",
                    "padding_waste_fixed")})


@torch.no_grad()
def _logit_margin(model, params, prompt, ref, i: int, other: int,
                  max_seq: int = 512) -> float:
    """generate()'s logit of its own token ``ref[i]`` minus its logit of
    ``other`` at position i: the prefill, then i decode steps fed ref's
    tokens (generate()'s own computation up to that position)."""
    cache = model.init_cache(1, max_seq, device="cuda")
    cache, logits, pos = model.prefill(
        params, {"tokens": torch.as_tensor(prompt, device="cuda")[None]},
        cache)
    for t in ref[:i]:
        logits, cache = model.decode_step(
            params, cache, torch.tensor([int(t)], dtype=torch.int32,
                                        device="cuda"), pos)
        pos = pos + 1
    lg = logits[0].float()
    return float(lg[int(ref[i])] - lg[int(other)])


def oneshot_identity(model, params) -> dict:
    """The same requests one-shot over bf16 pools, each stream against the
    port's own `generate()` at B = 1, under the default hybrid threshold
    and with every quantized linear on K1 / K3 (``ALL_KERNEL``), which
    separates the linears from the attention. The first token comes from
    the same `Model.prefill` on the same input and must be equal; later
    tokens are reported, not gated: decode rows attend at M = 4 slots
    over the context bucket's gathered pages where generate() attends at
    B = 1 over its dense cache, so near-tied logits may part."""
    return {name: _oneshot_identity(model, params, ecfg)
            for name, ecfg in (("default", qlinear.ExecutionConfig()),
                               ("all_kernel", ALL_KERNEL))}


def _oneshot_identity(model, params, ecfg) -> dict:
    with qlinear.execution_config(ecfg):
        return _oneshot_identity_run(model, params)


def _oneshot_identity_run(model, params) -> dict:
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, kv_quant="none",
                           chunked_prefill=False)
    prompts = serve_prompts(model.cfg.vocab_size)
    rids = [eng.submit(p, 32) for p in prompts]
    out = eng.drain()
    check_streams("oneshot_identity", out, rids, model.cfg.vocab_size)
    identical, mismatches = 0, []
    for rid, p in zip(rids, prompts):
        ref = eng.generate({"tokens": p[None]}, 32)[0]
        got = out[rid]
        if got[0] != ref[0]:
            raise AssertionError(f"oneshot_identity: request {rid}: first "
                                 f"token {got[0]} != generate()'s {ref[0]}")
        if np.array_equal(got, ref):
            identical += 1
            continue
        i = int(np.argmax(got != ref))
        mismatches.append(dict(
            request=rid, prompt_len=len(p), first_diff=i,
            generate_token=int(ref[i]), oneshot_token=int(got[i]),
            logit_margin=_logit_margin(model, params, p, ref, i,
                                       int(got[i]))))
    return dict(requests=len(rids), identical_streams=identical,
                mismatches=mismatches)


PARALLEL_N = 4


def parallel(model, params) -> dict:
    """Greedy parallel sampling on the chunked int8 engine: the 200-token
    prompt, ``submit(..., n=4)``. The siblings share one prefix namespace:
    the first prefills all 200 tokens, and each of the three followers
    aliases its 12 full pages of 16 and skips their 192 tokens.

    A follower waits while another sibling still prefills, so each
    sibling's rows share their steps with other rows at another M: under
    the default hybrid threshold a row's k / v projections take K1 in one
    step and the generic path in another (`offload_min_flops`), so the
    streams are compared and reported, not gated. With every quantized
    linear on K1 / K3 (``offload_min_flops=0``), whose rows do not depend
    on the rows beside them, all four must be identical."""
    prompt = serve_prompts(model.cfg.vocab_size)[1]
    followers, full = PARALLEL_N - 1, len(prompt) // 16
    want = (followers * full, followers * full * 16)
    runs = {}
    for name, ecfg in (("default", qlinear.ExecutionConfig()),
                       ("all_kernel", qlinear.ExecutionConfig(
                           offload_min_flops=0))):
        eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                               max_seq=512, prefill_chunk=16,
                               kv_quant="int8")
        reset_counts()
        t0 = time.perf_counter()
        with qlinear.execution_config(ecfg):
            rids = eng.submit(prompt, 32, n=PARALLEL_N)
            out = eng.drain()
        total_s = time.perf_counter() - t0
        launches = read_counts()
        check_streams(f"parallel {name}", out, rids, model.cfg.vocab_size)
        streams = [out[r] for r in rids]
        same = [bool(np.array_equal(t, streams[0])) for t in streams]
        if name == "all_kernel" and not all(same):
            raise AssertionError(f"parallel {name}: greedy siblings differ: "
                                 f"{[t.tolist() for t in streams]}")
        st = eng.stats()
        got = (st.prefix_shared_pages, st.prefill_tokens_skipped)
        pages = eng._scheduler.pager.pages_in_use
        if got != want or pages != 0:
            raise AssertionError(f"parallel {name}: (prefix_shared_pages, "
                                 f"prefill_tokens_skipped) {got}, want "
                                 f"{want}; {pages} pages in use after drain")
        runs[name] = dict(
            serve_s=total_s, identical_to_first=same,
            first_diff=[None if ok else int(np.flatnonzero(t != streams[0])[0])
                        for ok, t in zip(same, streams)],
            prefix_shared_pages=got[0], prefill_tokens_skipped=got[1],
            prefill_tokens=st.prefill_tokens, pages_in_use=pages,
            launches=launches, sample=streams[0][:8].tolist())
    return dict(n=PARALLEL_N, prompt_len=len(prompt), **runs)


# ------------------------------------------------------------ phases 8-10
# the SLO traffic: the four longest serve prompts (200, 190, 150, 120) at
# priority 0 with 64 new tokens, then, after 4 steps, the four shortest
# (16, 33, 45, 77) at priority 1 with 16 new tokens
SLO_LONG, SLO_SHORT = [1, 5, 7, 3], [0, 6, 2, 4]
# the serving phases' Qwen2.5-0.5B (and the fleet's): full width, 4 of its
# 24 layers (all 24 before the tp_families phase came: its serving steps
# are host-bound, ~150 launches a layer, so a step's time follows the
# depth; cut for the time limit on a slow host)
SERVE_LAYERS = 4
# one int8 page of 16 tokens over those layers: k, v codes (2 x 2 heads x
# 64) and their f32 scale strips (2 x 2 heads x 4) per token
INT8_PAGE_BYTES = SERVE_LAYERS * 16 * 272
# the optimistic pool: the four long requests' reserved worst case
# (17 + 16 + 14 + 12 = 59 pages) does not fit its 47 usable pages
OPTIMISTIC_PAGES = 48
SERVE_KW = dict(num_slots=4, page_size=16, max_seq=512, prefill_chunk=16,
                kv_quant="int8")
ALL_KERNEL = qlinear.ExecutionConfig(offload_min_flops=0)
SLO_NAMES = ("awq_matmul", "awq_gateup", "paged_attention_chunk")


def _reset_peak() -> None:
    """Start a peak-memory window with only live engines allocated: an
    engine and its scheduler hold each other (the scheduler's callbacks
    are the engine's bound methods), so a dropped engine keeps its page
    pools until the cyclic collector runs."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _watch_spills(eng) -> list:
    """Wrap the scheduler's spill hook: every parked strip must lie in
    pinned host memory (gathered on the card, never left there); returns
    the list the spilled bytes of each spill are appended to."""
    sched = eng._scheduler
    spill, seen = sched._spill_fn, []

    def watched(ids):
        handle = spill(ids)
        strips = [t for leaves in handle["strips"].values()
                  for t in leaves.values()]
        bad = [t.device for t in strips
               if t.device.type != "cpu" or not t.is_pinned()]
        if bad:
            raise AssertionError(f"parked strips not in pinned host "
                                 f"memory: {bad}")
        seen.append(sum(t.numel() * t.element_size() for t in strips))
        return handle

    sched._spill_fn = watched
    return seen


def _slo_serve(eng, prompts) -> dict:
    """Drive the SLO traffic through ``eng`` and time its steps; a step in
    which no prompt token ran is a decode-only step."""
    rids = [eng.submit(prompts[i], 64) for i in SLO_LONG]
    spilled = _watch_spills(eng) if eng.preemption else []
    decode_s, decode_tokens, decode_steps, steps, prefilled = 0.0, 0, 0, 0, 0
    t0 = time.perf_counter()
    while not eng.idle:
        if steps == 4:
            rids += [eng.submit(prompts[i], 16, priority=1)
                     for i in SLO_SHORT]
        ts = time.perf_counter()
        events = eng.step()                 # ends in a device→host copy
        dt = time.perf_counter() - ts
        steps += 1
        now = eng.stats().prefill_tokens
        if now == prefilled:
            decode_s += dt
            decode_tokens += len(events)
            decode_steps += 1
        prefilled = now
    out = eng.drain()
    return dict(rids=rids, out=out, serve_s=time.perf_counter() - t0,
                steps=steps, spilled_bytes=spilled,
                decode_tokens_per_s=decode_tokens / decode_s,
                decode_step_ms=1e3 * decode_s / max(1, decode_steps))


def _first_diffs(streams, refs) -> list:
    return [None if np.array_equal(a, b) else int(np.argmax(a != b))
            for a, b in zip(streams, refs)]


def _slo_phase(label, model, params, refs, **engine_kw) -> dict:
    """The SLO traffic on a preempting engine, once with every quantized
    linear on K1 / K3 (streams gated equal to ``refs[name]``, the same
    traffic on an engine that never preempts) and once under the default
    hybrid threshold (compared and reported)."""
    prompts = serve_prompts(model.cfg.vocab_size)
    runs = {}
    for name, ecfg in (("all_kernel", ALL_KERNEL),
                       ("default", qlinear.ExecutionConfig())):
        eng = GenerationEngine(model, params, preemption=True, **SERVE_KW,
                               **engine_kw)
        _reset_peak()
        # this path: counts start at 0 here and are read right after
        reset_counts()
        with qlinear.execution_config(ecfg):
            run = _slo_serve(eng, prompts)
        launches = read_counts(SLO_NAMES)
        out, rids = run.pop("out"), run.pop("rids")
        check_streams(f"{label} {name}", out, rids[:len(SLO_LONG)],
                      model.cfg.vocab_size, n=64)
        check_streams(f"{label} {name}", out, rids[len(SLO_LONG):],
                      model.cfg.vocab_size, n=16)
        if min(launches.values()) <= 0:
            raise AssertionError(f"{label} {name}: a kernel of the path "
                                 f"never ran: {launches}")
        streams = [out[r] for r in rids]
        diffs = _first_diffs(streams, refs[name])
        if name == "all_kernel" and any(d is not None for d in diffs):
            raise AssertionError(f"{label} {name}: preempted streams differ "
                                 f"from the uninterrupted ones at {diffs}")
        st = eng.stats()
        page = eng.paged_kv_page_bytes()
        spilled = run.pop("spilled_bytes")
        if not (st.preemptions >= 1 and st.restores == st.preemptions
                and st.spilled_pages == st.restored_pages
                and st.pages_spilled_now == 0 and st.pager.pages_used == 0
                and page == INT8_PAGE_BYTES
                and sum(spilled) == st.spilled_pages * page
                and len(spilled) == st.preemptions):
            raise AssertionError(
                f"{label} {name}: preemptions {st.preemptions}, restores "
                f"{st.restores}, spilled / restored pages "
                f"{st.spilled_pages} / {st.restored_pages}, pages spilled "
                f"now {st.pages_spilled_now}, pages in use "
                f"{st.pager.pages_used}, page bytes {page}, spilled bytes "
                f"{spilled}")
        runs[name] = dict(
            **run, identical_streams=sum(d is None for d in diffs),
            first_diff=diffs, launches=launches,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            spilled_bytes=sum(spilled), page_bytes=page,
            **{k: getattr(st, k) for k in (
                "preemptions", "pressure_spills", "restores",
                "spilled_pages", "restored_pages", "pages_spilled_now",
                "restore_ms_mean", "dispatches", "prefill_tokens",
                "kv_pool_bytes")})
    return dict(requests=len(SLO_LONG) + len(SLO_SHORT), **runs)


def uninterrupted(model, params) -> dict:
    """The SLO traffic on the serve engine without preemption (the short
    requests wait for slots), under both configurations: the streams the
    preempting engines must reproduce."""
    prompts = serve_prompts(model.cfg.vocab_size)
    refs = {}
    for name, ecfg in (("all_kernel", ALL_KERNEL),
                       ("default", qlinear.ExecutionConfig())):
        eng = GenerationEngine(model, params, **SERVE_KW)
        with qlinear.execution_config(ecfg):
            run = _slo_serve(eng, prompts)
        refs[name] = [run["out"][r] for r in run["rids"]]
    return refs


def preempt(model, params, refs) -> dict:
    """SLO preemption on the serve engine (full pool): the short
    high-priority requests find every slot held and spill low-priority
    victims to pinned host memory; the victims come back at their commit
    watermark."""
    return _slo_phase("preempt", model, params, refs)


def optimistic(model, params, refs) -> dict:
    """Optimistic admission on a pool that the long requests' reserved
    worst case does not fit: pressure relief must spill at least once."""
    res = _slo_phase("optimistic", model, params, refs,
                     admission="optimistic", num_pages=OPTIMISTIC_PAGES)
    for name in ("all_kernel", "default"):
        if res[name]["pressure_spills"] < 1:
            raise AssertionError(f"optimistic {name}: pressure relief never "
                                 f"fired ({res[name]['pressure_spills']})")
    return dict(num_pages=OPTIMISTIC_PAGES, **res)


DISAGG_MIN_TOKENS = 64


def disagg(model, params) -> dict:
    """A `DisaggController` over the same weights, the serve shape on both
    sides: the 8 serve prompts, 32 new tokens each. Prompts of 64 tokens
    or more (200, 120, 77, 190, 150) prefill on the prefill engine and
    hand their int8 pages to the decode engine; 16, 45 and 33 go direct.
    Streams are gated equal to a unified engine's with every quantized
    linear on K1 / K3. ``"auto"`` placement's split report is printed."""
    prompts = serve_prompts(model.cfg.vocab_size)
    auto = DisaggController(model, params, **SERVE_KW)
    with qlinear.execution_config(ALL_KERNEL):
        uni = GenerationEngine(model, params, **SERVE_KW)
        rids = [uni.submit(p, 32) for p in prompts]
        out = uni.drain()
        refs = [out[r] for r in rids]
        del uni
        ctrl = DisaggController(model, params,
                                handoff_min_tokens=DISAGG_MIN_TOKENS,
                                **SERVE_KW)
        side_launches = {s: dict.fromkeys(SLO_NAMES, 0)
                         for s in ("prefill", "decode")}
        for side in ("prefill", "decode"):
            eng = getattr(ctrl, side)
            step = eng.step

            def counted(step=step, into=side_launches[side]):
                before = read_counts(SLO_NAMES)
                events = step()
                for n, v in read_counts(SLO_NAMES).items():
                    into[n] += v - before[n]
                return events
            eng.step = counted
        _reset_peak()
        # this path: counts start at 0 here and are read right after
        reset_counts()
        t0 = time.perf_counter()
        crids = [ctrl.submit(p, 32) for p in prompts]
        got = ctrl.drain()
        total_s = time.perf_counter() - t0
        launches = read_counts(SLO_NAMES)
    streams = [got[r] for r in crids]
    check_streams("disagg", got, crids, model.cfg.vocab_size)
    diffs = _first_diffs(streams, refs)
    if any(d is not None for d in diffs):
        raise AssertionError(f"disagg: streams differ from the unified "
                             f"engine's at {diffs}")
    for side in ("prefill", "decode"):
        if min(side_launches[side].values()) <= 0:
            raise AssertionError(f"disagg: a kernel never ran on the "
                                 f"{side} side: {side_launches[side]}")
    st = ctrl.stats()
    in_use = [e.engine._scheduler.pager.pages_in_use
              for e in (ctrl.prefill, ctrl.decode)]
    want_pages = sum(-(-len(prompts[i]) // 16) for i in range(len(prompts))
                     if len(prompts[i]) >= DISAGG_MIN_TOKENS)
    want = dict(handoffs=5, direct=3, handoff_pages=want_pages,
                aliased_pages=0, wire_bytes=want_pages * INT8_PAGE_BYTES)
    got_ints = {k: getattr(st, k) for k in want}
    if got_ints != want or in_use != [0, 0] or want_pages != 48:
        raise AssertionError(f"disagg: {got_ints}, want {want} (48 pages); "
                             f"pages in use {in_use}")
    rep = auto.split_report
    return dict(
        requests=len(prompts), handoff_min_tokens=DISAGG_MIN_TOKENS,
        **got_ints, serve_s=total_s,
        adopt_ms_mean=1e3 * st.adopt_time_s / st.handoffs,
        prefill_step_s=st.prefill_step_time_s,
        decode_step_s=st.decode_step_time_s,
        prefill_dispatches=ctrl.prefill.stats().dispatches,
        decode_dispatches=ctrl.decode.stats().dispatches,
        prefill_step_ms=1e3 * st.prefill_step_time_s
        / max(1, ctrl.prefill.stats().dispatches),
        decode_step_ms=1e3 * st.decode_step_time_s
        / max(1, ctrl.decode.stats().dispatches),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        kv_pool_bytes_per_side=ctrl.decode.stats().kv_pool_bytes,
        launches=launches, launches_by_side=side_launches,
        identical_streams=len(streams), unified_streams=refs,
        auto=dict(handoff_min_tokens=auto.handoff_min_tokens,
                  split_report=rep))


# ----------------------------------------------------------- phases 11-13
# the speculation traffic: each serve length (16 … 200) filled with its
# own seeded 24-token motif, the kind of repetition (templated chat, code)
# prompt lookup drafts from; 32 new tokens each, greedy
SPEC_MOTIF = 24
SPEC_K = 4


def spec_prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 3)
    return [np.resize(rng.integers(0, vocab, SPEC_MOTIF), n).astype(np.int32)
            for n in SERVE_LENS]


def spec_refs(model, params) -> dict:
    """The speculation traffic on the serve engine without speculation,
    under both configurations: the streams the speculating engines must
    reproduce."""
    prompts = spec_prompts(model.cfg.vocab_size)
    refs = {}
    for name, ecfg in (("all_kernel", ALL_KERNEL),
                       ("default", qlinear.ExecutionConfig())):
        eng = GenerationEngine(model, params, **SERVE_KW)
        with qlinear.execution_config(ecfg):
            rids = [eng.submit(p, 32) for p in prompts]
            out = eng.drain()
        refs[name] = [out[r] for r in rids]
    return refs


def _spec_serve(eng, prompts) -> dict:
    """Drive the speculation traffic through ``eng``, watching its
    scheduler: `truncate` calls, K2 launches in steps whose ``run_batch``
    carried a tree, the drafter's host time, and the host time of steps
    that verified drafts (each ends in a device→host copy)."""
    rids = [eng.submit(p, 32) for p in prompts]
    sched = eng._scheduler
    seen = dict(truncates=0, tree_steps=0, tree_k2=0, draft_s=[])
    truncate, run, draft = sched.pager.truncate, sched._run_batch, \
        sched._draft_fn

    def counted_truncate(*a):
        seen["truncates"] += 1
        return truncate(*a)

    def watched_run(*a, **kw):
        before = COUNTERS["paged_attention_chunk"].count
        res = run(*a, **kw)
        if kw.get("tree") is not None:
            seen["tree_steps"] += 1
            seen["tree_k2"] += COUNTERS["paged_attention_chunk"].count - before
        return res

    def timed_draft(reqs):
        t = time.perf_counter()
        res = draft(reqs)
        seen["draft_s"].append(time.perf_counter() - t)
        return res

    sched.pager.truncate, sched._run_batch = counted_truncate, watched_run
    if draft is not None:
        sched._draft_fn = timed_draft
    verify_s, verify_steps = 0.0, 0
    decode_s, decode_tokens, decode_steps, steps = 0.0, 0, 0, 0
    t0 = time.perf_counter()
    while not eng.idle:
        rows, prefilled = sched.stats.spec_rows, sched.stats.prefill_tokens
        ts = time.perf_counter()
        events = eng.step()                 # ends in a device→host copy
        dt = time.perf_counter() - ts
        steps += 1
        if sched.stats.spec_rows > rows:
            verify_s += dt
            verify_steps += 1
        if sched.stats.prefill_tokens == prefilled:
            decode_s += dt
            decode_tokens += len(events)
            decode_steps += 1
    out = eng.drain()
    draft_s = seen.pop("draft_s")
    return dict(rids=rids, out=out, serve_s=time.perf_counter() - t0,
                steps=steps, **seen,
                decode_tokens_per_s=decode_tokens / decode_s,
                decode_step_ms=1e3 * decode_s / max(1, decode_steps),
                verify_steps=verify_steps,
                verify_step_ms=1e3 * verify_s / max(1, verify_steps),
                draft_calls=len(draft_s),
                draft_ms_per_step=1e3 * sum(draft_s) / max(1, len(draft_s)))


def _spec_phase(label, model, params, refs, names=("all_kernel", "default"),
                **engine_kw) -> dict:
    """The speculation traffic on a speculating serve engine: with every
    quantized linear on K1 / K3 (streams gated equal to ``refs``, the
    engine without speculation) and, where ``names`` asks, under the
    default hybrid threshold (compared and reported). Gates: drafts
    proposed and verified, every rollback one `truncate`, K1–K3 launched
    (and K4 for a draft model), nothing left in use."""
    prompts = spec_prompts(model.cfg.vocab_size)
    draft = engine_kw.get("draft_model") is not None
    runs = {}
    for name in names:
        ecfg = ALL_KERNEL if name == "all_kernel" else qlinear.ExecutionConfig()
        eng = GenerationEngine(model, params, **SERVE_KW, spec_k=SPEC_K,
                               **engine_kw)
        _reset_peak()
        # this path: counts start at 0 here and are read right after
        reset_counts()
        with qlinear.execution_config(ecfg):
            run = _spec_serve(eng, prompts)
        launches = read_counts()
        out, rids = run.pop("out"), run.pop("rids")
        check_streams(f"{label} {name}", out, rids, model.cfg.vocab_size)
        diffs = _first_diffs([out[r] for r in rids], refs[name])
        if name == "all_kernel" and any(d is not None for d in diffs):
            raise AssertionError(f"{label} {name}: streams differ from the "
                                 f"engine without speculation at {diffs}")
        st = eng.stats()
        need = SLO_NAMES + (("flash_attention",) if draft else ())
        if not (st.draft_tokens > 0 and eng.scheduler_stats.spec_rows > 0
                and run["truncates"] == st.rollbacks
                and min(launches[n] for n in need) > 0
                and st.pager.pages_used == 0):
            raise AssertionError(
                f"{label} {name}: draft tokens {st.draft_tokens}, verify "
                f"rows {eng.scheduler_stats.spec_rows}, rollbacks "
                f"{st.rollbacks} vs truncates {run['truncates']}, launches "
                f"{launches}, pages in use {st.pager.pages_used}")
        runs[name] = dict(
            **run, identical_streams=sum(d is None for d in diffs),
            first_diff=diffs, launches=launches, tree_moves=eng.tree_moves,
            spec_rows=eng.scheduler_stats.spec_rows,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            **{k: getattr(st, k) for k in (
                "draft_tokens", "accepted_tokens", "acceptance_rate",
                "spec_tokens_per_row", "rollbacks", "spec_k_now",
                "spec_fanout_now", "dispatches", "weight_bytes_per_token")})
    return dict(requests=len(prompts), spec_k=SPEC_K, **runs)


def spec_ngram(model, params, refs) -> dict:
    """Adaptive n-gram (prompt-lookup) speculation on the serve engine."""
    return _spec_phase("spec_ngram", model, params, refs,
                       spec_decode="ngram", spec_adaptive=True)


def _alternate_drafter(ref_streams, prompts, vocab: int):
    """A tree draft_fn whose chain starts off the target's greedy stream
    and whose last node, a depth-1 alternate, is on it: every verify
    accepts that alternate, whose KV `_tree_compact` must move."""
    def draft(reqs):
        out = {}
        for slot, rid, ctx, _q, k, _f in reqs:
            good = int(ref_streams[rid][len(ctx) - len(prompts[rid])])
            nodes = [((good + 1) % vocab, -1)] + [
                ((good + 2 + i) % vocab, i) for i in range(k - 2)]
            out[slot] = nodes + [(good, -1)] if k > 1 else nodes
        return out
    return draft


def spec_tree(model, params, refs) -> dict:
    """Tree speculation (n-gram trees, root fanout 2) over int8 pools,
    then a drafter whose accepted node is always an alternate. Gates: a
    tree verify step ran and each launched K2 (with its ancestor mask)
    once a layer; `_tree_compact` moved KV; streams equal."""
    res = _spec_phase("spec_tree", model, params, refs, spec_decode="ngram",
                      spec_tree=True, spec_tree_fanout=2)
    prompts = spec_prompts(model.cfg.vocab_size)
    forced = _spec_phase("spec_tree", model, params, refs,
                         names=("all_kernel",), spec_decode="draft_model",
                         spec_tree=True, draft_fn=_alternate_drafter(
                             refs["all_kernel"], prompts,
                             model.cfg.vocab_size))["all_kernel"]
    for name, run in (("ngram all_kernel", res["all_kernel"]),
                      ("ngram default", res["default"]),
                      ("alternate", forced)):
        layers = model.cfg.num_layers
        if run["tree_steps"] and run["tree_k2"] != layers * run["tree_steps"]:
            raise AssertionError(f"spec_tree {name}: {run['tree_k2']} K2 "
                                 f"launches in {run['tree_steps']} tree "
                                 f"steps, want {layers} a step")
    if not (res["all_kernel"]["tree_steps"] > 0 and forced["tree_steps"] > 0
            and forced["tree_moves"] == forced["accepted_tokens"] > 0):
        raise AssertionError(
            f"spec_tree: tree steps {res['all_kernel']['tree_steps']} / "
            f"{forced['tree_steps']}, KV moves {forced['tree_moves']} for "
            f"{forced['accepted_tokens']} accepted alternates")
    return dict(res, alternate=forced)


def spec_draft(model, params, refs) -> dict:
    """Draft-model speculation with the served model as its own draft
    (the repo has no smaller Qwen2.5): each step runs ``spec_k + 1``
    dense decode steps of the draft, and each new slot's dense prefill
    (K4) at its bucketed length."""
    return _spec_phase("spec_draft", model, params, refs,
                       names=("all_kernel",), spec_decode="draft_model",
                       draft_model=model, draft_params=params)


# each kernel's CUDA kernels in a profile, by name (K1 and K3 share their
# templates and differ in the output functor; K2 and K4 run two kernels
# each); "copy" is PyTorch's copy kernels (dtype casts among them),
# "reduce" its reductions (RMSNorm's staged means among them)
KERNEL_NAMES = {"awq_matmul": ("LinearOut",),
                "awq_gateup": ("GluOut",),
                "paged_attention_chunk": ("paged_partial", "paged_merge"),
                "flash_attention": ("flash_mma", "flash_f32"),
                "flash_attention_bwd": ("dq_mma_kernel", "dkdv_mma_kernel",
                                        "delta_kernel", "dkdv_kernel",
                                        "dq_kernel"),
                "copy": ("copy_kernel",),
                "reduce": ("reduce_kernel",)}


# steps a serving profile runs bare, then profiled (6 before the
# tp_families phase came: cut for the script's time limit on a slow host)
PROFILE_STEPS = 3


def _profile_steps(eng, steps: int, before=lambda: None,
                   host_ops: bool = True) -> dict:
    """``steps`` engine steps timed bare, then as many again under
    torch.profiler for the device's busy time and its top kernels;
    ``before()`` sets up each window. ``host_ops=False`` traces the
    device's kernels only (a mesh train step's host ops are too many to
    trace within the time limit)."""
    before()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    bare_ms = 1e3 * (time.perf_counter() - t0) / steps
    before()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA] + (
        [torch.profiler.ProfilerActivity.CPU] if host_ops else []))
    with prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / steps
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    by_kernel = {}
    for group, marks in KERNEL_NAMES.items():
        mine = [e for e in kern if any(mk in e.key for mk in marks)]
        by_kernel[group] = dict(
            ms=sum(e.self_device_time_total for e in mine) / 1e3 / steps,
            launches=sum(e.count for e in mine) / steps)
    return dict(steps=steps, step_ms=bare_ms,
                profiled_step_ms=prof_ms, device_busy_ms=busy_ms,
                device_launches=sum(e.count for e in kern) / steps,
                device_idle_share=1 - busy_ms / prof_ms, by_kernel=by_kernel,
                top_kernels=[dict(name=e.key[:90], count=e.count / steps,
                                  ms=e.self_device_time_total / 1e3 / steps)
                             for e in top[:10]])


def profile(model, params, steps: int = PROFILE_STEPS) -> dict:
    """Where a step's time goes. Decode: 4 slots decoding at contexts
    ~100–112 (no prefill), on the chunked path and then on the one-shot
    path (`decode_step` over the same pages, the same four prompts).
    Chunk: a step of 4 rows of 16 prompt tokens
    (the scheduler packs one long prompt's chunks into every free row),
    at contexts 64–448 of a 448-token prompt, a fresh prompt for the bare
    and the profiled window; every K2 launch there reads a C = 16 chunk."""
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, prefill_chunk=16, kv_quant="int8")
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.cfg.vocab_size, 100).astype(np.int32)
               for _ in range(4)]
    for p in prompts:
        eng.submit(p, 64)
    while eng.stats().prefill_tokens < 400:     # land every prompt
        eng.step()
    eng.step()
    dec = dict(slots=4, context=100, **_profile_steps(eng, steps))
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, kv_quant="int8",
                           chunked_prefill=False)
    for p in prompts:
        eng.submit(p, 64)
    eng.step()                                  # admits all four, decodes
    eng.step()
    oneshot = dict(slots=4, context=101, **_profile_steps(eng, steps))
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, prefill_chunk=16, kv_quant="int8")
    plen = 64 * (steps + 1)

    def new_prompt():                 # its first 64 tokens land unprofiled
        if not eng.idle:
            raise AssertionError("profile: the last prompt did not finish")
        eng.submit(rng.integers(0, model.cfg.vocab_size, plen)
                   .astype(np.int32), 1)
        eng.step()

    chunk = dict(rows=4, chunk=16, contexts=[64, plen],
                 **_profile_steps(eng, steps, before=new_prompt))
    if eng.stats().prefill_tokens != 2 * plen or not eng.idle:
        raise AssertionError("profile: the chunk steps did not each land "
                             "4 rows of 16 prompt tokens")
    return dict(dec, oneshot_decode_step=oneshot, chunk_step=chunk,
                verify_step=_profile_verify(model, params, prompts, steps))


def _profile_verify(model, params, prompts, steps: int) -> dict:
    """Verify steps of 4 rows × (1 + SPEC_K) tokens at contexts ~105–170,
    each row drafting the decode prompts' own greedy continuation (the
    engine without speculation's stream: the drafter every row accepts,
    so every profiled step verifies 4 full runs)."""
    new = (2 * steps + 4) * (SPEC_K + 1) + 8
    plain = GenerationEngine(model, params, **SERVE_KW)
    rids = [plain.submit(p, new) for p in prompts]
    got = plain.drain()
    oracle = [got[r] for r in rids]

    def draft(reqs):                  # none until all four decode
        return {slot: [int(t) for t in oracle[rid][len(ctx) - 100:][:k]]
                for slot, rid, ctx, _q, k in reqs} if len(reqs) == 4 else {}

    eng = GenerationEngine(model, params, **SERVE_KW, spec_k=SPEC_K,
                           spec_decode="draft_model", draft_fn=draft)
    for p in prompts:
        eng.submit(p, new)
    while eng.stats().prefill_tokens < 400:     # land every prompt
        eng.step()
    eng.step()
    st0 = eng.scheduler_stats
    rows0, acc0 = st0.spec_rows, st0.accepted_tokens
    res = _profile_steps(eng, steps)
    rows = eng.scheduler_stats.spec_rows - rows0
    acc = eng.scheduler_stats.accepted_tokens - acc0
    if rows != 2 * steps * 4:
        raise AssertionError(f"profile: {rows} verify rows in "
                             f"{2 * steps} steps, want 4 a step")
    return dict(slots=4, spec_k=SPEC_K, context=101,
                drafter="the plain engine's greedy stream",
                tokens_per_verify_row=(acc + rows) / rows, **res)


# ----------------------------------------------------------------- phase 15
def tree_to(tree, device):
    if isinstance(tree, PackedLinear):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


class RouteTie:
    """The card's MoE routing, recorded while the card's side of a CPU
    check runs (``record``), then imposed on the CPU's side (``force``;
    `tp_moe` also imposes the unsharded forward's on the sharded one).

    A MoE layer's top-k is discrete: where two experts' probabilities lie
    closer than the card's and the CPU's roundings move them, the two
    sides route a token to different experts, and its row then leaves the
    other side's by far more than any rounding (a whole expert's output).
    So the CPU side takes the card's expert ids (its gates read from its
    own probabilities at those ids) and the logits are held as for a
    dense model; every token whose top-k set the CPU would have chosen
    otherwise is counted, with the CPU's gap between its k-th and
    (k+1)-th probability there and the largest difference between the
    two sides' probabilities of that token (a flip needs gap <= 2x it)."""

    def __init__(self):
        self.routes, self.flips, self.calls = [], [], 0

    @contextlib.contextmanager
    def record(self):
        plain = moe.route

        def route(probs, cfg, cap):
            out = plain(probs, cfg, cap)
            self.routes.append((out[0].cpu(), probs.detach().float().cpu()))
            return out

        moe.route = route
        try:
            yield
        finally:
            moe.route = plain

    @contextlib.contextmanager
    def force(self):
        plain = moe.route

        def route(probs, cfg, cap):
            idx, card_probs = self.routes[self.calls]
            idx = idx.to(probs.device)
            self.calls += 1
            own = torch.topk(probs, cfg.top_k, dim=-1)
            differ = (own.indices.sort(-1).values
                      != idx.sort(-1).values).any(-1)
            for t in differ.nonzero()[:, 0].tolist():
                top = torch.topk(probs[t].detach(), cfg.top_k + 1).values
                self.flips.append(dict(
                    call=self.calls - 1, token=t,
                    gap=float(top[-2] - top[-1]),
                    probs_diff=float((probs[t].detach().float().cpu()
                                      - card_probs[t]).abs().max())))
            gates = torch.gather(probs, 1, idx)
            if cfg.norm_topk_prob:
                gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                            min=1e-9)
            return (idx, gates,
                    *moe.assign_slots(idx, cfg.num_experts, cap))

        moe.route = route
        try:
            yield
        finally:
            moe.route = plain

    def report(self) -> dict:
        if self.calls != len(self.routes):
            raise AssertionError(f"routing: the CPU routed {self.calls} "
                                 f"times, the card {len(self.routes)}")
        if any(f["gap"] > 2 * f["probs_diff"] for f in self.flips):
            raise AssertionError(f"routing: a flip past the two sides' "
                                 f"difference: {self.flips}")
        return dict(routed_calls=self.calls,
                    tokens=sum(int(i.shape[0]) for i, _ in self.routes),
                    flips=self.flips)


def _device_side(tie: RouteTie, d: str):
    """The routing context of one side of a card-vs-CPU check: the card's
    side (first) records, the CPU's follows it."""
    return tie.record() if d == "cuda" else tie.force()


def _check_inputs(vocab: int) -> list:
    """The `check` phase's two unified steps: (tokens, positions, sample
    indices) of a prefill chunk (C 16, one row padded from 10) and of a
    decode step (C 1), over page table rows 1-16."""
    rng = np.random.default_rng(SEED + 1)
    toks_a = torch.from_numpy(rng.integers(0, vocab, (4, 16))
                              .astype(np.int32))
    pos_a = torch.arange(16, dtype=torch.int32)[None].repeat(4, 1)
    pos_a[3, 10:] = -1
    sidx_a = torch.tensor([15, 15, 15, 9], dtype=torch.int32)
    toks_b = torch.from_numpy(rng.integers(0, vocab, (4, 1))
                              .astype(np.int32))
    pos_b = torch.tensor([[16], [16], [16], [10]], dtype=torch.int32)
    sidx_b = torch.zeros(4, dtype=torch.int32)
    return [(toks_a, pos_a, sidx_a), (toks_b, pos_b, sidx_b)]


CHECK_TABLE = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)


def _check_rule(step: int, got: torch.Tensor, ref: torch.Tensor,
                label: str = "cross-check") -> dict:
    """Logits within 5 % of the CPU's largest magnitude, and the argmax
    equal on every row whose top-2 margin clears twice that."""
    err = float((got - ref).abs().max())
    tol = 0.05 * float(ref.abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    agree = (got.argmax(-1) == ref.argmax(-1))
    if not err <= tol or not bool(agree[clear].all()):
        raise AssertionError(f"{label} step {step}: err {err} > {tol} or "
                             f"argmax differs on clear rows")
    return dict(max_abs_err=err, tol=tol, clear_rows=int(clear.sum()),
                argmax_agree=int(agree.sum()))


def cross_check(model, params, cpu_logits: list | None = None,
                cpu_params=None) -> dict:
    """One prefill chunk (C=16) and one decode step (C=1) of the unified
    chunk step on the card vs CPU copies (plain versions). bf16
    activations round differently once K2 dequantizes K/V in f32 (card)
    instead of to bf16 (CPU gather path), so logits are held at 5% of
    their largest magnitude, and the argmax must agree on rows whose
    top-2 margin clears that tolerance. A MoE model's CPU side takes the
    card's routing (`RouteTie`). The CPU's logits of each step are
    appended to ``cpu_logits`` where it is given (the `tp` phase holds
    its sharded steps to them). ``cpu_params``: the CPU copy, if made."""
    if cpu_params is None:
        cpu_params = tree_to(params, "cpu")
    pools = {d: model.init_paged_cache(17, 16, kv_quant="int8", device=d)
             for d in ("cuda", "cpu")}
    prm = {"cuda": params, "cpu": cpu_params}
    res = {}
    for step, (toks, pos, sidx) in enumerate(
            _check_inputs(model.cfg.vocab_size)):
        if step == 1:      # both sides read the card's committed pages
            pools["cpu"] = tree_to(pools["cuda"], "cpu")
        logits, tie = {}, RouteTie()
        for d in ("cuda", "cpu"):
            with torch.no_grad(), _device_side(tie, d):
                lg, pools[d] = model.chunk_step(
                    prm[d], pools[d], toks.to(d), pos.to(d), sidx.to(d),
                    page_table=CHECK_TABLE.to(d))
            logits[d] = lg.float().cpu()
        res[f"step{step}"] = _check_rule(step, logits["cuda"],
                                         logits["cpu"])
        if cpu_logits is not None:
            cpu_logits.append(logits["cpu"])
        if model.cfg.num_experts:
            res[f"step{step}"]["routing"] = tie.report()
    return res


# ------------------------------------------------------------- phase tp
def _tp_check(model, params, cpu_logits) -> dict:
    """The `check` phase's two chunk steps on the card under the 2-way
    mesh (their own pools, striped), held to the `check` phase's CPU
    logits by the same rule; K2-TP must launch once a layer a step."""
    mesh = tp_mesh()
    shards = shard_params(params, mesh, model.cfg)
    pools = model.init_paged_cache(17, 16, kv_quant="int8", mesh=mesh)
    res = {}
    for step, (toks, pos, sidx) in enumerate(
            _check_inputs(model.cfg.vocab_size)):
        before = k2.TP_COUNTER.count
        with torch.no_grad():
            lg, pools = model.chunk_step(
                shards, pools, toks.cuda(), pos.cuda(), sidx.cuda(),
                page_table=CHECK_TABLE.cuda(), mesh=mesh)
        res[f"step{step}"] = _check_rule(step, lg.float().cpu(),
                                         cpu_logits[step], "tp check")
        launched = k2.TP_COUNTER.count - before
        if launched != model.cfg.num_layers:
            raise AssertionError(f"tp check step {step}: K2-TP launched "
                                 f"{launched} times, want one a layer")
    return res


def _tp_preempt(model, params, prompts) -> dict:
    """A spill → restore round trip on the 2-way mesh: the four longest
    serve prompts (8 new tokens) on a preempting engine, the last one
    still on a slot preempted by hand once a first token is out. Gated: the spilled strips are the shards'
    KV-head pieces joined, in pinned host memory, and the restored pages
    equal them bit for bit; one restore, no page left in use."""
    eng = GenerationEngine(model, params, mesh=tp_mesh(), preemption=True,
                           **SERVE_KW)
    longest = [prompts[i] for i in SLO_LONG]
    rids = [eng.submit(p, 8) for p in longest]
    sched = eng._scheduler
    spill, restore = sched._spill_fn, sched._restore_fn
    seen = {"spills": 0, "restores": 0, "bytes": 0}

    def joined(ids):
        ids = torch.as_tensor(ids, device="cuda")
        return {seg: {leaf: torch.cat(
                    [torch.stack([e["kv_pool"][leaf][ids] for e in c[seg]])
                     for c in eng._paged_cache],
                    dim=-2 if leaf in ("k", "v") else -1).cpu()
                      for leaf in c0[0]["kv_pool"]}
                for seg, c0 in eng._paged_cache[0].items()}

    def watched_spill(ids):
        want = joined(ids)
        handle = spill(ids)
        if handle["event"] is not None:
            handle["event"].synchronize()
        for seg, leaves in want.items():
            for leaf, t in leaves.items():
                got = handle["strips"][seg][leaf]
                if not got.is_pinned() or not torch.equal(got, t):
                    raise AssertionError(f"tp preempt: strip {seg}/{leaf} "
                                         f"is not the shards' pieces "
                                         f"joined in pinned memory")
                seen["bytes"] += got.numel() * got.element_size()
        seen["spills"] += 1
        return handle

    def watched_restore(handle, fresh):
        restore(handle, fresh)
        got = joined(fresh)
        for seg, leaves in handle["strips"].items():
            for leaf, t in leaves.items():
                if not torch.equal(got[seg][leaf], t):
                    raise AssertionError(f"tp preempt: restored {seg}/"
                                         f"{leaf} differs from its strip")
        seen["restores"] += 1

    sched._spill_fn, sched._restore_fn = watched_spill, watched_restore
    while not eng.step():               # until a first token is out
        pass
    if not any(eng.preempt(r) for r in reversed(rids)):
        raise AssertionError("tp preempt: no request held a slot")
    out = eng.drain()
    check_streams("tp preempt", out, rids, model.cfg.vocab_size, n=8)
    st = eng.stats()
    if (seen["spills"], seen["restores"], st.restores) != (1, 1, 1) \
            or st.pager.pages_used or st.spilled_pages != st.restored_pages:
        raise AssertionError(f"tp preempt: {seen}, restores {st.restores}, "
                             f"pages in use {st.pager.pages_used}")
    return dict(spills=seen["spills"], restores=st.restores,
                spilled_pages=st.spilled_pages, spilled_bytes=seen["bytes"],
                restore_ms_mean=st.restore_ms_mean, round_trip_exact=True)


def _tp_disagg(model, params, prompts, want_wire: int, refs) -> dict:
    """The `disagg` phase's traffic with its prefill side on the 2-way
    mesh and its decode side unsharded, every quantized linear on K1 /
    K3: the handoffs' wire bytes must equal the unsharded pair's (the
    strips leave the mesh whole), no page may stay in use; streams equal
    to the unified engine's are counted."""
    with qlinear.execution_config(ALL_KERNEL):
        ctrl = DisaggController(model, params, prefill_mesh=tp_mesh(),
                                handoff_min_tokens=DISAGG_MIN_TOKENS,
                                **SERVE_KW)
        before = read_counts(TP_COUNTERS)
        crids = [ctrl.submit(p, 32) for p in prompts]
        got = ctrl.drain()
        launched = read_counts(TP_COUNTERS)
    check_streams("tp disagg", got, crids, model.cfg.vocab_size)
    st = ctrl.stats()
    in_use = [e.engine._scheduler.pager.pages_in_use
              for e in (ctrl.prefill, ctrl.decode)]
    if st.wire_bytes != want_wire or in_use != [0, 0]:
        raise AssertionError(f"tp disagg: wire bytes {st.wire_bytes}, the "
                             f"unsharded pair's {want_wire}; pages in use "
                             f"{in_use}")
    diffs = _first_diffs([got[r] for r in crids], refs)
    return dict(prefill_model_axis=ctrl.prefill.stats().model_axis,
                decode_model_axis=ctrl.decode.stats().model_axis,
                handoffs=st.handoffs, direct=st.direct,
                wire_bytes=st.wire_bytes, unsharded_wire_bytes=want_wire,
                identical_streams=sum(d is None for d in diffs),
                first_diffs=diffs,
                launches={n: launched[n] - before[n] for n in TP_COUNTERS})


def tp(model, params, served: dict, unified_refs, cpu_logits, prof,
       want_wire: int) -> dict:
    """Tensor-parallel serving on one card: Qwen2.5-0.5B at full size,
    RTN int4, int8 pages of 16, 4 slots, the serve phase's 8 prompts (32
    new each) through `GenerationEngine(mesh=...)` over a 2-way mesh whose
    two shards share cuda:0 (`serving_mesh(2, devices=[cuda:0, cuda:0])`:
    the card cannot show a speedup from tensor parallelism, only the
    function, K2-TP's launches and the per-shard bytes). Gated: K2-TP
    launched, per-shard pool bytes half the unsharded engine's, first
    tokens equal to the serve phase's where generate()'s margin is clear
    (the `check` rule), the `check` phase's steps within its rule, a
    spill → restore round trip bit-exact, a mesh-2 → mesh-1 handoff whose
    wire bytes are the unsharded pair's, no page left in use. Counted:
    streams equal to the unsharded engine's under the default threshold
    and with every quantized linear on K1 / K3 (row-parallel sums change
    the bf16 function, as in the reference). Profiled: a decode step of
    4 slots, beside the unsharded one of the `profile` phase."""
    mesh = tp_mesh()
    prompts = serve_prompts(model.cfg.vocab_size)
    names = SLO_NAMES + tuple(TP_COUNTERS)
    runs = {}
    for name, ecfg, refs in (
            ("default", qlinear.ExecutionConfig(), served["streams"]),
            ("all_kernel", ALL_KERNEL, unified_refs)):
        eng = GenerationEngine(model, params, mesh=mesh, **SERVE_KW)
        with qlinear.execution_config(ecfg):
            _reset_peak()
            # the main path: counts start at 0 here and are read right after
            reset_counts()
            run = _serve_burst(eng, prompts, names)
        check_streams(f"tp {name}", run["out"], run["rids"],
                      model.cfg.vocab_size)
        streams = [run["out"][r] for r in run["rids"]]
        st = eng.stats()
        if min(run["launches"].values()) <= 0 or st.pager.pages_used:
            raise AssertionError(f"tp {name}: a kernel never ran "
                                 f"({run['launches']}) or pages stay in "
                                 f"use ({st.pager.pages_used})")
        if (st.model_axis, st.kv_pool_bytes) != (2, served["kv_pool_bytes"]) \
                or 2 * st.kv_pool_bytes_per_device != st.kv_pool_bytes:
            raise AssertionError(f"tp {name}: pool bytes {st.kv_pool_bytes} "
                                 f"/ {st.kv_pool_bytes_per_device} a shard, "
                                 f"unsharded {served['kv_pool_bytes']}")
        first_ties = []
        for rid, p, got, ref in zip(run["rids"], prompts, streams, refs):
            if got[0] != ref[0]:
                margin, scale = _first_margin(model, params, p, 512)
                if margin > 2 * 0.05 * scale:
                    raise AssertionError(
                        f"tp {name}: request {rid}: first token {got[0]} "
                        f"!= the unsharded engine's {ref[0]}, margin "
                        f"{margin} of scale {scale}")
                first_ties.append(dict(request=rid, margin=margin,
                                       scale=scale))
        diffs = _first_diffs(streams, refs)
        runs[name] = dict(
            serve_s=run["serve_s"], steps=run["steps"],
            decode_steps=run["decode_steps"],
            decode_tokens_per_s=run["decode_tokens"] / run["decode_s"],
            decode_step_ms=1e3 * run["decode_s"]
            / max(1, run["decode_steps"]),
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            launches=run["launches"],
            launches_per_decode_step={
                n: v / max(1, run["decode_steps"])
                for n, v in run["decode_launches"].items()},
            identical_streams=sum(d is None for d in diffs),
            first_diffs=diffs, first_token_ties=first_ties,
            kv_pool_bytes=st.kv_pool_bytes,
            kv_pool_bytes_per_device=st.kv_pool_bytes_per_device)
        del eng
    checked = _tp_check(model, params, cpu_logits)
    preempted = _tp_preempt(model, params, prompts)
    handed = _tp_disagg(model, params, prompts, want_wire, unified_refs)
    eng = GenerationEngine(model, params, mesh=mesh, **SERVE_KW)
    rng = np.random.default_rng(SEED + 2)
    for p in [rng.integers(0, model.cfg.vocab_size, 100).astype(np.int32)
              for _ in range(4)]:
        eng.submit(p, 64)
    while eng.stats().prefill_tokens < 400:     # land every prompt
        eng.step()
    eng.step()
    profiled = dict(slots=4, context=100, **_profile_steps(eng,
                                                           PROFILE_STEPS))
    del eng
    gc.collect()
    return dict(
        mesh="2-way model axis, both shards on cuda:0", **runs,
        check=checked, preempt=preempted, disagg=handed,
        profile_decode_step=profiled,
        profile_decode_step_unsharded={k: prof[k] for k in (
            "step_ms", "profiled_step_ms", "device_busy_ms",
            "device_idle_share", "device_launches", "by_kernel")})


# ----------------------------------------------------------------- phase 16
LAUNCH_ARGS = ["--arch", "qwen25-05b", "--quant", "awq", "--batch", "4",
               "--prompt-len", "256", "--max-new", "32"]


def launch() -> tuple[dict, dict]:
    """The launcher's AWQ path at full width; returns (phase fields, the
    served AWQ params)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launcher's path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    out = launcher.main(LAUNCH_ARGS)
    total_s = time.perf_counter() - t0
    totals = read_counts()
    rep, by_step = out["report"], out["launches"]
    toks = out["tokens"]
    if out["shape"] != [4, 32] or not ((toks >= 0) & (toks < 151936)).all():
        raise AssertionError(f"launch: bad tokens {out['shape']}")
    if not len(rep.calibrated) == len(rep.quantized) == 168:
        raise AssertionError(f"launch: {len(rep.calibrated)} of "
                             f"{len(rep.quantized)} linears calibrated, "
                             f"want all 168")
    if not (by_step["calibrate"]["flash_attention"] >= 24
            and by_step["generate"]["flash_attention"] >= 24
            and by_step["generate"]["awq_matmul"] > 0
            and by_step["generate"]["awq_gateup"] > 0):
        raise AssertionError(f"launch: a kernel of the path never ran: "
                             f"{by_step}")
    macro = check_awq_macro(out["params"], rep)
    fields = dict(
        args=" ".join(LAUNCH_ARGS), total_s=total_s, awq_macro=macro,
        calibrate_s=out["calib_s"], awq_s=out["awq_s"],
        quantized=len(rep.quantized), calibrated=len(rep.calibrated),
        skipped=len(rep.skipped), compression_ratio=rep.compression_ratio,
        fp16_bytes=out["fp16_bytes"], awq_macro_bytes=out["macro_bytes"],
        generate_s=out["generate_s"], tokens_per_s=out["tokens_per_s"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=totals, launches_by_step=by_step,
        sample=toks[0][:8].tolist())
    return fields, out["params"]


def _packed_linears(tree):
    if isinstance(tree, PackedLinear):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _packed_linears(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _packed_linears(v)


def check_awq_macro(params, report) -> dict:
    """Serialize every AWQ-packed linear into the paper's AWQ_MACRO bytes:
    their total must equal the report's size from shapes, and one linear
    of each (K, N) pair must parse back to its codes, fp16 scales and
    zeros bit for bit."""
    t = time.perf_counter()
    linears = list(_packed_linears(params))
    blobs = [packed_linear_macro_bytes(p) for p in linears]
    seconds = time.perf_counter() - t
    total = sum(len(b) for b in blobs)
    if len(linears) != 168 or total != report.packed_bytes:
        raise AssertionError(f"awq_macro: {len(linears)} linears, {total} B; "
                             f"want 168 and {report.packed_bytes} B")
    round_trips = {}
    for p, blob in zip(linears, blobs):
        if (p.k, p.n) in round_trips:
            continue
        q, sc, z = parse_awq_macro_bytes(blob, p.k, p.n, p.group_size)
        ok = (np.array_equal(q, unpack_int4(p.qweight).cpu().numpy())
              and np.array_equal(sc.view(np.uint16), p.scales.cpu().numpy()
                                 .astype(np.float16).view(np.uint16))
              and np.array_equal(z, p.zeros.cpu().numpy()))
        if not ok:
            raise AssertionError(f"awq_macro: [{p.k},{p.n}] does not round "
                                 f"trip")
        round_trips[(p.k, p.n)] = len(blob)
    return dict(linears=len(linears), bytes=total,
                report_packed_bytes=report.packed_bytes, seconds=seconds,
                round_trips={f"{k}x{n}": b for (k, n), b in
                             round_trips.items()})


# ----------------------------------------------------------------- phase 17
def _check_batch(cfg, rng, b: int, s: int) -> dict:
    """A seeded CPU batch of ``b`` sequences of ``s`` positions: tokens
    (drawn first), for a vision model then its stub patch embeddings
    (``num_patches`` of them, prepended by the model: the sequence holds
    ``num_patches + s`` positions); for an encoder stub frame features
    in place of the tokens."""
    if cfg.frontend == "audio":
        return {"features": torch.from_numpy(rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32))}
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))}
    if cfg.frontend == "vision":
        batch["images"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32))
    return batch


def check_prefill(model, params, cpu_params=None) -> dict:
    """One full-sequence prefill (B 1, S 64; a vision model's 256 image
    patches before the 64 tokens; an encoder's 64 frames) on the
    launcher's AWQ-packed weights, on the card (K4 attention, K1
    projections) and on CPU copies (plain versions). The bf16 activations
    round differently once the sums run in another order, and the
    differences grow over the layers, so the last position's logits (an
    encoder's at every frame) are held at 5% of their largest magnitude,
    as `cross_check` holds a chunk step, and the argmax must agree where
    the top-2 margin clears that tolerance. A MoE model's CPU side takes
    the card's routing (`RouteTie`). ``cpu_params``: the CPU copy, if
    made."""
    rng = np.random.default_rng(SEED + 3)
    cfg = model.cfg
    batch = _check_batch(cfg, rng, 1, 64)
    n_pos = 64 + (cfg.num_patches if "images" in batch else 0)
    prm = {"cuda": params, "cpu": tree_to(params, "cpu")
           if cpu_params is None else cpu_params}
    before = k4.COUNTER.count
    logits, tie = {}, RouteTie()
    for d in ("cuda", "cpu"):
        with torch.no_grad(), _device_side(tie, d):
            cache = model.init_cache(1, n_pos, device=d)
            _, lg, _ = model.prefill(
                prm[d], {k: v.to(d) for k, v in batch.items()}, cache)
        logits[d] = lg.float().cpu().reshape(-1, lg.shape[-1])
    ref, got = logits["cpu"], logits["cuda"]
    err = float((got - ref).abs().max())
    tol = 0.05 * float(ref.abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    agree = got.argmax(-1) == ref.argmax(-1)
    if not err <= tol or not bool(agree[clear].all()):
        raise AssertionError(f"check_prefill: err {err} > {tol} or argmax "
                             f"differs on a clear row")
    if k4.COUNTER.count - before != _k4_layers(cfg):
        raise AssertionError("check_prefill: the card's prefill did not run "
                             "K4 once per attention layer")
    out = dict(max_abs_err=err, tol=tol, argmax_agree=bool(agree.all()),
               margin_clear=bool(clear.all()),
               **({"routing": tie.report()} if cfg.num_experts else {}))
    if cfg.is_encoder:          # every frame's logits: report them all
        out.update(frames=int(agree.numel()),
                   frames_argmax_agree=int(agree.sum()),
                   frames_margin_clear=int(clear.sum()))
    if "images" in batch:
        out["positions"] = n_pos
    return out


# ----------------------------------------------------------------- phase 18
FLEET_ARGS = ["--arch", "qwen25-05b", "--quant", "awq", "--replicas", "2",
              "--mesh-axis", "1", "--batch", "4", "--prompt-len", "256",
              "--max-new", "32"]
# the fleet's placement integers: a function of the schedule alone (not
# of widths or token values), so `repro.launch.serve` with these flags
# and ``--smoke`` prints them; tests/test_torch_launch.py and
# tests/test_torch_disagg.py hold the reference and the port to them
FLEET_WANT = {
    False: dict(placements=6, affinity_hits=4, session_hits=4,
                prefill_tokens_skipped=1984),
    True: dict(placements=6, affinity_hits=4, session_hits=4,
               prefill_tokens_skipped=0)}


def fleet(disagg: bool = False, unified_streams=None) -> dict:
    """The launcher's fleet path at full width (`SERVE_LAYERS` of Qwen's
    depth): AWQ calibrate + pack, two
    paged replicas (bf16 pools) sharing the params behind the Router;
    with ``disagg`` each replica is a prefill/decode pair, and its
    streams must equal ``unified_streams``."""
    label = "fleet_disagg" if disagg else "fleet"
    args = FLEET_ARGS + (["--disagg"] if disagg else [])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the fleet path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    with _depth("qwen25-05b", SERVE_LAYERS):
        out = launcher.main(args)
    total_s = time.perf_counter() - t0
    totals = read_counts()
    streams = out["streams"]
    if out["requests"] != 8 or len(streams) != 8:
        raise AssertionError(f"{label}: {out['requests']} requests, want 8")
    for toks in streams:
        if toks.shape != (32,) or not ((toks >= 0) & (toks < 151936)).all():
            raise AssertionError(f"{label}: bad stream {toks}")
    ints = {k: out[k] for k in FLEET_WANT[disagg]}
    if ints != FLEET_WANT[disagg]:
        raise AssertionError(f"{label}: {ints}, want the reference's "
                             f"{FLEET_WANT[disagg]}")
    fleet_launches = out["launches"]["fleet"]
    if not (fleet_launches["awq_matmul"] > 0
            and fleet_launches["awq_gateup"] > 0):
        raise AssertionError(f"{label}: a kernel of the path never ran: "
                             f"{fleet_launches}")
    res = dict(
        args=" ".join(args), total_s=total_s, fleet_s=out["fleet_s"],
        tokens_per_s=out["tokens_per_s"], requests=out["requests"],
        generated=int(sum(len(t) for t in streams)), **ints,
        calibrated=len(out["report"].calibrated),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=totals, launches_by_step=out["launches"],
        sample=streams[0][:8].tolist(), streams=streams)
    if unified_streams is not None:
        # nothing is handed off and the placements are the unified
        # fleet's, so every request meets the same steps on a decode
        # engine built as the unified replica's engine is
        diffs = _first_diffs(streams, unified_streams)
        if any(d is not None for d in diffs):
            raise AssertionError(f"{label}: streams differ from the "
                                 f"unified fleet's at {diffs}")
        res.update(identical_to_fleet=len(streams))
    return res


# ----------------------------------------------------------- phases 20-24
# The reference's other dense models at their published widths (K1 - K4 at
# their shapes, then each model's launcher, serve burst and CPU check).
# G 3 / 8 / 2 / 16 groups, hd 64 / 256 / 256 / 128; gemma3's windowed layers
# (window 1024) read through K2's window mask and decode over generate()'s
# rings; gemma's GeGLU fronts are two K1 calls (no K3), as in the reference.
DENSE_ARCHS = {
    # depth: layers run (None = all), every model at full width, its depth
    # cut for the time limit; the CPU check runs 2 of them. gemma3-4b's 6
    # of 34 keep five windowed layers and a global one (global every 6)
    "gemma3-4b": dict(layers=6, batch=2, prompt_len=1100,
                      serve_lens=[1100, 1400, 64, 300, 900, 17, 700, 200],
                      max_seq=2048, chunk=64),
    # ``oneshot_bf16``: ROADMAP Queue 3's check (`oneshot_bf16`) on the
    # four models whose engine streams parted from generate() under K1/K3.
    # smollm, gemma-2b and glm4 run 2 layers (4 before the tp_families
    # phase came: cut for the time limit on a slow host)
    "smollm-360m": dict(layers=2, batch=4, prompt_len=256,
                        serve_lens=SERVE_LENS, max_seq=512, chunk=16,
                        oneshot_bf16=True),
    "gemma-2b": dict(layers=2, batch=4, prompt_len=256,
                     serve_lens=SERVE_LENS, max_seq=512, chunk=16),
    "glm4-9b": dict(layers=2, batch=4, prompt_len=256,
                    serve_lens=SERVE_LENS, max_seq=512, chunk=16,
                    oneshot_bf16=True),
    # the MoE family: qwen2-moe (attention + MoE) on the chunked engine,
    # deepseek-v2-lite (MLA + MoE, its first layer dense) on the one-shot
    # engine; the launcher's batch of 4 x 256 tokens is 1,024, the most a
    # MoE layer takes dropless. Both run 2 layers (deepseek: its dense
    # layer and a MoE one; 4 before the tp phase came: cut for the time
    # limit)
    "qwen2-moe-a2.7b": dict(layers=2, batch=4, prompt_len=256,
                            serve_lens=SERVE_LENS, max_seq=512, chunk=16,
                            oneshot_bf16=True),
    "deepseek-v2-lite-16b": dict(layers=2, batch=4, prompt_len=256,
                                 serve_lens=SERVE_LENS, max_seq=512,
                                 chunk=16),
    # the SSM and hybrid families, both on the one-shot engine (per-slot
    # SSM state). mamba2-130m at full width, 4 of its 24 layers (6
    # before the tp_families phase came, 12 before the tp phase, 24
    # before the encoder's and the VLM's phases): the
    # launcher's 512-token prompts are two SSD chunks of 256, the
    # 1,024-token serve prompt four; attention-free, its linears take one
    # path at M 1 and 4, so every stream must equal generate()'s
    # (``streams_gated``). hymba-1.5b at full width, 2 of its 32 layers
    # (global layer 0, then a windowed one, as the published stack opens;
    # 4 before the tp_families phase came):
    # the launcher's 1,100-token prompts wrap generate()'s rings and take
    # the SSD's single-chunk fallback; the serve prompts wrap the slots'
    # rings. With the encoder's and the VLM's phases the whole script
    # took 962 s on an H100 at the depths before these cuts (gemma3 12,
    # smollm 8, gemma-2b 6, mamba2 24, hymba 8): every cut here is of
    # depth, for the time limit
    "mamba2-130m": dict(layers=4, batch=4, prompt_len=512,
                        serve_lens=[16, 200, 45, 120, 77, 190, 33, 1024],
                        max_seq=2048, chunk=16, streams_gated=True),
    "hymba-1.5b": dict(layers=2, batch=2, prompt_len=1100,
                       serve_lens=[1100, 1400, 64, 300, 1024, 17, 700, 200],
                       max_seq=2048, chunk=64, oneshot_bf16=True),
    # the encoder, at full size: the launcher (calibration over the
    # pipeline's features [2, 64, 512], AWQ and pack; no decode step),
    # then its serving output, the forward over B 2 x S 1,024 frames
    "hubert-xlarge": dict(layers=None, forward=(2, 1024)),
    # the VLM at full width, 4 of its 32 layers (8 before the tp_families
    # phase came): the launcher (calibration
    # over tokens [2, 64] and patches [2, 256, 1024]; text-only
    # generate()), generate() with images, the chunked engine over text
    "phi-3-vision-4.2b": dict(layers=4, batch=2, prompt_len=256,
                              serve_lens=SERVE_LENS, max_seq=512, chunk=16),
}
# K1 (K, N) of the new models' linears (smollm q/o, k/v, gate/up, down;
# gemma-2b q/o, k/v, gate/up, down; gemma3 q, k/v, o, gate/up, down; glm4
# q/o, k/v, down); K3 pairs of the SiLU models (smollm, glm4)
DENSE_K1 = [(960, 960), (960, 320), (960, 2560), (2560, 960),
            (2048, 2048), (2048, 256), (2048, 16384), (16384, 2048),
            (2560, 2048), (2560, 1024), (2048, 2560), (2560, 10240),
            (10240, 2560), (4096, 4096), (4096, 256), (13696, 4096),
            # the MoE family's linears outside the experts: qwen2-moe q/k/
            # v/o (2048 -> 2048, as gemma-2b's q) and shared down; deepseek
            # q_proj, kv_down (N 576), kv_up (K 512), the dense layer's
            # down (K 10,944: a short last span) and shared down
            (5632, 2048), (2048, 3072), (2048, 576), (512, 4096),
            (10944, 2048), (2816, 2048)]
DENSE_K3 = [(960, 2560), (4096, 13696),
            (2048, 5632), (2048, 10944), (2048, 2816),
            # hymba's SiLU front, phi-3-vision's
            (1600, 5504), (3072, 8192)]
# K1 (K, N) of the SSM family at a decode step's M 1 and 4, a chunk's 64
# and a prefill's 1,024: mamba2's wz / wx, wb / wc, wdt, out_proj; hymba's
# q / o, k / v, its SSM's wz / wx, wb / wc, out_proj and its down (N 16
# and 24 fill less than one of K1's 64-column blocks)
SSM_K1 = [(768, 1536), (768, 128), (768, 24), (1536, 768),
          (1600, 1600), (1600, 320), (1600, 3200), (1600, 16),
          (3200, 1600), (5504, 1600)]
# K2: model, Hkv, G, hd, window
DENSE_K2 = [("gemma3-4b", 4, 2, 256, 0), ("gemma3-4b", 4, 2, 256, 1024),
            ("gemma-2b", 1, 8, 256, 0), ("glm4-9b", 2, 16, 128, 0),
            ("smollm-360m", 5, 3, 64, 0), ("qwen2-moe-a2.7b", 16, 1, 128, 0),
            ("hymba-1.5b", 5, 5, 64, 0), ("hymba-1.5b", 5, 5, 64, 1024)]
# K4: model, B, S, H, Hkv, hd, window (causal, bf16)
DENSE_K4 = [("gemma3-4b", 1, 1400, 8, 4, 256, 0),
            ("gemma3-4b", 1, 1400, 8, 4, 256, 1024),
            ("gemma3-4b", 2, 1100, 8, 4, 256, 1024),
            ("gemma-2b", 4, 256, 8, 1, 256, 0),
            ("glm4-9b", 4, 256, 32, 2, 128, 0),
            ("smollm-360m", 4, 256, 15, 5, 64, 0),
            ("qwen2-moe-a2.7b", 4, 256, 16, 16, 128, 0),
            # hymba (G 5): the engine's longest one-shot prefill on a
            # global and a windowed layer, the launcher's batch
            ("hymba-1.5b", 1, 1400, 25, 5, 64, 0),
            ("hymba-1.5b", 1, 1400, 25, 5, 64, 1024),
            ("hymba-1.5b", 2, 1100, 25, 5, 64, 1024)]
# hd 32 (glm4-9b's smoke config: 4 q heads over 2 kv heads of 32, G 2,
# max_seq 128, chunk 16, no window), at its shapes and at one larger shape
# of the same head dim (B 4, S 512). K2: model, Hkv, G, hd, window, the
# slots' last query tokens, pages of 16 a slot; K4 / K4b: model, B, S, H,
# Hkv, hd, window (causal, bf16)
HD32_K2 = [("glm4-9b-smoke", 2, 2, 32, 0, (17, 64, 100, 128), 8),
           ("glm4-9b-hd32", 2, 2, 32, 0, (17, 200, 300, 512), 32)]
HD32_K4 = [("glm4-9b-smoke", 4, 128, 4, 2, 32, 0),
           ("glm4-9b-hd32", 4, 512, 4, 2, 32, 0)]
HD32_K4B = [(*case, True) for case in HD32_K4]
# the encoder and the vision frontend: K1 (K, N) of hubert-xlarge (q / k /
# v / o, up, down, frame_proj) and phi-3-vision (q / k / v / o, down) at a
# decode step's M 1 and 4, a chunk's 64 and hubert's forward of 2 x 1,024
FRONTEND_K1 = [(1280, 1280), (1280, 5120), (5120, 1280), (512, 1280),
               (3072, 3072), (8192, 3072)]
FRONTEND_K1_ROWS = (1, 4, 64, 2048)
# K2: phi-3-vision's decode and chunk steps (32 kv heads of 96, G 1) over
# contexts up to 456 (256 patches + 200 tokens)
FRONTEND_K2 = [("phi-3-vision-4.2b", 32, 1, 96, 0)]
FRONTEND_K2_ENDS = (17, 200, 300, 456)
# K4: model, B, S, H, Hkv, hd, window, causal, type: hubert's forward
# (bidirectional, bf16 and the f32 body), phi-3-vision's generate()
# prefill with images (S 456)
FRONTEND_K4 = [("hubert-xlarge", 2, 1024, 16, 16, 80, 0, False,
                torch.bfloat16),
               ("hubert-xlarge", 2, 1024, 16, 16, 80, 0, False,
                torch.float32),
               ("phi-3-vision-4.2b", 2, 456, 32, 32, 96, 0, True,
                torch.bfloat16),
               ("phi-3-vision-4.2b", 2, 456, 32, 32, 96, 0, True,
                torch.float32)]
# K1 / K3 over a MoE layer's routed experts (the expert axis): model, E,
# d_model, expert d_ff; K3 takes d_model -> d_ff, K1 d_ff -> d_model
EXPERT_SHAPES = [("qwen2-moe-a2.7b", 60, 2048, 1408),
                 ("deepseek-v2-lite-16b", 64, 2048, 1408)]
# rows an expert: a decode step, a chunk step (4 slots x 16), a prefill
EXPERT_ROWS = (4, 64, 1024)


def _k1_shape(gen, k, n, m) -> dict:
    """K1 at one (K, N, M) in the model's call (input scale, bf16 out),
    held against the plain version, timed beside it and torch.matmul on
    the dequantized weight."""
    cfg = QuantConfig(group_size=GS)
    p = pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k), cfg),
        None, None, cfg)
    wbytes = p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
    packs = [(p.qweight.clone(), p.scales.clone(), p.zeros.clone())
             for _ in range(cold_copies(wbytes))]
    w_bf16 = dequantize_int4(p.qweight, p.scales, p.zeros, GS,
                             torch.bfloat16)
    lib_w = [w_bf16.clone() for _ in range(cold_copies(w_bf16.nbytes))]
    kw = dict(input_scale=torch.rand(k, generator=gen, device="cuda") + 0.5,
              out_dtype=torch.bfloat16)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    out = k1.awq_matmul(x, *packs[0], GS, **kw)
    ref = k1.awq_matmul_ref(x, *packs[0], GS, torch.bfloat16, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    lim = 1e-4 * float(ref.float().abs().max()) + bf16_ulp(ref)
    if not bool((err <= lim).all()):
        raise AssertionError(f"K1 {k}x{n} M={m}: err exceeds its tolerance "
                             f"by {float((err - lim).max())}")
    full = k1.awq_matmul(torch.cat([x, x]), *packs[0], GS, **kw)
    if not torch.equal(full[:m], out):
        raise AssertionError(f"K1 {k}x{n}: rows at M={m} differ from the "
                             f"same rows at M={2 * m}")
    ms = time_ms(lambda i: k1.awq_matmul(x, *packs[i], GS, **kw), len(packs))
    plain = time_ms(lambda i: k1.awq_matmul_ref(
        x, *packs[i], GS, torch.bfloat16, **kw), len(packs), iters=10)
    lib = time_ms(lambda i: torch.matmul(x, lib_w[i]), len(lib_w))
    b_ms, b_by = bound(x.nbytes + wbytes + k * 4 + m * n * 2,
                       (2 * m * k * n, BF16_OPS_PER_S))
    return dict(k=k, n=n, m=m, max_abs_err=float(err.max()),
                least_tol=float(lim.min()), ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                span_block=k1.span_block(m, k, n))


def _k3_shape(gen, k, n, m) -> dict:
    cfg = QuantConfig(group_size=GS)
    g, u = (pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k), cfg),
        None, None, cfg) for _ in range(2))
    wbytes = sum(t.nbytes for p in (g, u)
                 for t in (p.qweight, p.scales, p.zeros))
    packs = [tuple(t.clone() for p in (g, u)
                   for t in (p.qweight, p.scales, p.zeros))
             for _ in range(cold_copies(wbytes))]
    wg, wu = (dequantize_int4(p.qweight, p.scales, p.zeros, GS,
                              torch.bfloat16) for p in (g, u))
    kw = dict(input_scales=(torch.rand(k, generator=gen, device="cuda") + 0.5,
                            torch.rand(k, generator=gen, device="cuda") + 0.5),
              out_dtype=torch.bfloat16)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    # gated: the f32 output (K3's function with the model's input scales);
    # the bf16 output rounds g before silu, and a g a few f32 ulps off a
    # bf16 midpoint may round the other way, which silu's slope can carry
    # past four bf16 ulps of the product (ROADMAP, Reference caveats:
    # "Cross-framework numerics"), so its elements past k3_tolerance are
    # counted and reported
    errs = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        okw = dict(kw, out_dtype=out_dtype)
        out = k1.awq_gateup(x, *packs[0], GS, **okw)
        ref = k1.awq_gateup_ref(x, *packs[0], GS, torch.bfloat16, **okw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lim = k3_tolerance(ref)
        past = int((err > lim).sum())
        if out_dtype == torch.float32 and past:
            raise AssertionError(f"K3 {k}x{n} M={m}: err exceeds its "
                                 f"tolerance by {float((err - lim).max())}")
        errs[str(out_dtype).split(".")[-1]] = dict(
            max_abs_err=float(err.max()), least_tol=float(lim.min()),
            past_tolerance=past, elements=err.numel())
    ms = time_ms(lambda i: k1.awq_gateup(x, *packs[i], GS, **kw), len(packs))
    plain = time_ms(lambda i: k1.awq_gateup_ref(
        x, *packs[i], GS, torch.bfloat16, **kw), len(packs), iters=10)
    lib = time_ms(lambda i: torch.nn.functional.silu(x @ wg) * (x @ wu), 1)
    b_ms, b_by = bound(x.nbytes + wbytes + 2 * k * 4 + m * n * 2,
                       (2 * 2 * m * k * n, BF16_OPS_PER_S))
    return dict(k=k, n=n, m=m, max_abs_err=errs["float32"]["max_abs_err"],
                by_output=errs, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def _k2_shape(gen, arch, hkv, g, hd, window, c,
              ends=(17, 700, 1100, 1500), nblk=96) -> dict:
    """K2 over 4 slots of ``nblk`` pages of 16 whose last query tokens sit
    at ``ends`` (17 … 1,500 by default, past gemma3's window), a padding
    row's tail, C query tokens a row."""
    b, page = 4, 16
    npages = b * nblk + 1
    copies = cold_copies(2 * npages * page * hkv * (hd + 4))
    pools = []
    for _ in range(copies):
        kp, vp = (torch.randint(-127, 128, (npages, page, hkv, hd),
                                generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(npages, page, hkv, generator=gen, device="cuda")
                  / 50 for _ in range(2))
        pools.append((kp, ks, vp, vs))
    table = (torch.randperm(npages - 1, generator=gen, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([*ends[:3], ends[3] - c], dtype=torch.int32,
                        device="cuda")
    pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                       device="cuda")[None]
    pos[0, c // 2 + 1:] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=gen, device="cuda")

    def run(i, fn):
        kp, ks, vp, vs = pools[i]
        return fn(q, kp, ks, vp, vs, table, pos, window=window)

    out = run(0, k2.paged_attention_chunk)
    ref = run(0, k2.paged_attention_chunk_ref)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K2 {arch} hd={hd} G={g} window={window} "
                             f"C={c}: err {err} > {tol}")
    ms = time_ms(lambda i: run(i, k2.paged_attention_chunk), copies)
    plain = time_ms(lambda i: run(i, k2.paged_attention_chunk_ref), copies,
                    iters=10)
    s_slot = nblk * page
    vis = k2.chunk_visibility_ref(pos, s_slot=s_slot, window=window)
    keys = int(vis.any(dim=1).sum())
    nbytes = (2 * q.nbytes + keys * hkv * (2 * hd + 8) + table.nbytes
              + pos.nbytes)
    b_ms, b_by = bound(nbytes, (4 * int(vis.sum()) * hkv * g * hd,
                                F32_OPS_PER_S))
    mask = vis[:, None].expand(b, hkv * g, c, s_slot)
    kp, ks, vp, vs = pools[0]
    kk, vv = ((cp.float() * sc[..., None])[table.long()].reshape(
        b, s_slot, hkv, hd).transpose(1, 2).to(torch.bfloat16).contiguous()
        for cp, sc in ((kp, ks), (vp, vs)))
    qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, c, hd).to(
        torch.bfloat16)
    lib = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv, attn_mask=mask, enable_gqa=True), 1, iters=10)
    return dict(model=arch, hkv=hkv, g=g, hd=hd, window=window, c=c,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def _k4_shape(gen, arch, b, s, h, hkv, hd, window, causal=True,
              dtype=torch.bfloat16) -> dict:
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
               .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
    kw = dict(causal=causal, window=window)
    out = k4.flash_attention(q, k, v, **kw)
    ref = k4.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    lim = 1e-5 + torch.finfo(dtype).eps * ref.float().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"K4 {arch} S={s} hd={hd} window={window} "
                             f"causal={causal} {dtype}: err exceeds 1e-5 + "
                             f"eps|ref| by {float((err - lim).max())}")
    ms = time_ms(lambda i: k4.flash_attention(q, k, v, **kw), 1)
    plain = time_ms(lambda i: k4.flash_attention_ref(q, k, v, **kw), 1,
                    iters=5)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    mask = k4.visibility(s, causal=causal, window=window, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_kw = dict(attn_mask=mask) if window else dict(is_causal=causal)
    lib = time_ms(lambda i: sdpa(qc, kc, vc, enable_gqa=True, **lib_kw), 1,
                  iters=10)
    pair_flops = 2 * hd * h * b * int(mask.sum())
    # bf16 / f16: QK^T plus PV's two halves on tensor cores; f32: both
    # products on the CUDA cores
    work = ((3 * pair_flops, BF16_OPS_PER_S) if dtype != torch.float32
            else (2 * pair_flops, F32_OPS_PER_S))
    b_ms, b_by = bound(q.nbytes + k.nbytes + v.nbytes + out.nbytes, work)
    return dict(model=arch, b=b, s=s, h=h, hkv=hkv, hd=hd, window=window,
                causal=causal, dtype=str(dtype).split(".")[-1],
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def _expert_shape(gen, arch, e, d, f, m, gateup: bool) -> dict:
    """K3 (``gateup``: d -> f, gate and up) or K1 (f -> d) over E routed
    experts at M rows each, in the model's call (unit input scales, as a
    routed expert keeps at RTN; bf16 output), one launch for all of them:
    held against the plain version (a loop over the experts), timed
    beside it and `torch.bmm` on the dequantized bf16 experts. The bound
    reads every expert's packed weight once."""
    cfg = QuantConfig(group_size=GS)
    k, n = (d, f) if gateup else (f, d)

    def stacked():
        ps = [pack_linear(*quantize_groupwise(
            torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k),
            cfg), None, None, cfg) for _ in range(e)]
        return tuple(torch.stack([getattr(p, a) for p in ps])
                     for a in ("qweight", "scales", "zeros"))

    ws = [stacked() for _ in range(2 if gateup else 1)]
    ones = torch.ones(e, k, device="cuda")
    x = torch.randn(e, m, k, generator=gen, device="cuda").to(torch.bfloat16)
    wbytes = sum(t.nbytes for w in ws for t in w)
    dense = [torch.stack([dequantize_int4(q, sc, z, GS, torch.bfloat16)
                          for q, sc, z in zip(*w)]) for w in ws]
    if gateup:
        args = (x, *ws[0], *ws[1], GS)
        kw = dict(input_scales=(ones, ones))
        fn, plain = k1.awq_gateup_experts, k1.awq_gateup_experts_ref
        lib = lambda i: (torch.nn.functional.silu(torch.bmm(x, dense[0]))  # noqa: E731
                         * torch.bmm(x, dense[1]))
    else:
        args, kw = (x, *ws[0], GS), dict(input_scale=ones)
        fn, plain = k1.awq_matmul_experts, k1.awq_matmul_experts_ref
        lib = lambda i: torch.bmm(x, dense[0])  # noqa: E731
    errs = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        out = fn(*args, out_dtype=out_dtype, **kw)
        ref = plain(*args, torch.bfloat16, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lim = (k3_tolerance(ref) if gateup else
               1e-4 * float(ref.float().abs().max())
               + (bf16_ulp(ref) if out_dtype == torch.bfloat16 else 0))
        past = int((err > lim).sum())
        # gated as K1 and K3 are gated (kernel_shapes' tolerance field)
        if past and (out_dtype == torch.float32 or not gateup):
            raise AssertionError(f"{arch} experts {'K3' if gateup else 'K1'} "
                                 f"{k}x{n} M={m}: err exceeds its tolerance "
                                 f"by {float((err - lim).max())}")
        errs[str(out_dtype).split(".")[-1]] = dict(
            max_abs_err=float(err.max()), past_tolerance=past,
            elements=err.numel())
    kw["out_dtype"] = torch.bfloat16
    ms = time_ms(lambda i: fn(*args, **kw), 1, iters=10)
    plain_ms = time_ms(lambda i: plain(*args, torch.bfloat16, **kw), 1,
                       iters=2)
    lib_ms = time_ms(lib, 1, iters=10)
    nw = 2 if gateup else 1
    b_ms, b_by = bound(x.nbytes + wbytes + nw * e * k * 4 + e * m * n * 2,
                       (2 * nw * e * m * k * n, BF16_OPS_PER_S))
    return dict(model=arch, experts=e, k=k, n=n, m=m,
                max_abs_err=errs["float32"]["max_abs_err"], by_output=errs,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, packed_bytes=wbytes)


def check_expert_kernels(gen) -> dict:
    """K3 and K1 over each MoE model's routed experts at 4, 64 and 1,024
    rows an expert (a decode step's capacity, a chunk step's of 4 slots x
    16 tokens, and the launcher's dropless prefill of 4 x 256 tokens):
    the skinny kernel and the wide one's 64- and 128-row tiles."""
    return dict(
        awq_gateup_experts=[_expert_shape(gen, *case, m, True)
                            for case in EXPERT_SHAPES for m in EXPERT_ROWS],
        awq_matmul_experts=[_expert_shape(gen, *case, m, False)
                            for case in EXPERT_SHAPES for m in EXPERT_ROWS],
        tolerance="K1 as on Qwen2.5's shapes, gated on both outputs; K3 "
                  "gated on its f32 output, its bf16 output's elements past "
                  "four bf16 ulps counted (by_output); times are the "
                  "model's call (unit input scales, bf16 output); "
                  "library_ms: torch.bmm on the dequantized bf16 experts")


# a shard's stripe of qwen2-moe's experts under the tp_moe phase's 2-way
# mesh (K3: d_model 2,048 -> F 704; K1: F 1,408 -> D 1,024) at every rows
# count, and under a 4-way one (352 / 512) at a chunk step's 64 rows
EXPERT_SHARD_CASES = [(2, m) for m in EXPERT_ROWS] + [(4, 64)]


def check_expert_shard_kernels(gen) -> dict:
    """K3 and K1 over qwen2-moe's 60 experts at one shard's stripe widths
    (`_expert_shape`: held against the plain version, timed beside it and
    `torch.bmm`, the bound of the stripe's bytes and products)."""
    _, e, d, f = EXPERT_SHAPES[0]
    return dict(
        awq_gateup_experts=[dict(_expert_shape(gen, TP_MOE_ARCH, e, d,
                                               f // n, m, True), shards=n)
                            for n, m in EXPERT_SHARD_CASES],
        awq_matmul_experts=[dict(_expert_shape(gen, TP_MOE_ARCH, e, d // n,
                                               f, m, False), shards=n)
                            for n, m in EXPERT_SHARD_CASES])


# K1 / K3 at the stripes a 2-way `model` mesh gives the packed forward of
# the five families `tp_families` splits (K, N of one shard): hymba's wb /
# wc (16 -> 8), mamba2's wdt (24 -> 12), N 25 (hymba's wdt stripe width:
# its 1600 -> 50 stays float on the path, the pipeline's rule), deepseek's
# dense down flipped to its N (K 10,944: 5,472 rows would cut a 64-row
# group), its kv_down stripe (576 -> 288, across the latent / rope
# boundary), hymba's wo flipped (K 1,600: 800 rows cut a group), hubert's
# and phi-3-vision's row-parallel down; K3 at the GLU fronts' column
# stripes (deepseek's dense 2,048 -> 5,472, hymba's 1,600 -> 2,752,
# phi-3-vision's 3,072 -> 4,096); M 4 and 1,024
TP_STRIPE_K1 = [(1600, 8), (768, 12), (1600, 25), (10944, 1024),
                (2048, 288), (1600, 800), (2560, 1280), (4096, 3072)]
TP_STRIPE_K3 = [(2048, 5472), (1600, 2752), (3072, 4096)]
TP_STRIPE_ROWS = (4, 1024)


def check_tp_stripe_kernels(gen) -> dict:
    """K1 and K3 at `TP_STRIPE_K1` / `TP_STRIPE_K3` (`_k1_shape`,
    `_k3_shape`: the model's call held against the plain version, timed
    beside it and ``torch.matmul`` on the dequantized weight, with the
    bound of the stripe's bytes and products)."""
    return dict(awq_matmul=[_k1_shape(gen, k, n, m) for k, n in TP_STRIPE_K1
                            for m in TP_STRIPE_ROWS],
                awq_gateup=[_k3_shape(gen, k, n, m) for k, n in TP_STRIPE_K3
                            for m in TP_STRIPE_ROWS])


def check_dense_kernels(gen) -> dict:
    """K1 - K4 at the other models' shapes, each held against its plain
    version (K1 / K3 at the model's call, M 4 and 1024, the SSM family's
    K1 also at M 1 and 64, the encoder's and the VLM's at M 1, 4, 64 and
    2,048; K2 at C 1 and 16; K4 at the prefills the launcher and the
    engine give it, hubert's bidirectional forward at hd 80 and
    phi-3-vision's prefill with images at hd 96 also in f32)."""
    return dict(
        awq_matmul=[_k1_shape(gen, k, n, m) for k, n in DENSE_K1
                    for m in (4, 1024)]
        + [_k1_shape(gen, k, n, m) for k, n in SSM_K1
           for m in (1, 4, 64, 1024)]
        + [_k1_shape(gen, k, n, m) for k, n in FRONTEND_K1
           for m in FRONTEND_K1_ROWS],
        awq_gateup=[_k3_shape(gen, k, n, m) for k, n in DENSE_K3
                    for m in (4, 1024)],
        paged_attention_chunk=[_k2_shape(gen, *case, c) for case in DENSE_K2
                               for c in (1, 16)]
        + [_k2_shape(gen, *case, c, ends=FRONTEND_K2_ENDS, nblk=32)
           for case in FRONTEND_K2 for c in (1, 16)]
        + [_k2_shape(gen, *case, c, ends=ends, nblk=nblk)
           for *case, ends, nblk in HD32_K2 for c in (1, 16)],
        flash_attention=[_k4_shape(gen, *case) for case in DENSE_K4]
        + [_k4_shape(gen, *case) for case in FRONTEND_K4]
        + [_k4_shape(gen, *case) for case in HD32_K4],
        tolerance="K1 / K2 / K4 as on Qwen2.5's shapes (kernel_shapes' "
                  "tolerance fields); K1 also holds its M rows equal to the "
                  "same rows of a 2M launch; K3 gated on its f32 output, "
                  "its bf16 output's elements past four bf16 ulps counted "
                  "(awq_gateup[].by_output); times are the model's call "
                  "(input scales, bf16 output)")


@contextlib.contextmanager
def _depth(arch: str, layers):
    """The registry serves ``arch`` cut to ``layers`` layers (its widths
    unchanged) while the block runs."""
    if layers is None:
        yield
        return
    full, smoke = configs._REGISTRY[arch]
    configs._REGISTRY[arch] = (
        lambda: dataclasses.replace(full(), num_layers=layers), smoke)
    try:
        yield
    finally:
        configs._REGISTRY[arch] = (full, smoke)


def _linear_counts(cfg) -> tuple[int, int, int]:
    """(quantized, kept float, routed-expert) linears the pipeline gives
    this model at its published widths: per layer the mixer's (attention
    or MLA 4, SSD 6, hymba both) and the MLP's (a GLU's 3, a plain MLP's
    2: hubert's up and down), each quantized where the pipeline's rule
    takes its (K, N) (K a multiple of 64, N of 8, K·N at least 16,384:
    hymba's ``wdt`` 1600 -> 50 stays float); on a MoE layer the shared
    experts' 3 and the routed experts' 3 stacked leaves (their router and
    ``shared_gate`` stay float); an untied head (float); a frontend's
    projection: hubert's ``frame_proj`` (512 -> d_model) quantized by the
    same rule, phi-3-vision's ``patch_proj`` float (the pipeline excludes
    it by name)."""
    quant = skip = routed = 0
    if cfg.frontend == "audio" and costmodel._quantizable(
            cfg.frontend_dim, cfg.d_model, GS):
        quant += 1
    elif cfg.frontend != "none":
        skip += 1
    for kind in cfg.layer_kinds():
        for k, n in costmodel._linear_dims(cfg, kind):
            if costmodel._quantizable(k, n, GS):
                quant += 1
            else:
                skip += 1
        if kind.mlp == "moe":
            routed += 3
            quant += 3 + 3 * bool(cfg.num_shared_experts)
            skip += 1 + cfg.shared_expert_gate
    return quant, skip + (not cfg.tie_embeddings), routed


def _k4_layers(cfg) -> int:
    """Layers whose full-sequence attention runs K4 (MLA's products and
    the SSD are tensor code)."""
    return sum(k.mixer in ("attn", "hymba") for k in cfg.layer_kinds())


def _uses_k3(cfg) -> bool:
    """Whether the model's dense GLU fronts run on K3 (SiLU only: gemma's
    GeGLU fronts are two K1 calls; hubert's plain GELU MLP is two K1
    calls; mamba2 has no MLP)."""
    return cfg.act == "silu" and any(k.mlp in ("glu", "moe")
                                     for k in cfg.layer_kinds())


def dense_launch(arch: str, spec: dict) -> tuple[dict, dict, Model]:
    """The launcher's AWQ path for one model: calibrate, AWQ search and
    pack every linear (a MoE layer's routed experts at RTN, as no forward
    records them), generate() (K4 prefills on attention layers, hymba's
    included, rings on windowed ones; a MoE layer's experts on K3 and
    K1's expert axis; the SSD as tensor code). Returns (phase fields, the
    AWQ params, the model)."""
    args = ["--arch", arch, "--quant", "awq"]
    if "forward" not in spec:       # an encoder's launcher generates nothing
        args += ["--batch", str(spec["batch"]), "--prompt-len",
                 str(spec["prompt_len"]), "--max-new", "32"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _depth(arch, spec["layers"]):
        cfg = get_config(arch)
        # this model's launcher path: counts start at 0 here, read after
        reset_counts()
        t0 = time.perf_counter()
        out = launcher.main(args)
        total_s = time.perf_counter() - t0
    launches = read_counts([*COUNTERS, *EXPERT_COUNTERS])
    rep, by_step = out["report"], out["launches"]
    if not cfg.is_encoder:      # an encoder's launcher ends after the pack
        toks = out["tokens"]
        if out["shape"] != [spec["batch"], 32] or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{arch} launch: bad tokens "
                                 f"{out['shape']}")
    # every linear of a layer is quantized at the published widths (the
    # pipeline keeps K·N < 16,384 in float, which only smoke widths meet),
    # and every one but the routed experts and hubert's frame_proj (the
    # capture never sees the frontend) calibrated
    n_quant, n_skip, n_routed = _linear_counts(cfg)
    routed = [p for p in rep.quantized if "/experts/" in p]
    uncalibrated = set(routed) | {p for p in rep.quantized
                                  if p.startswith("frontend/")}
    if not (len(rep.quantized) == n_quant and len(rep.skipped) == n_skip
            and len(routed) == n_routed
            and set(rep.calibrated) == set(rep.quantized) - uncalibrated):
        raise AssertionError(f"{arch} launch: {len(rep.calibrated)} of "
                             f"{len(rep.quantized)} linears calibrated "
                             f"({len(routed)} routed), {len(rep.skipped)} "
                             f"kept float; want {n_quant} ({n_routed}), "
                             f"{n_skip}")
    glu_k3 = _uses_k3(cfg)
    attn_layers = _k4_layers(cfg)
    if cfg.is_encoder:
        # the calibration forward (float weights): K4 once a layer, all
        # bidirectional; no K1 before the pack
        gen_l = None
        k4_ok = by_step["calibrate"]["flash_attention"] == attn_layers
        if not (k4_ok and launches["awq_matmul"] == 0
                and launches["paged_attention_chunk"] == 0):
            raise AssertionError(f"{arch} launch: kernels {by_step}")
    else:
        gen_l = by_step["generate"]
        k4_ok = (by_step["calibrate"]["flash_attention"] >= attn_layers
                 and gen_l["flash_attention"] >= attn_layers
                 if attn_layers else launches["flash_attention"] == 0)
    experts_ok = ((launches["awq_matmul_experts"] > 0
                   and launches["awq_gateup_experts"] > 0) == (n_routed > 0))
    if gen_l is not None and not (
            k4_ok and experts_ok and gen_l["awq_matmul"] > 0
            and (gen_l["awq_gateup"] > 0) == glu_k3):
        raise AssertionError(f"{arch} launch: kernels {by_step}, expert "
                             f"axis {launches} (K3 "
                             f"{'expected' if glu_k3 else 'not expected'})")
    fields = dict(
        args=" ".join(args), layers=cfg.num_layers,
        depth_cut=(f"{cfg.num_layers} of {configs._REGISTRY[arch][0]().num_layers}"
                   if spec["layers"] else None),
        layer_kinds=[[k.tag, n] for k, n in cfg.segments()],
        d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        experts=([cfg.num_experts, cfg.top_k, cfg.moe_d_ff,
                  cfg.num_shared_experts] if cfg.num_experts else None),
        mla=([cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
              cfg.v_head_dim] if cfg.kv_lora_rank else None),
        ssm=([cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim,
              cfg.ssm_chunk] if cfg.family in ("ssm", "hybrid") else None),
        frontend=([cfg.frontend, cfg.frontend_dim, cfg.num_patches]
                  if cfg.frontend != "none" else None),
        window=cfg.sliding_window, total_s=total_s,
        calibrate_s=out["calib_s"], awq_s=out["awq_s"],
        quantized=len(rep.quantized), calibrated=len(rep.calibrated),
        skipped=len(rep.skipped), compression_ratio=rep.compression_ratio,
        fp16_bytes=out["fp16_bytes"], awq_macro_bytes=out["macro_bytes"],
        generate_s=out.get("generate_s"),
        tokens_per_s=out.get("tokens_per_s"),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, launches_by_step=by_step,
        sample=(None if cfg.is_encoder else out["tokens"][0][:8].tolist()))
    return fields, out["params"], Model(cfg)


K2_WINDOWED = {"calls": 0}
K4_BIDIRECTIONAL = {"calls": 0}


def _count_windowed_k2() -> None:
    """Count K2 calls made with a window and K4 calls made with
    ``causal=False`` (the wrappers' own counters count every launch)."""
    plain_call = k2.paged_attention_chunk
    plain_k4 = k4.flash_attention

    def call(*args, window: int = 0, **kw):
        if window:
            K2_WINDOWED["calls"] += 1
        return plain_call(*args, window=window, **kw)

    def call_k4(*args, causal: bool = True, **kw):
        if not causal:
            K4_BIDIRECTIONAL["calls"] += 1
        return plain_k4(*args, causal=causal, **kw)

    k2.paged_attention_chunk = call
    k4.flash_attention = call_k4


def dense_prompts(vocab: int, lens) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# each model's engine streams by (arch, config name), for the tp_moe phase
SERVED: dict = {}


# new tokens a request of the other models' serve bursts (32 before the
# tp_families phase came: cut for the time limit on a slow host)
DENSE_NEW = 12


def dense_serve(arch: str, model, params, spec: dict) -> dict:
    """8 greedy requests of `DENSE_NEW` new tokens through the engine's
    default path
    (the chunked one over int8 pools, 4 slots, pages of 16; a model with
    per-slot state the one-shot one: MLA's dense latents, SSM states,
    hymba's windowed rings, hymba's global layers over int8 pools), under
    the default threshold (this model's serving path: counts from 0 here,
    read after) and with every quantized linear on K1 / K3; each stream
    against the port's own generate() at B 1 under the same config:
    first tokens gated, whole streams reported with the first differing
    position and generate()'s logit margin there (with
    ``streams_gated``, every stream gated equal). The first tokens are
    held by the `check` rule: the engine's comes from its last prefill
    chunk over the int8 pages, generate()'s from its K4 prefill over bf16
    K/V (on the one-shot path both from the same dense prefill)."""
    cfg = model.cfg
    prompts = dense_prompts(cfg.vocab_size, spec["serve_lens"])
    kw = dict(num_slots=4, page_size=16, max_seq=spec["max_seq"],
              prefill_chunk=spec["chunk"], kv_quant="int8")
    res, refs_by = {}, {}
    for name, ecfg in (("default", qlinear.ExecutionConfig()),
                       ("all_kernel", ALL_KERNEL)):
        with qlinear.execution_config(ecfg):
            eng = GenerationEngine(model, params, **kw)
            _reset_peak()
            reset_counts()
            K2_WINDOWED["calls"] = 0
            t0 = time.perf_counter()
            rids = [eng.submit(p, DENSE_NEW) for p in prompts]
            steps, decode_s, decode_steps, prefilled = 0, 0.0, 0, 0
            decode_tokens, admitted = 0, 0
            while not eng.idle:
                ts = time.perf_counter()
                events = eng.step()         # ends in a device→host copy
                dt = time.perf_counter() - ts
                steps += 1
                now = eng.stats().prefill_tokens
                sst = eng.scheduler_stats
                if now == prefilled and sst.admitted == admitted:
                    decode_s += dt          # a step with decode rows only
                    decode_steps += 1
                    decode_tokens += len(events)
                prefilled, admitted = now, sst.admitted
            out = eng.drain()
            serve_s = time.perf_counter() - t0
            SERVED[arch, name] = [out[r] for r in rids]
            chunked = eng._scheduler._run_batch is not None
            launches = read_counts([*COUNTERS, *EXPERT_COUNTERS])
            windowed = K2_WINDOWED["calls"]
            peak = torch.cuda.max_memory_allocated()
            check_streams(f"{arch} serve", out, rids, cfg.vocab_size,
                          DENSE_NEW)
            t0 = time.perf_counter()
            refs = [eng.generate({"tokens": p[None]}, DENSE_NEW)[0]
                    for p in prompts]
            generate_s = time.perf_counter() - t0
            refs_by[name] = refs
            identical, mismatches, first_ties = 0, [], []
            for rid, p, ref in zip(rids, prompts, refs):
                got = out[rid]
                if got[0] != ref[0]:
                    # the engine's first token is its last prefill chunk's
                    # argmax, over the int8 pages K2 reads; generate()'s is
                    # its K4 prefill's over bf16 K/V: gated by the `check`
                    # rule (equal where the top-2 margin clears 2 x 5 % of
                    # the logits' scale), reported otherwise
                    margin, scale = _first_margin(model, params, p,
                                                  spec["max_seq"])
                    if margin > 2 * 0.05 * scale:
                        raise AssertionError(
                            f"{arch} serve {name}: request {rid}: first "
                            f"token {got[0]} != generate()'s {ref[0]}, "
                            f"margin {margin} of scale {scale}")
                    first_ties.append(dict(request=rid, margin=margin,
                                           scale=scale))
                if np.array_equal(got, ref):
                    identical += 1
                    continue
                i = int(np.argmax(got != ref))
                mismatches.append(dict(
                    request=rid, prompt_len=len(p), first_diff=i,
                    generate_token=int(ref[i]), engine_token=int(got[i]),
                    logit_margin=_logit_margin(model, params, p, ref, i,
                                               int(got[i]),
                                               max_seq=spec["max_seq"])))
        # K2 reads the page pools (every attention layer's on the chunked
        # path; on the one-shot path hymba's global layers', none for MLA
        # or mamba2); K4 runs the one-shot path's dense prefills of
        # attention layers (hymba's), none on the chunked path (K2 reads
        # its prefill chunks) and none for MLA (tensor code)
        pooled = any("kv_pool" in e for lyr in eng._paged_cache.values()
                     for e in lyr)
        if not (launches["awq_matmul"] > 0
                and (launches["paged_attention_chunk"] > 0) == pooled
                and chunked == (cfg.kv_lora_rank == 0
                                and cfg.family not in ("ssm", "hybrid"))
                and (launches["awq_gateup"] > 0) == _uses_k3(cfg)
                and (launches["awq_gateup_experts"] > 0)
                == (launches["awq_matmul_experts"] > 0)
                == bool(cfg.num_experts)
                and (launches["flash_attention"] > 0)
                == (not chunked and _k4_layers(cfg) > 0)):
            raise AssertionError(f"{arch} serve {name}: kernels {launches}, "
                                 f"chunked {chunked}")
        # windowed layers read the pools through K2 on the chunked path;
        # hymba's keep per-slot rings (tensor code, no K2)
        if cfg.sliding_window and not (
                (windowed > 0) == chunked
                and max(map(len, prompts)) > cfg.sliding_window):
            raise AssertionError(f"{arch} serve {name}: {windowed} windowed "
                                 f"K2 calls, prompts up to "
                                 f"{max(map(len, prompts))}")
        if spec.get("streams_gated") and identical != len(rids):
            raise AssertionError(f"{arch} serve {name}: {identical} of "
                                 f"{len(rids)} streams equal generate()'s: "
                                 f"{mismatches}")
        st = eng.stats()
        res[name] = dict(
            path="chunked" if chunked else "one-shot",
            requests=len(rids), steps=steps, serve_s=serve_s,
            decode_steps=decode_steps,
            decode_step_ms=1e3 * decode_s / max(1, decode_steps),
            decode_tokens_per_s=decode_tokens / max(decode_s, 1e-9),
            prefill_tokens=st.prefill_tokens, kv_pool_bytes=st.kv_pool_bytes,
            weight_bytes=st.weight_bytes, peak_mem_bytes=peak,
            launches=launches, k2_windowed_calls=windowed,
            generate_s=generate_s, identical_streams=identical,
            first_tokens_equal=len(rids) - len(first_ties),
            first_token_near_ties=first_ties, mismatches=mismatches)
        del eng
        gc.collect()
    if spec.get("oneshot_bf16"):
        res["oneshot_bf16"] = oneshot_bf16(arch, model, params, spec,
                                           prompts, refs_by["all_kernel"])
    return dict(prompt_lens=list(spec["serve_lens"]), **res)


def oneshot_bf16(arch: str, model, params, spec: dict, prompts,
                 refs) -> dict:
    """ROADMAP Queue 3's check: the serve prompts (`DENSE_NEW` new tokens
    each) through the one-shot engine over bf16 pools (``kv_quant="none"``,
    ``chunked_prefill=False``, 4 slots, pages of 16) with every quantized
    linear on K1 / K3 (no linear changes path with M), each stream
    against ``refs``, `generate()` at B 1 under the same config
    (`dense_serve`'s): both sides take the first token from the same
    dense prefill and keep bf16 K/V, so what is left to part a stream is
    an op whose row depends on the step's row count or the cache's
    length. Every stream is gated equal; the first differing position of
    each other stream is reported."""
    cfg = model.cfg
    with qlinear.execution_config(ALL_KERNEL):
        eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                               max_seq=spec["max_seq"], kv_quant="none",
                               chunked_prefill=False)
        reset_counts()
        t0 = time.perf_counter()
        rids = [eng.submit(p, DENSE_NEW) for p in prompts]
        out = eng.drain()
        serve_s = time.perf_counter() - t0
        launches = read_counts([*COUNTERS, *EXPERT_COUNTERS])
    check_streams(f"{arch} oneshot_bf16", out, rids, cfg.vocab_size,
                  DENSE_NEW)
    diffs = _first_diffs([out[r] for r in rids], refs)
    identical = sum(d is None for d in diffs)
    if eng._scheduler._run_batch is not None or any(
            "ks" in e.get("kv_pool", {}) for lyr in eng._paged_cache.values()
            for e in lyr):
        raise AssertionError(f"{arch} oneshot_bf16: not the one-shot path "
                             f"over bf16 pools")
    del eng
    gc.collect()
    if identical != len(rids):
        raise AssertionError(f"{arch} oneshot_bf16: {identical} of "
                             f"{len(rids)} streams equal generate()'s "
                             f"(first differing positions {diffs})")
    return dict(requests=len(rids), identical_streams=identical,
                first_diffs=diffs, serve_s=serve_s, launches=launches)


@torch.no_grad()
def _first_margin(model, params, prompt, max_seq: int) -> tuple[float, float]:
    """generate()'s first-token logits (its prefill at B 1): the top-2
    margin and the largest magnitude."""
    cache = model.init_cache(1, max_seq, device="cuda")
    _, logits, _ = model.prefill(
        params, {"tokens": torch.as_tensor(prompt, device="cuda")[None]},
        cache)
    lg = logits[0].float()
    top2 = torch.topk(lg, 2).values
    return float(top2[0] - top2[1]), float(lg.abs().max())


def _cut_two_layers(model, params):
    """A 2-layer model of ``model``'s widths and its params: where the
    model has windowed and global layers, one of each in the order the
    config's rule puts them at 2 layers (gemma3-4b, global every 6: its
    first windowed then first global layer, 0 and 5; hymba, global
    layers listed from 0: its layer 0 then its first windowed one), else
    layers 0 and 1."""
    cfg = model.cfg
    kinds = cfg.layer_kinds()
    where = []                                   # layer -> (segment, index)
    for si, (_, n) in enumerate(cfg.segments()):
        where += [(f"seg_{si}", i) for i in range(n)]
    windowed = [i for i, k in enumerate(kinds) if k.window]
    full = [i for i, k in enumerate(kinds) if not k.window]
    if windowed and full and cfg.global_layers:
        pick = [full[0], windowed[0]]
        cut = dataclasses.replace(cfg, num_layers=2)
    elif windowed and full:
        pick = [windowed[0], full[0]]
        cut = dataclasses.replace(cfg, num_layers=2, global_every=2)
    else:
        pick = [0, 1]
        cut = dataclasses.replace(cfg, num_layers=2)
    if list(cut.layer_kinds()) != [kinds[i] for i in pick]:
        raise AssertionError(f"2-layer cut of {cfg.name}: kinds "
                             f"{cut.layer_kinds()} are not layers {pick}'s")
    cm = Model(cut)
    layers = [params["segments"][where[i][0]][where[i][1]] for i in pick]
    segs, j = {}, 0
    for si, (_, n) in enumerate(cut.segments()):
        segs[f"seg_{si}"] = layers[j:j + n]
        j += n
    return cm, {**params, "segments": segs}, pick


def cross_check_decode(model, params, cpu_params=None) -> dict:
    """The one-shot path's counterpart of `cross_check`, for a model
    whose cache is per-slot state (MLA latents, SSM states, hymba's
    rings) or whose prompts hold images (phi-3-vision: 256 patches before
    the tokens, so the decode step runs at position 272): a prefill of 4
    prompts of 16 tokens into the dense cache (step 0), then one decode
    step over the card's cache (step 1), on the card vs CPU copies
    (plain versions), held by the same rule: logits at 5% of their
    largest magnitude, argmax equal on rows whose top-2 margin clears
    that. The CPU side takes the card's MoE routing (`RouteTie`).
    ``cpu_params``: the CPU copy, if made."""
    prm = {"cuda": params, "cpu": tree_to(params, "cpu")
           if cpu_params is None else cpu_params}
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                            .astype(np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, 4)
                           .astype(np.int32))
    batch = {"tokens": toks}
    # a vision model's prompts hold image patches first: the decode step
    # runs at position num_patches + 16
    span = cfg.num_patches if cfg.frontend == "vision" else 0
    if span:
        batch["images"] = torch.from_numpy(rng.standard_normal(
            (4, span, cfg.frontend_dim)).astype(np.float32))
    caches = {d: model.init_cache(4, span + 32, device=d)
              for d in ("cuda", "cpu")}
    res = {}
    for step in (0, 1):
        if step == 1:      # both sides read the card's cache
            caches["cpu"] = tree_to(caches["cuda"], "cpu")
        logits, tie = {}, RouteTie()
        for d in ("cuda", "cpu"):
            with torch.no_grad(), _device_side(tie, d):
                if step == 0:
                    caches[d], lg, nxt_pos = model.prefill(
                        prm[d], {k: v.to(d) for k, v in batch.items()},
                        caches[d])
                    if int(nxt_pos[0]) != span + 16:
                        raise AssertionError(f"cross-check decode: next "
                                             f"position {nxt_pos.tolist()}")
                else:
                    lg, caches[d] = model.decode_step(
                        prm[d], caches[d], nxt.to(d),
                        torch.full((4,), span + 16, dtype=torch.int32,
                                   device=d))
            logits[d] = lg.float().cpu()
        ref, got = logits["cpu"], logits["cuda"]
        err = float((got - ref).abs().max())
        tol = 0.05 * float(ref.abs().max())
        top2 = torch.topk(ref, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = got.argmax(-1) == ref.argmax(-1)
        if not err <= tol or not bool(agree[clear].all()):
            raise AssertionError(f"cross-check decode step {step}: err {err} "
                                 f"> {tol} or argmax differs on clear rows")
        res[f"step{step}"] = dict(max_abs_err=err, tol=tol,
                                  clear_rows=int(clear.sum()),
                                  argmax_agree=int(agree.sum()),
                                  routing=tie.report())
    return res


def dense_check(arch: str, model, params) -> dict:
    """The CPU checks at a depth the host can run: a 2-layer cut of the
    served AWQ model (a model whose every layer is MoE: its first layer,
    for the CPU side's time), one chunk step pair (`cross_check`; the
    one-shot prefill and decode step, `cross_check_decode`, for a model
    with per-slot state and for phi-3-vision, whose prefill takes images)
    and one prefill (`check_prefill`) on the card against CPU copies (one
    copy for both)."""
    cm, cp, pick = _cut_two_layers(model, params)
    if cm.cfg.num_experts and not cm.cfg.first_dense_layers:
        cm = Model(dataclasses.replace(cm.cfg, num_layers=1))
        cp = {**cp, "segments": {"seg_0": cp["segments"]["seg_0"][:1]}}
        pick = pick[:1]
    chunkable = GenerationEngine._cache_chunkable(cm.init_paged_cache(
        2, 16, device="meta", num_slots=1, slot_seq=16))
    check = (cross_check if chunkable and cm.cfg.frontend == "none"
             else cross_check_decode)
    cpu = tree_to(cp, "cpu")
    return dict(layers=pick, check=check(cm, cp, cpu_params=cpu),
                check_prefill=check_prefill(cm, cp, cpu))


# -------------------------------------------------------- phase sp_decode
SP_BATCH, SP_PROMPT, SP_STEPS = 8, 512, 4
SP_MAX_SEQ = SP_PROMPT + 16            # 2 stripes of 264 positions
# both sides run on one card in one precision, and their f64 reads round
# once to f32: beside the `check` rule, the logits are held within this
# share of the largest magnitude
SP_TIGHT = 1e-5


def _sp_run(model, params, cache, toks, steps: int, sync) -> tuple:
    """Prefill ``toks`` into ``cache``, then ``steps`` greedy decode steps
    fed the prefill's argmax chain → (logits a step, decode ms a step)."""
    with torch.no_grad():
        cache, lg, nxt = model.prefill(params, {"tokens": toks}, cache)
        out, ms = [lg.float().cpu()], []
        tok, pos = lg.argmax(-1).to(torch.int32), nxt.to(torch.int32)
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, tok, pos)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
            out.append(lg.float().cpu())
            tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    return out, ms


def sp_decode(model, params) -> dict:
    """SP-decode on the card: the one-shot decode cache of Qwen2.5-0.5B at
    full width (its serving phases' layers and RTN int4 weights) striped
    along the sequence over a (1 × 2) mesh whose two shards share cuda:0
    (`shard_cache`: stripes of 264 of 528 positions), B 8 prefilled with
    512 tokens (K4), then greedy decode steps; each stripe reads its keys
    and the partials combine in f64 in shard order. Held against the
    unsharded one-shot decode by the `check` rule (logits within 5 % of
    the largest magnitude, argmax equal on rows whose margin clears
    twice that) and within `SP_TIGHT` of the largest magnitude, prefill
    and every step; the collective counter's bytes of the SP prefill and
    steps beside the step times; K4's launches of both prefills."""
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (
        SP_BATCH, SP_PROMPT)).astype(np.int32)).to("cuda")
    mesh = make_host_mesh(1, 2, devices=["cuda:0"] * 2)
    k4_before = k4.COUNTER.count
    ref, ref_ms = _sp_run(model, params, model.init_cache(
        SP_BATCH, SP_MAX_SEQ, device="cuda"), toks, SP_STEPS,
        torch.cuda.synchronize)
    cache = shard_cache(model.init_cache(SP_BATCH, SP_MAX_SEQ,
                                         device="cuda"), mesh)
    kv = cache["seg_0"][0]["kv"]["k"]
    if not (isinstance(kv, list) and len(kv) == 2
            and kv[0].shape[1] == SP_MAX_SEQ // 2):
        raise AssertionError(f"sp_decode: cache not striped ({type(kv)})")
    with count_collectives() as counted:
        got, ms = _sp_run(model, params, cache, toks, SP_STEPS,
                          torch.cuda.synchronize)
    checks = {}
    for i, (g, r) in enumerate(zip(got, ref)):
        checks[f"step{i}"] = _check_rule(i, g, r, "sp_decode")
        tight = SP_TIGHT * float(r.abs().max())
        if not checks[f"step{i}"]["max_abs_err"] <= tight:
            raise AssertionError(
                f"sp_decode step {i}: err {checks[f'step{i}']['max_abs_err']}"
                f" > {tight} ({SP_TIGHT} of the largest magnitude)")
        checks[f"step{i}"]["tight_tol"] = tight
    return dict(mesh=[1, 2], batch=SP_BATCH, prompt=SP_PROMPT,
                max_seq=SP_MAX_SEQ, layers=model.cfg.num_layers,
                stripes=[list(t.shape) for t in kv], check=checks,
                decode_step_ms=ms, unsharded_decode_step_ms=ref_ms,
                k4_launches=k4.COUNTER.count - k4_before,
                collectives=collective_costs(counted),
                collective_calls=dict(counted.calls))


# ------------------------------------------------------- phase tp_oneshot
# the placed step's logits against the unsharded one-shot run's: beside
# the `check` rule, within this share of the largest magnitude (the shards'
# row-parallel partials come out of K1 in f32 and sum in f32 on the card,
# where the unsharded product sums its whole K inside one K1 call; the
# largest measured on an H100 was 8.95e-3, K1's sums being deterministic)
TPO_TIGHT = 1.2e-2
# the other families: (arch, layers, B, prompt), 8 decode steps each
TPO_FAMILIES = (("deepseek-v2-lite-16b", 2, 2, 256),
                ("mamba2-130m", 4, 2, 256), ("hymba-1.5b", 2, 2, 256))
TPO_STEPS = 8
TPO_NAMES = ("awq_matmul", "awq_gateup", "flash_attention")


def _tpo_run(model, params, batch: dict, max_seq: int, steps: int,
             mesh=None, tokens=None, tie=None, fused: bool = False) -> dict:
    """One-shot prefill into a fresh decode cache, then ``steps`` greedy
    decode steps: unsharded, or placed under ``mesh`` (`shard_params`,
    `place_cache`) and fed the unsharded run's ``tokens``. Launches and
    collectives of the prefill and of the steps apart, step ms, logits a
    call; with ``fused``, the last step once more through the
    fused-sample head (an attention model's cache takes the same rows
    again)."""
    b = next(iter(batch.values())).shape[0]
    kw, grid = {}, params
    cache = model.init_cache(b, max_seq, device="cuda")
    if mesh is not None:
        grid = shard_params(params, mesh, model.cfg)
        cache = place_cache(cache, mesh)
        kw = {"mesh": mesh}
    route = tie.record() if tie and mesh is None else \
        tie.force() if tie else contextlib.nullcontext()
    out = dict(logits=[], tokens=[], step_ms=[])
    with torch.no_grad(), route:
        torch.cuda.synchronize()
        reset_counts()
        qlinear.COUNTS.kernel = qlinear.COUNTS.generic = 0
        with count_collectives() as pre:
            cache, lg, nxt = model.prefill(grid, batch, cache, **kw)
        torch.cuda.synchronize()
        out["prefill_launches"] = read_counts(TPO_NAMES)
        out["logits"].append(lg.float().cpu())
        pos = nxt.to(torch.int32)
        reset_counts()
        with count_collectives() as dec:
            for i in range(steps):
                tok = (lg.argmax(-1).to(torch.int32) if tokens is None
                       else tokens[i])
                out["tokens"].append(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = model.decode_step(grid, cache, tok, pos, **kw)
                torch.cuda.synchronize()
                out["step_ms"].append(1e3 * (time.perf_counter() - t0))
                out["logits"].append(lg.float().cpu())
                pos = pos + 1
        out["decode_launches"] = read_counts(TPO_NAMES)
        out["qlinear_calls"] = {"kernel": qlinear.COUNTS.kernel,
                                "generic": qlinear.COUNTS.generic}
        if fused:
            greedy, _ = model.decode_step(grid, cache, tok, pos - 1, **kw,
                                          greedy=True)
            out["fused_sample"] = greedy.cpu()
    out["collectives"] = dict(prefill=collective_costs(pre),
                              prefill_calls=dict(pre.calls),
                              per_step=collective_costs(dec)["total"] / steps,
                              step_calls=dict(dec.calls))
    out["cache"] = cache
    return out


def _tpo_compare(label: str, ref: dict, got: dict, tight=None) -> dict:
    """The `check` rule (and, given, ``tight`` of the largest magnitude),
    prefill and every step; the largest error over the largest magnitude;
    the rows whose argmax the placed run keeps at every step (a greedy
    stream that would not part from the unsharded one)."""
    checks, err, same = {}, 0.0, None
    for i, (g, r) in enumerate(zip(got["logits"], ref["logits"])):
        checks[f"step{i}"] = _check_rule(i, g, r, label)
        e = checks[f"step{i}"]["max_abs_err"]
        if tight is not None:
            bound = tight * float(r.abs().max())
            if not e <= bound:
                raise AssertionError(f"{label} step {i}: err {e} > {bound}"
                                     f" ({tight} of the largest magnitude)")
            checks[f"step{i}"]["tight_tol"] = bound
        err = max(err, e / float(r.abs().max()))
        agree = g.argmax(-1) == r.argmax(-1)
        same = agree if same is None else same & agree
    return dict(check=checks, max_err_over_max=err,
                equal_greedy_streams=[int(same.sum()), int(same.numel())])


def _tpo_family(arch: str, layers: int, b: int, prompt: int,
                mesh) -> dict:
    """One family at full width cut to ``layers``, RTN int4 (the pipeline
    at GS 64): the unsharded run, then the placed one fed its tokens (a
    MoE layer's routing imposed, `RouteTie`), under ``ALL_KERNEL``."""
    with _depth(arch, layers):
        cfg = get_config(arch)
    model = Model(cfg)
    params, _ = quantize_params(model.init(
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
    toks = torch.from_numpy(np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (b, prompt)).astype(np.int32)).to("cuda")
    max_seq = prompt + TPO_STEPS
    tie = RouteTie() if cfg.num_experts else None
    with qlinear.execution_config(ALL_KERNEL):
        ref = _tpo_run(model, params, {"tokens": toks}, max_seq, TPO_STEPS,
                       tie=tie)
        got = _tpo_run(model, params, {"tokens": toks}, max_seq, TPO_STEPS,
                       mesh=mesh, tokens=ref["tokens"], tie=tie)
    cmp = _tpo_compare(f"tp_oneshot {arch}", ref, got)
    layer = got["cache"]["seg_0"][0]
    placed = {f"{kind}/{name}": ([list(t.shape) for t in leaf]
                                 if isinstance(leaf, list)
                                 else list(leaf.shape))
              for kind, leaves in layer.items()
              for name, leaf in leaves.items()}
    out = dict(layers=layers, batch=b, prompt=prompt, max_seq=max_seq,
               cache_pieces_layer0=placed,
               prefill_launches=got["prefill_launches"],
               decode_launches=got["decode_launches"],
               qlinear_calls=got["qlinear_calls"],
               collectives=got["collectives"],
               decode_step_ms=got["step_ms"],
               unsharded_decode_step_ms=ref["step_ms"],
               unsharded_launches={k: ref["prefill_launches"][k]
                                   + ref["decode_launches"][k]
                                   for k in TPO_NAMES},
               routing=tie.report() if tie else None, **cmp)
    del params, ref, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_oneshot(model, params) -> dict:
    """The placed one-shot step on the card: Qwen2.5-0.5B at full width
    (its serving phases' layers, RTN int4) on a (1 × 2) mesh whose two
    shards share cuda:0: the parameters by `param_pspec` (`shard_params`)
    and the decode cache by `cache_pspec` (`place_cache`: k / v along S,
    2 stripes of 264 of 528 positions), B 8 prefilled with 512 tokens,
    then `SP_STEPS` decode steps fed the unsharded run's greedy tokens.
    Held against the unsharded one-shot run by the `check` rule and
    within `TPO_TIGHT` of the largest magnitude, prefill and every step;
    gated besides: K4 launched twice a layer in the placed prefill (once
    a shard, on its 7 of 14 heads), every quantized linear on K1 / K3
    on the shards' stripes (``ALL_KERNEL``: no ``qlinear_calls`` on the
    generic path), the fused-sample head's tokens the argmax of the last
    step's logits. Reported: the collective counter's bytes of
    the prefill and of a step, step ms against the unsharded step's, the
    rows that keep the unsharded greedy token at every step. Then
    `TPO_FAMILIES`: one placed prefill and `TPO_STEPS` steps each of
    deepseek-v2-lite (MLA + MoE, latents along S), mamba2 (state over
    heads, conv caches over channels) and hymba (windowed rings and SSD;
    25 q heads stay whole over 2, its 50 SSM heads split) at full width,
    RTN, B 2 × 256 under the `check` rule."""
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        SP_BATCH, SP_PROMPT)).astype(np.int32)).to("cuda")
    mesh = make_host_mesh(1, 2, devices=["cuda:0"] * 2)
    with qlinear.execution_config(ALL_KERNEL):
        ref = _tpo_run(model, params, {"tokens": toks}, SP_MAX_SEQ,
                       SP_STEPS)
        got = _tpo_run(model, params, {"tokens": toks}, SP_MAX_SEQ,
                       SP_STEPS, mesh=mesh, tokens=ref["tokens"],
                       fused=True)
    cmp = _tpo_compare("tp_oneshot", ref, got, TPO_TIGHT)
    pre, dec = got["prefill_launches"], got["decode_launches"]
    calls = got["qlinear_calls"]
    kv = got["cache"]["seg_0"][0]["kv"]["k"]
    fused_ok = torch.equal(got["fused_sample"],
                           got["logits"][-1].argmax(-1).to(torch.int32))
    if not (pre["flash_attention"] == 2 * cfg.num_layers
            and dec["flash_attention"] == 0
            and calls["generic"] == 0 and pre["awq_matmul"] > 0
            and pre["awq_gateup"] > 0 and dec["awq_matmul"] > 0
            and dec["awq_gateup"] > 0
            and isinstance(kv, list) and len(kv) == 2
            and kv[0].shape[1] == SP_MAX_SEQ // 2 and fused_ok):
        raise AssertionError(f"tp_oneshot: prefill launches {pre}, decode "
                             f"{dec}, qlinear {calls}, fused-sample "
                             f"{fused_ok}")
    out = dict(mesh=[1, 2], batch=SP_BATCH, prompt=SP_PROMPT,
               max_seq=SP_MAX_SEQ, layers=cfg.num_layers,
               stripes=[list(t.shape) for t in kv],
               prefill_launches=pre, decode_launches=dec,
               qlinear_calls=calls, fused_sample_equal=fused_ok,
               collectives=got["collectives"],
               decode_step_ms=got["step_ms"],
               unsharded_decode_step_ms=ref["step_ms"],
               unsharded_launches={k: ref["prefill_launches"][k]
                                   + ref["decode_launches"][k]
                                   for k in TPO_NAMES}, **cmp)
    del ref, got
    gc.collect()
    torch.cuda.empty_cache()
    out["families"] = {arch: _tpo_family(arch, layers, b, prompt, mesh)
                       for arch, layers, b, prompt in TPO_FAMILIES}
    # every launch of the phase's runs, placed and unsharded
    out["launches"] = {k: out["prefill_launches"][k]
                       + out["decode_launches"][k]
                       + out["unsharded_launches"][k]
                       + sum(f["prefill_launches"][k]
                             + f["decode_launches"][k]
                             + f["unsharded_launches"][k]
                             for f in out["families"].values())
                       for k in TPO_NAMES}
    return out


# ----------------------------------------------------------- phase dryrun
def dryrun_check() -> dict:
    """The dry run's bytes a device against the card. Qwen2.5-0.5B at full
    size (24 layers, AWQ-packed shapes at GS 64: RTN here, the same
    shapes) on a (1 × 2) serving mesh: `launch.specs.param_specs`' bytes
    a device against what `shard_params` allocates when it puts both
    shards on cuda:0 (two devices' worth). Each shard's storages must hold
    the rules' bytes exactly (a packed linear's bias, which the rule
    replicates, is a shard's view of its own whole copy), the bytes the
    allocator was asked for (its ``requested_bytes``) must be twice that,
    and `torch.cuda.memory_allocated`'s growth may exceed them only by the
    caching allocator's rounding: 512 B an allocation, and under 1 MiB for
    one of 1 MiB or more (such a block is not split when its remainder is
    at most 1 MiB). Then one dry-run cell (Qwen's decode_32k on the
    16 × 16 production mesh of ``meta`` devices): every kernel wrapper
    takes its plain path there, so no launch is counted."""
    cfg = get_config("qwen25-05b")
    mesh = serving_mesh(2, devices=["cuda:0"] * 2)
    dry = dryrun_specs.shard_bytes(dryrun_specs.param_specs(
        cfg, mesh, True))
    model = Model(cfg)
    params, _ = quantize_params(model.init(
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
    params = tree_to(params, "cpu")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    req_key = "requested_bytes.all.current"
    before = torch.cuda.memory_allocated()
    req_before = torch.cuda.memory_stats().get(req_key)
    shards = shard_params(params, mesh, cfg)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    req_after = torch.cuda.memory_stats().get(req_key)
    requested = (None if req_before is None or req_after is None
                 else req_after - req_before)
    stored, slack = [], 0
    for shard in shards:
        storages = {}
        for _, parts, leaf in layer_parts(shard):
            for t in parts if parts is not None else [leaf]:
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        stored.append(sum(storages.values()))
        slack += sum((1 << 20) if b >= (1 << 20) else 512
                     for b in storages.values())
    want = 2 * dry
    if stored != [dry, dry] or (requested is not None and requested != want):
        raise AssertionError(f"dryrun: shards store {stored} B, "
                             f"{requested} B requested; the rules give "
                             f"{dry} a device")
    if not 0 <= grown - want <= slack:
        raise AssertionError(f"dryrun: {grown} B allocated for two shards, "
                             f"the rules give {want} (+ at most {slack} of "
                             f"the allocator's rounding)")
    del shards, params
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    rec = dryrun.run_cell("qwen25-05b", "decode_32k", "single", True, None)
    cell_s = time.perf_counter() - t0
    launched = read_counts(ALL_COUNTERS)
    if any(launched.values()):
        raise AssertionError(f"dryrun on meta launched kernels {launched}")
    return dict(param_bytes_per_device=dry, stored_per_shard=stored,
                allocated_two_shards=grown, requested_two_shards=requested,
                rounding_bytes=grown - want, rounding_bound=slack,
                decode_32k={k: rec[k] for k in (
                    "chips", "memory_analysis", "collectives",
                    "compute_s", "memory_s", "collective_s", "dominant")},
                decode_32k_s=cell_s, launches=launched)


# ------------------------------------------------------- phase glm4_smoke
# glm4-9b's smoke config (2 layers, d 128, 4 q / 2 kv heads of 32, max_seq
# 128): the one config whose head dim is 32
GLM4_SMOKE_TRAIN = ["--arch", "glm4-9b", "--smoke", "--steps", "8",
                    "--batch", "4", "--seq", "128", "--lr", "3e-3",
                    "--warmup", "2", "--log-every", "100"]
GLM4_SMOKE_SERVE = ["--arch", "glm4-9b", "--smoke", "--quant", "awq",
                    "--batch", "4", "--prompt-len", "64", "--max-new", "16"]
GLM4_SMOKE_SPEC = dict(serve_lens=[16, 45, 33, 60, 20, 50, 9, 40],
                       max_seq=128, chunk=16)


def glm4_smoke() -> dict:
    """glm4-9b's smoke config through the launchers on the card: the
    train launcher's steps (K4 forward and remat, K4b backward, all at hd
    32) with a finite, falling loss and no recovery; the serve launcher's
    AWQ path (calibration and generate()'s prefill on K4); the engine's
    greedy burst over int8 pages (K2 at hd 32, `dense_serve`'s gates:
    first tokens equal to generate()'s where the `check` rule's margin is
    clear); and the `check` rule between card and CPU (`dense_check`: a
    chunk step pair over int8 pools and a prefill). Counts start at 0
    before each path and are read after it."""
    cfg = configs.get_smoke_config("glm4-9b")
    if cfg.head_dim != 32:
        raise AssertionError(f"glm4-9b smoke head dim {cfg.head_dim}")
    names = [*COUNTERS, "flash_attention_bwd"]
    reset_counts()
    t0 = time.perf_counter()
    tr = train_launcher.main(GLM4_SMOKE_TRAIN)
    train_s = time.perf_counter() - t0
    train_l = read_counts(names)
    losses = tr["losses"]
    steps = int(GLM4_SMOKE_TRAIN[GLM4_SMOKE_TRAIN.index("--steps") + 1])
    if not (tr["recoveries"] == 0 and tr["steps"] == steps
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]
            and train_l["flash_attention"] > 0
            and train_l["flash_attention_bwd"] > 0):
        raise AssertionError(f"glm4_smoke train: {tr['recoveries']} "
                             f"recoveries, losses {losses}, launches "
                             f"{train_l}")
    reset_counts()
    t0 = time.perf_counter()
    out = launcher.main(GLM4_SMOKE_SERVE)
    launch_s = time.perf_counter() - t0
    launch_l = read_counts(names)
    by_step = out["launches"]
    toks = out["tokens"]
    if not (by_step["calibrate"]["flash_attention"] >= cfg.num_layers
            and by_step["generate"]["flash_attention"] >= cfg.num_layers
            and out["shape"] == [4, 16]
            and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"glm4_smoke launch: {by_step}, shape "
                             f"{out['shape']}")
    model, params = Model(cfg), out["params"]
    served = dense_serve("glm4-9b", model, params, GLM4_SMOKE_SPEC)
    serve_l = {n: sum(served[c]["launches"].get(n, 0)
                      for c in ("default", "all_kernel")) for n in names}
    if not serve_l["paged_attention_chunk"] > 0:
        raise AssertionError(f"glm4_smoke serve: launches {serve_l}")
    checked = dense_check("glm4-9b", model, params)
    launches = {n: train_l[n] + launch_l[n] + serve_l[n] for n in names}
    return dict(config=cfg.name, head_dim=cfg.head_dim,
                heads=[cfg.num_heads, cfg.num_kv_heads],
                train_args=" ".join(GLM4_SMOKE_TRAIN), losses=losses,
                train_s=train_s, recoveries=tr["recoveries"],
                serve_args=" ".join(GLM4_SMOKE_SERVE), launch_s=launch_s,
                tokens_per_s=out["tokens_per_s"], sample=toks[0].tolist(),
                serve=served, check=checked,
                launches_by_path=dict(train=train_l, launch=launch_l,
                                      serve=serve_l),
                launches=launches)


@torch.no_grad()
def encoder_forward(model, params, spec: dict) -> dict:
    """hubert-xlarge's serving output on the card: `forward_logits`, then
    a timed `Model.prefill` (its KV cache sized at the batch's S, as the
    reference writes one for an encoder too), on the data pipeline's
    seeded features batch of B × S frames (2 × 1,024: about 20 s of 50 Hz
    frames each), from 0 counts each. Gated: logits ``[B, S, 504]``,
    finite, the two bit-equal (the same kernels on the same input); K4
    once a layer, every call with ``causal=False``; K1 on every quantized
    linear (289 in `forward_logits`; the prefill re-projects q, k and v
    for its cache: 3 more a layer); no K2, no K3."""
    cfg = model.cfg
    b, s = spec["forward"]
    feats = make_dataset(cfg, b, s, seed=SEED).batch_at(0)["features"]
    batch = {"features": torch.from_numpy(feats).to("cuda")}
    n_quant = _linear_counts(cfg)[0]
    layers = _k4_layers(cfg)
    names = [*COUNTERS, *EXPERT_COUNTERS]
    runs = {}
    for run in ("forward_logits", "prefill"):
        _reset_peak()
        reset_counts()
        K4_BIDIRECTIONAL["calls"] = 0
        t0 = time.perf_counter()
        if run == "prefill":
            cache = model.init_cache(b, s, device="cuda")
            _, logits, nxt = model.prefill(params, batch, cache)
            del cache
        else:
            logits = model.forward_logits(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[run] = dict(logits=logits, seconds=secs,
                         frames_per_s=b * s / secs,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         launches=read_counts(names),
                         k4_bidirectional=K4_BIDIRECTIONAL["calls"])
    fl, pf = runs["forward_logits"], runs["prefill"]
    if not (pf["logits"].shape == (b, s, cfg.vocab_size)
            and bool(torch.isfinite(pf["logits"]).all())
            and int(nxt[0]) == s):
        raise AssertionError(f"encoder forward: logits "
                             f"{tuple(pf['logits'].shape)}, next {nxt}")
    equal = torch.equal(fl["logits"], pf["logits"])
    if not equal:
        raise AssertionError(f"encoder forward: forward_logits and prefill "
                             f"differ by {float((fl['logits'] - pf['logits']).abs().max())}")
    for run, want_k1 in (("forward_logits", n_quant),
                         ("prefill", n_quant + 3 * layers)):
        got = runs[run]
        if not (got["launches"]["flash_attention"] == layers
                == got["k4_bidirectional"]
                and got["launches"]["awq_matmul"] == want_k1
                and got["launches"]["paged_attention_chunk"] == 0
                and got["launches"]["awq_gateup"] == 0):
            raise AssertionError(f"encoder {run}: kernels "
                                 f"{got['launches']}, {got['k4_bidirectional']}"
                                 f" bidirectional K4 (want K4 {layers}, "
                                 f"K1 {want_k1})")
    am = pf["logits"].argmax(-1)
    return dict(
        batch=b, frames=s, logits_shape=list(pf["logits"].shape),
        logits_bit_equal=equal, codewords_used=int(am.unique().numel()),
        **{run: {k: v for k, v in r.items() if k != "logits"}
           for run, r in runs.items()})


@torch.no_grad()
def vision_generate(model, params) -> dict:
    """`generate()` with images: the data pipeline's seeded batch of B 2
    (256 stub patch embeddings + 200 text tokens each: K4 at S 456 in
    every layer of the prefill), 32 greedy new tokens from position 456
    on, ``max_seq`` 512, from 0 counts. Gated: tokens in the vocabulary,
    K4 once a layer, K1 and K3 launched, no K2 (the dense cache)."""
    cfg = model.cfg
    batch = make_dataset(cfg, 2, 200, seed=SEED).batch_at(0)
    del batch["labels"]
    eng = GenerationEngine(model, params, max_seq=512)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate(batch, 32)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts([*COUNTERS, *EXPERT_COUNTERS])
    if toks.shape != (2, 32) or not ((toks >= 0)
                                     & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"vision generate: bad tokens {toks.shape}")
    if not (launches["flash_attention"] == _k4_layers(cfg)
            and launches["awq_matmul"] > 0 and launches["awq_gateup"] > 0
            and launches["paged_attention_chunk"] == 0):
        raise AssertionError(f"vision generate: kernels {launches}")
    return dict(batch=2, patches=cfg.num_patches, text_tokens=200,
                new_tokens=32, prefill_positions=cfg.num_patches + 200,
                generate_s=secs, tokens_per_s=toks.size / secs,
                launches=launches, sample=toks[0][:8].tolist())


# ------------------------------------------------------------ phase tp_moe
TP_MOE_ARCH = "qwen2-moe-a2.7b"
EXPERT_SUMS = ("awq_matmul_experts", "awq_gateup_experts")


def _expert_bytes(params) -> tuple[int, int]:
    """(bytes of the routed experts' leaves a `model` rule splits, bytes
    of all their leaves) in ``params``."""
    split = whole = 0
    for seg in params["segments"].values():
        for lyr in seg:
            for lin in lyr.get("moe", {}).get("experts", {}).values():
                for f in ("qweight", "scales", "zeros", "input_scale"):
                    t = getattr(lin, f)
                    whole += t.nbytes
                    split += t.nbytes if f != "input_scale" else 0
    return split, whole


def _join_pools(shard_pools: list, mesh) -> dict:
    """The shards' page pools joined over KV heads (one unsharded pool
    tree, on the CPU): the `tp` phase's rule read on each leaf."""
    out = {}
    for seg, layers_ in shard_pools[0].items():
        out[seg] = []
        for i in range(len(layers_)):
            pool = {}
            for leaf, t in layers_[i]["kv_pool"].items():
                dim = -2 if leaf in ("k", "v") else -1
                pool[leaf] = torch.cat([sp[seg][i]["kv_pool"][leaf].cpu()
                                        for sp in shard_pools], dim=dim)
            out[seg].append({"kv_pool": pool})
    return out


def _tp_moe_check(model, params) -> dict:
    """The `check` rule on the model's first layer (both before the
    tp_families phase came: cut for the CPU side's time): the two chunk
    steps of the `check` phase, sharded over the 2-way mesh on the card
    (K3 / K1 on each shard's expert stripes, K2-TP) against the unsharded
    step on CPU copies, whose MoE layers take the card's routing
    (`RouteTie`); step 1 reads the card's committed pages on both
    sides."""
    model = Model(dataclasses.replace(model.cfg, num_layers=1))
    params = {**params, "segments": {"seg_0": params["segments"]["seg_0"][:1]}}
    mesh = tp_mesh()
    shards = shard_params(params, mesh, model.cfg)
    cpu_params = tree_to(params, "cpu")
    pools = model.init_paged_cache(17, 16, kv_quant="int8", mesh=mesh)
    cpu_pools = model.init_paged_cache(17, 16, kv_quant="int8",
                                       device="cpu")
    res = {}
    for step, (toks, pos, sidx) in enumerate(
            _check_inputs(model.cfg.vocab_size)):
        if step == 1:
            cpu_pools = _join_pools(pools, mesh)
        tie = RouteTie()
        with torch.no_grad():
            with tie.record():
                lg, pools = model.chunk_step(
                    shards, pools, toks.cuda(), pos.cuda(), sidx.cuda(),
                    page_table=CHECK_TABLE.cuda(), mesh=mesh)
            with tie.force():
                ref, cpu_pools = model.chunk_step(
                    cpu_params, cpu_pools, toks, pos, sidx,
                    page_table=CHECK_TABLE)
        res[f"step{step}"] = dict(_check_rule(
            step, lg.float().cpu(), ref.float(), "tp_moe check"),
            routing=tie.report())
    return res


def _tp_moe_forward(model, params) -> dict:
    """The packed `forward_logits` under a (data 2 × model 2) mesh, all
    four shards on cuda:0 (each replica its batch half, its experts split
    over ``model``), against the unsharded forward on the card, whose
    routing it takes (`RouteTie`: a near tie would send a token to
    another expert; flips counted): the `check` rule on every position's
    logits; K3 / K1 over the experts launched by every shard."""
    mesh = make_host_mesh(2, 2, devices=["cuda:0"] * 4)
    grid = [shard_params(params, rm, model.cfg)
            for rm in replica_meshes(mesh)]
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (4, 64))
                            .astype(np.int32)).cuda()
    tie = RouteTie()
    with torch.no_grad():
        # the unsharded forward a replica's half at a time (the same
        # routing calls, in the mesh's order: replica 0's layers, then
        # replica 1's), whose routing the sharded forward takes
        with tie.record():
            want = torch.cat([model.forward_logits(
                params, {"tokens": half}) for half in toks.split(2)])
        reset_counts()
        with tie.force():
            got = model.forward_logits(grid, {"tokens": toks}, mesh=mesh)
        torch.cuda.synchronize()
        launches = read_counts(EXPERT_SUMS)
    n = model.cfg.num_layers * 4
    if launches != dict.fromkeys(EXPERT_SUMS, n):
        raise AssertionError(f"tp_moe forward: expert launches {launches}, "
                             f"want {n} (a layer, a shard)")
    v = model.cfg.vocab_size
    return dict(mesh="(data 2 x model 2), four shards on cuda:0",
                tokens=list(toks.shape), launches=launches,
                routing=tie.report(),
                **_check_rule(0, got.reshape(-1, v).float().cpu(),
                              want.reshape(-1, v).float().cpu(),
                              "tp_moe forward"))


def tp_moe(model, params, spec: dict, served: dict) -> dict:
    """qwen2-moe at full width and 2 of 24 layers (the AWQ params of its
    phase) served tensor-parallel: the 8 seeded requests (`DENSE_NEW` new
    tokens each, as its serve phase) through the
    chunked engine on a 2-way ``model`` mesh whose shards share cuda:0,
    under the default threshold (the main path: counts from 0 here, read
    after), int8 pools. Gated: every shard launches K3 and K1 over its
    expert stripes wherever the unsharded engine launched them once (per
    step, twice the unsharded rate), K2-TP launched, the per-shard expert
    and pool bytes half the unsharded ones, first tokens equal to the
    unsharded engine's where generate()'s margin is clear (the `check`
    rule), the chunk steps of `check` within its rule against the CPU
    (`RouteTie`), and the packed forward under (2 × 2) within it against
    the unsharded forward. Counted: whole streams equal to the unsharded
    engine's."""
    mesh = tp_mesh()
    cfg = model.cfg
    prompts = dense_prompts(cfg.vocab_size, spec["serve_lens"])
    kw = dict(num_slots=4, page_size=16, max_seq=spec["max_seq"],
              prefill_chunk=spec["chunk"], kv_quant="int8")
    names = (*COUNTERS, *EXPERT_COUNTERS, *TP_COUNTERS)
    eng = GenerationEngine(model, params, mesh=mesh, **kw)
    _reset_peak()
    # the main path: counts start at 0 here and are read right after
    reset_counts()
    run = _serve_burst(eng, prompts, names, DENSE_NEW)
    peak = torch.cuda.max_memory_allocated()
    check_streams("tp_moe", run["out"], run["rids"], cfg.vocab_size,
                  DENSE_NEW)
    st = eng.stats()
    shard_bytes = [_expert_bytes(p) for p in eng._params_run]
    del eng
    gc.collect()
    base = served["default"]
    unsharded = {n: base["launches"][n] / base["steps"] for n in EXPERT_SUMS}
    per_step = {n: run["launches"][n] / run["steps"] for n in EXPERT_SUMS}
    if any(per_step[n] != 2 * unsharded[n] or not per_step[n]
           for n in EXPERT_SUMS) or not run["launches"][
               "paged_attention_chunk_sharded"]:
        raise AssertionError(f"tp_moe: expert launches a step {per_step}, "
                             f"unsharded {unsharded}; K2-TP "
                             f"{run['launches']}")
    split_all, whole_all = _expert_bytes(params)
    if any(2 * sb[0] != split_all for sb in shard_bytes) or \
            2 * st.kv_pool_bytes_per_device != base["kv_pool_bytes"]:
        raise AssertionError(f"tp_moe: expert bytes a shard {shard_bytes} "
                             f"of {split_all}; pool bytes a shard "
                             f"{st.kv_pool_bytes_per_device} of "
                             f"{base['kv_pool_bytes']}")
    refs = SERVED[TP_MOE_ARCH, "default"]
    streams = [run["out"][r] for r in run["rids"]]
    ties = []
    for rid, p, got, ref in zip(run["rids"], prompts, streams, refs):
        if got[0] != ref[0]:
            margin, scale = _first_margin(model, params, p, spec["max_seq"])
            if margin > 2 * 0.05 * scale:
                raise AssertionError(f"tp_moe: request {rid}: first token "
                                     f"{got[0]} != {ref[0]}, margin "
                                     f"{margin} of scale {scale}")
            ties.append(dict(request=rid, margin=margin, scale=scale))
    diffs = _first_diffs(streams, refs)
    checked = _tp_moe_check(model, params)
    forward = _tp_moe_forward(model, params)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        mesh="2-way model axis, both shards on cuda:0", layers=cfg.num_layers,
        requests=len(prompts), steps=run["steps"], serve_s=run["serve_s"],
        decode_step_ms=1e3 * run["decode_s"] / max(1, run["decode_steps"]),
        decode_tokens_per_s=run["decode_tokens"] / max(run["decode_s"],
                                                       1e-9),
        unsharded_decode_step_ms=base["decode_step_ms"],
        peak_mem_bytes=peak, launches=run["launches"],
        expert_launches_per_step=per_step,
        unsharded_expert_launches_per_step=unsharded,
        expert_bytes_per_shard=[sb[1] for sb in shard_bytes],
        expert_split_bytes_per_shard=[sb[0] for sb in shard_bytes],
        expert_bytes_unsharded=whole_all,
        kv_pool_bytes_per_device=st.kv_pool_bytes_per_device,
        kv_pool_bytes_unsharded=base["kv_pool_bytes"],
        identical_streams=sum(d is None for d in diffs), first_diffs=diffs,
        first_tokens_equal=len(prompts) - len(ties),
        first_token_ties=ties, check=checked, forward_2x2=forward)


def dense_models() -> tuple[dict, dict, dict]:
    """Phases 20-29: each model's launcher, serve burst and CPU check (the
    encoder: its launcher, forward and prefill check; phi-3-vision adds
    `generate()` with images), and `tp_moe` on qwen2-moe's params.
    Returns (per-model fields, per-model launches of K1 - K4, the tp_moe
    phase's fields)."""
    _count_windowed_k2()
    out, launches, tp_moe_fields = {}, {}, None
    for arch, spec in DENSE_ARCHS.items():
        t = time.perf_counter()
        launched, params, model = dense_launch(arch, spec)
        names = (*COUNTERS, *EXPERT_COUNTERS)
        if model.cfg.is_encoder:
            forward = encoder_forward(model, params, spec)
            cm, cp, pick = _cut_two_layers(model, params)
            fields = dict(launch=launched, forward=forward, layers=pick,
                          check_prefill=check_prefill(cm, cp),
                          phase_s=time.perf_counter() - t)
            phase(arch, **fields)
            out[arch] = fields
            launches[arch] = {
                n: launched["launches"][n]
                + sum(forward[r]["launches"][n]
                      for r in ("forward_logits", "prefill"))
                for n in names}
            del params, model, cm, cp
            gc.collect()
            torch.cuda.empty_cache()
            continue
        images = (vision_generate(model, params)
                  if model.cfg.frontend == "vision" else None)
        served = dense_serve(arch, model, params, spec)
        checked = dense_check(arch, model, params)
        prof = (profile_dense_decode(model, params)
                if arch == "gemma3-4b" else None)
        fields = dict(launch=launched, serve=served, **checked,
                      phase_s=time.perf_counter() - t)
        if images is not None:
            fields["generate_images"] = images
        if prof is not None:
            fields["profile_decode_step"] = prof
        phase(arch, **fields)
        out[arch] = fields
        if arch == TP_MOE_ARCH:
            tp_moe_fields = tp_moe(model, params, spec, served)
            phase("tp_moe", **tp_moe_fields)
        launches[arch] = {
            n: launched["launches"][n] + served["default"]["launches"][n]
            + served["all_kernel"]["launches"][n]
            + (images["launches"][n] if images else 0)
            + (served["oneshot_bf16"]["launches"][n]
               if "oneshot_bf16" in served else 0)
            for n in names}
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches, tp_moe_fields


def _model_summary(f: dict) -> dict:
    """One model's phase line cut to the summary's numbers."""
    out = dict(phase_s=f["phase_s"], layers=f["launch"]["layers"],
               launch_s=f["launch"]["total_s"],
               launch_peak_mem_bytes=f["launch"]["peak_mem_bytes"],
               check_prefill=[f["check_prefill"]["max_abs_err"],
                              f["check_prefill"]["tol"]])
    if "forward" in f:                  # the encoder
        out.update({run: {k: f["forward"][run][k] for k in (
            "seconds", "frames_per_s", "peak_mem_bytes", "launches",
            "k4_bidirectional")} for run in ("forward_logits", "prefill")})
        return out
    out.update(
        generate_tokens_per_s=f["launch"]["tokens_per_s"],
        **{f"serve_{name}": {k: f["serve"][name][k] for k in (
            "decode_step_ms", "decode_tokens_per_s", "serve_s",
            "identical_streams", "peak_mem_bytes", "k2_windowed_calls")}
           for name in ("default", "all_kernel")},
        check=[f["check"]["step1"]["max_abs_err"],
               f["check"]["step1"]["tol"]])
    if "oneshot_bf16" in f["serve"]:
        out["oneshot_bf16"] = {k: f["serve"]["oneshot_bf16"][k] for k in (
            "identical_streams", "first_diffs")}
    if "generate_images" in f:
        out["generate_images"] = {k: f["generate_images"][k] for k in (
            "generate_s", "tokens_per_s", "launches")}
    return out


def profile_dense_decode(model, params, steps: int = PROFILE_STEPS
                         ) -> dict:
    """A decode step of 4 slots at contexts ~1,100 (past the window of
    gemma3's local layers), profiled as `profile` profiles Qwen2.5's."""
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=2048, prefill_chunk=64, kv_quant="int8")
    rng = np.random.default_rng(SEED + 6)
    for _ in range(4):
        eng.submit(rng.integers(0, model.cfg.vocab_size, 1100)
                   .astype(np.int32), 64)
    while eng.stats().prefill_tokens < 4 * 1100:
        eng.step()
    eng.step()
    return dict(slots=4, context=1100, **_profile_steps(eng, steps))


# ------------------------------------------------------------ K4b, train
# K4b at the train path's shapes (model, B, S, H, Hkv, hd, window,
# causal): Qwen2.5-0.5B's (B 8, S 512, the train phase's batch), gemma3-4b's
# windowed layers (hd 256, window 1,024), then train_families' attention:
# hubert-xlarge (hd 80, bidirectional), phi-3-vision (hd 96 over 256
# patches + 256 tokens), hymba (G 5, its windowed and global layers) and
# qwen2-moe (hd 128, G 1)
# K4b's head dims whose tensor-core kernels must spill nothing
K4B_NO_SPILL = (32, 64, 80, 96, 128)
K4B_SHAPES = [("qwen25-05b", 8, 512, 14, 2, 64, 0, True),
              ("gemma3-4b", 1, 1400, 8, 4, 256, 1024, True),
              ("hubert-xlarge", 2, 1024, 16, 16, 80, 0, False),
              ("phi-3-vision-4.2b", 2, 512, 32, 32, 96, 0, True),
              ("hymba-1.5b", 2, 1536, 25, 5, 64, 1024, True),
              ("hymba-1.5b", 2, 1536, 25, 5, 64, 0, True),
              ("qwen2-moe-a2.7b", 2, 1024, 16, 16, 128, 0, True),
              # hd 32: glm4-9b's smoke config (4 q / 2 kv heads, S 128,
              # the glm4_smoke phase's train batch) and one larger shape
              *HD32_K4B]


def _sdpa_bwd_ms(q, k, v, do, window: int, causal: bool = True,
                 iters: int = 5) -> float:
    """Device ms of the backward of `scaled_dot_product_attention` (causal
    or not, GQA; a boolean mask where windowed) on the same tensors, made
    contiguous: the profiler's device time of every kernel the backward
    launches, over ``iters`` calls."""
    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    s = q.shape[2]
    mask_kw = (dict(attn_mask=k4.visibility(s, causal=causal, window=window,
                                            device="cuda"))
               if window else dict(is_causal=causal))
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, enable_gqa=True, **mask_kw)

    def grad():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    grad()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(iters):
            grad()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kern) / 1e3 / iters


def check_k4b(gen) -> tuple[dict, dict]:
    """K4b against its plain version from the same forward (K4's output
    and lse), at the train path's shapes; timed beside the plain version
    and SDPA's backward; each shape with ptxas' registers and spill bytes
    of the two bf16 kernels at its head dim (the build's report)."""
    regs = PHASES.get("build", {}).get("k4b_kernels", {})
    per_shape = []
    for arch, b, s, h, hkv, hd, window, causal in K4B_SHAPES:
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2)
                   for n in (h, hkv, hkv))
        do = torch.randn(b, h, s, hd, generator=gen, device="cuda").to(
            torch.bfloat16)
        kw = dict(causal=causal, window=window)
        out, lse = k4._forward(q, k, v, hd ** -0.5, causal, window, True)
        args = (q, k, v, out, lse, do)
        got = k4.flash_attention_bwd(*args, **kw)
        want = k4.flash_attention_bwd_ref(*args, **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.float() - w.float()).abs().max())
            lim = 2e-2 * float(w.float().abs().max())
            if not err <= lim:
                raise AssertionError(f"K4b {arch} {name}: err {err} > {lim}")
            errs[name] = [err, lim]
        again = k4.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"K4b {arch}: two calls differ")
        ms = time_ms(lambda i: k4.flash_attention_bwd(*args, **kw), 1)
        plain = time_ms(lambda i: k4.flash_attention_bwd_ref(*args, **kw), 1,
                        iters=5)
        lib = _sdpa_bwd_ms(q, k, v, do, window, causal)
        pairs = int(k4.visibility(s, causal=causal, window=window,
                                  device="cuda").sum())
        # per visible (query, key) pair and head: the five products (S,
        # dO V^T, dV, dK, dQ) of 2 * hd flops each on bf16 inputs
        flops = 5 * 2 * hd * h * b * pairs
        nbytes = (sum(t.nbytes for t in args) + sum(t.nbytes for t in got))
        b_ms, b_by = bound(nbytes, (flops, BF16_OPS_PER_S))
        ptxas = {n: r for n, r in regs.items()
                 if "mma" in n and n.endswith(f"<bf16, {hd}>")}
        per_shape.append(dict(
            model=arch, b=b, s=s, h=h, hkv=hkv, hd=hd, window=window,
            causal=causal, max_abs_err=max(e for e, _ in errs.values()),
            errs=errs, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
            ptxas=ptxas, spill_bytes=sum(
                r.get("spill_stores", 0) + r.get("spill_loads", 0)
                for r in ptxas.values())))
    qwen = per_shape[0]
    entry = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:118",
        max_abs_err=max(c["max_abs_err"] for c in per_shape),
        ms=qwen["ms"], plain_ms=qwen["plain_ms"], bound_ms=qwen["bound_ms"],
        bound_by=qwen["bound_by"], library_ms=qwen["library_ms"])
    detail = dict(
        at="the train phase's attention: B 8, S 512, H 14 / Hkv 2, hd 64, "
           "bf16, causal; then gemma3-4b's windowed layers and the "
           "train_families phase's attention (hubert hd 80 bidirectional, "
           "phi-3-vision hd 96, hymba G 5 windowed and global, qwen2-moe "
           "hd 128)",
        replaces_note="no TPU kernel: the reference trains through the jnp "
                      "attention at that line, which XLA differentiates; "
                      "K4b is the gradient of K4 "
                      "(src/repro/kernels/flash_attention.py:108)",
        tolerance="each of dq, dk, dv within 2e-2 of its largest plain "
                  "magnitude (bf16 outputs of f32 math); two calls equal "
                  "bit for bit",
        bound="the larger of: bytes of q, k, v, o, dO, lse read and dq, dk, "
              "dv written once at 3.35 TB/s; per visible (query, key) pair "
              "and head five products of 2*hd flops at 989 TFLOP/s (bf16 "
              "inputs); the kernel runs them on tensor cores (mma.sync), "
              "recomputing S and dP^T once more for dQ and splitting the f32 "
              "P and dS into two bf16 halves: ~2x those flops issued",
        library_call="the backward kernels of torch SDPA (is_causal, or a "
                     "boolean mask where windowed; enable_gqa) on the same "
                     "bf16 tensors, made contiguous, by the profiler",
        shapes=per_shape)
    return entry, detail


# train's and train_mesh's Qwen2.5-0.5B: full width, 8 of its 24 layers,
# 10 steps (24 layers and 20 steps before the tp_families phase came: cut
# for the time limit; its checkpoints' bytes follow the depth)
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 10
TRAIN_OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=200, weight_decay=0.0)
TRAIN_COUNTERS = ("flash_attention", "flash_attention_bwd")


class _Trainer:
    """Train steps as `_profile_steps` drives engine steps: each `step()`
    takes the next batch and ends synchronized."""

    def __init__(self, step_fn, state, ds, first: int):
        self.step_fn, self.state, self.ds, self.i = step_fn, state, ds, first

    def step(self):
        self.state, _ = self.step_fn(self.state, self.ds.batch_at(self.i))
        self.i += 1
        torch.cuda.synchronize()


def _train_setup():
    """train()'s model, state from seed 0, dataset and step function."""
    cfg = dataclasses.replace(get_config("qwen25-05b"),
                              num_layers=TRAIN_LAYERS)
    if not cfg.remat:
        raise AssertionError("train: the config does not remat")
    model = Model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    ds = make_dataset(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED)
    step_fn = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**TRAIN_OPT), grad_comm_dtype="bfloat16"))
    return cfg, model, state, ds, step_fn


def train_profile(warm: int = 3, steps: int = 2) -> dict:
    """``steps`` train steps at train()'s settings, bare and then profiled,
    after ``warm`` steps (``--k4b-only``)."""
    _, _, state, ds, step_fn = _train_setup()
    trainer = _Trainer(step_fn, state, ds, 0)
    del state
    for _ in range(warm):
        trainer.step()
    prof = _profile_steps(trainer, steps)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return prof


def train() -> dict:
    """Qwen2.5-0.5B training at full width and `TRAIN_LAYERS` of its
    depth from seed 0: B 8 × S 512, bf16
    gradient casts, AdamW (the reference's descent settings), remat on,
    10 steps. Gated: every parameter gets a finite gradient at step 0,
    every loss finite, the last below the first by more than 0.3, K4 and
    K4b launched on every layer. Then one profiled step, and a 2-layer
    full-width cut's gradients on the card against CPU copies."""
    cfg, model, state, ds, step_fn = _train_setup()
    batch0 = {k: torch.as_tensor(v, device="cuda")
              for k, v in ds.batch_at(0).items()}
    _, _, grads = loss_and_grads(model, state["params"], batch0)
    missing = missing_grads(grads)
    n_leaves = len(list(layer_parts(grads)))
    finite = all(bool(torch.isfinite(g).all()) for _, g in
                 flatten_with_paths(grads))
    if missing or not finite:
        raise AssertionError(f"train: step 0's gradient missing {missing} "
                             f"or not finite ({finite})")
    del grads
    _reset_peak()
    reset_counts()
    losses, step_s = [], []
    t_all = time.perf_counter()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, ds.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    train_s = time.perf_counter() - t_all
    launches = read_counts(TRAIN_COUNTERS)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0] - 0.3:
        raise AssertionError(f"train: loss {losses[0]} -> {losses[-1]} did "
                             f"not fall by 0.3")
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    if per_step != {"flash_attention": 2 * cfg.num_layers,
                    "flash_attention_bwd": cfg.num_layers}:
        raise AssertionError(f"train: launches a step {per_step}, want K4 "
                             f"twice a layer (forward, remat) and K4b once")
    step_med = float(np.median(step_s[2:]))
    trainer = _Trainer(step_fn, state, ds, TRAIN_STEPS)
    del state
    prof = _profile_steps(trainer, 1)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config=cfg.name, layers=cfg.num_layers, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, steps=TRAIN_STEPS, optimizer=TRAIN_OPT,
                grad_comm_dtype="bfloat16", remat=True,
                step0_grad_leaves=n_leaves, first_loss=losses[0],
                last_loss=losses[-1], losses=losses, train_s=train_s,
                step_ms=[1e3 * x for x in step_s], step_ms_median=1e3 * step_med,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_med,
                peak_mem_bytes=peak, launches=launches,
                launches_per_step=per_step, profile_step=prof,
                check=train_check(model))


# train_check's batch: B 1 x S 64; a MoE model's S 16 (its CPU side runs
# every expert over a dropless capacity of S rows in f64: 16 since the
# tp_families phase came, for the script's time limit)
TRAIN_CHECK_SEQ, TRAIN_CHECK_SEQ_MOE = 64, 16


def train_check(model) -> dict:
    """A 2-layer full-width cut (layers 0 and 1 of a fresh seed-0 init; a
    MoE model's cut is 1 MoE layer, for the CPU side's time, PERF §4):
    one loss and gradient on the card (K4, K4b, remat) and on CPU copies
    (plain versions), B 1 × `TRAIN_CHECK_SEQ` (and a vision model's
    patches; a MoE model's S `TRAIN_CHECK_SEQ_MOE`). The two
    round to bf16 at other places, so each leaf's gradient is held within
    5 % of its largest CPU magnitude (the `check` rule), the loss too;
    every leaf present. A MoE layer's CPU side takes the card's routing
    (`RouteTie`; flips counted)."""
    cut = Model(dataclasses.replace(model.cfg, num_layers=2)
                if not model.cfg.num_experts else dataclasses.replace(
                    model.cfg, num_layers=1, first_dense_layers=0))
    params = cut.init(torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda")
    batch = make_dataset(cut.cfg, 1, TRAIN_CHECK_SEQ if not
                         cut.cfg.num_experts else TRAIN_CHECK_SEQ_MOE,
                         SEED).batch_at(0)
    tie = RouteTie()
    out = {}
    for d, prm in (("cuda", params), ("cpu", tree_to(params, "cpu"))):
        with _device_side(tie, d):
            loss, _, grads = loss_and_grads(
                cut, prm, {k: torch.as_tensor(v, device=d)
                           for k, v in batch.items()})
        if missing_grads(grads):
            raise AssertionError(f"train check: {d} gradient missing "
                                 f"{missing_grads(grads)}")
        # {reference path: the leaf, or its layers' leaves}
        out[d] = (float(loss), {path: [leaf] if parts is None else parts
                                for path, parts, leaf in layer_parts(grads)})
    worst, worst_path = 0.0, None
    for path, wants in out["cpu"][1].items():
        # compared on the card: a MoE layer's expert leaves hold ~5e8
        # elements, which the host's reductions take seconds over
        gots, wants = out["cuda"][1][path], [w.cuda() for w in wants]
        lim = 0.05 * max(float(w.abs().max()) for w in wants)
        err = max(float((g - w).abs().max()) for g, w in zip(gots, wants))
        if not (all(bool(torch.isfinite(g).all()) for g in gots)
                and err <= lim):
            raise AssertionError(f"train check {path}: err {err} > {lim}")
        rel = err / max(lim / 0.05, 1e-30)
        if rel >= worst:
            worst, worst_path = rel, path
    loss_err = abs(out["cuda"][0] - out["cpu"][0])
    if not loss_err <= 0.05 * abs(out["cpu"][0]):
        raise AssertionError(f"train check: loss {out['cuda'][0]} vs "
                             f"{out['cpu'][0]}")
    routing = tie.report()
    return dict(layers=cut.cfg.num_layers, leaves=len(out["cpu"][1]),
                loss=out["cuda"][0],
                cpu_loss=out["cpu"][0],
                worst_leaf=worst_path, worst_err_over_leaf_max=worst,
                **({"routing": routing} if routing["routed_calls"] else {}))


RESUME_ARGS = ["--arch", "qwen25-05b", "--steps", "8", "--batch", "8",
               "--seq", "512", "--ckpt-every", "4", "--simulate-failure-at",
               "6", "--log-every", "1"]
# train_resume's depth: 4 of Qwen's 24 layers at full width (its
# checkpoints' disk time, for the script's time limit: 12, then 4 since
# the tp_families phase came)
RESUME_LAYERS = 4


def train_resume() -> dict:
    """The train launcher at full width and `RESUME_LAYERS` of Qwen's
    depth: 8 steps, async checkpoints at 4 and 8, a failure injected at
    step 6 (recovered from step 4's checkpoint). Gated: one recovery, ≥ 4
    steps, LATEST = 8, the redone steps' losses equal the first run's bit
    for bit. Then one step on
    the restored state, a timed synchronous save and restore of the
    result, the restore equal to the saved arrays bit for bit, and one
    more step from each giving the same loss. The directory (inside the
    checkout's git-ignored build/) is deleted at the end."""
    d = ROOT / "build" / "train_resume"
    shutil.rmtree(d, ignore_errors=True)
    with _depth("qwen25-05b", RESUME_LAYERS):
        return _train_resume(d)


def _train_resume(d: pathlib.Path) -> dict:
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = train_launcher.main(RESUME_ARGS + ["--ckpt-dir", str(d)])
        launch_s = time.perf_counter() - t0
        launches = read_counts(TRAIN_COUNTERS)
        losses = out["losses"]
        # steps 0-5, then (after the failure at 6) 4-7 again
        if not (out["recoveries"] == 1 and out["steps"] >= 4
                and latest_step(str(d)) == 8):
            raise AssertionError(f"train_resume: {out} LATEST "
                                 f"{latest_step(str(d))}")
        redone_equal = losses[6:8] == losses[4:6]
        if not redone_equal:
            raise AssertionError(f"train_resume: redone steps 4, 5 give "
                                 f"{losses[6:8]}, first run {losses[4:6]}")
        npz = d / "step_00000008.npz"
        npz_bytes = npz.stat().st_size
        model = Model(get_config("qwen25-05b"))
        tpl = train_state_shapes(model)
        state, got = restore(str(d), tpl, device="cuda")
        ds = make_dataset(model.cfg, 8, 512, SEED)
        step_fn = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
            lr=1e-3, warmup_steps=20, decay_steps=8, weight_decay=0.0)))
        state, _ = step_fn(state, ds.batch_at(8))
        (d / "step_00000004.npz").unlink(missing_ok=True)   # disk room
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(str(d), 9, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = restore(str(d), tpl, step=9, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mine = state_to_arrays(state)
        with np.load(d / "step_00000009.npz") as blob:
            disk_equal = all(np.array_equal(blob[p], a)
                             for p, a in mine.items())
        back_equal = all(np.array_equal(a, mine[p])
                         for p, a in state_to_arrays(back).items())
        if not (disk_equal and back_equal):
            raise AssertionError(f"train_resume: saved {disk_equal}, "
                                 f"restored {back_equal} not bit-equal")
        del mine
        b9 = ds.batch_at(9)
        _, m1 = step_fn(state, b9)
        _, m2 = step_fn(back, b9)
        same_loss = float(m1["loss"]) == float(m2["loss"])
        if not same_loss:
            raise AssertionError(f"train_resume: {float(m1['loss'])} vs "
                                 f"{float(m2['loss'])} after restore")
        del state, back
        return dict(args=RESUME_ARGS, layers=model.cfg.num_layers,
                    launch_s=launch_s,
                    steps=out["steps"], recoveries=out["recoveries"],
                    losses=losses, step_ms=[1e3 * x for x in out["step_s"]],
                    latest=8, redone_losses_equal=redone_equal,
                    npz_bytes=npz_bytes, save_s=save_s, restore_s=restore_s,
                    restore_bit_equal=back_equal, disk_bit_equal=disk_equal,
                    resumed_loss_equal=same_loss, loss_after=float(m1["loss"]),
                    launches=launches)
    finally:
        shutil.rmtree(d, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# train_families: every family the port serves, trained at full width
# from seed 0 (model, layers kept of its depth, B, S: text tokens or
# frames; phi-3-vision prepends its 256 patches; AdamW's peak lr; steps);
# depth cuts for the time limit (PERF.md §4). hubert's labels are random
# codewords (the pipeline's): its stream has nothing to learn beyond the
# marginal, and its 48 layers' first Adam steps raise the loss at any lr
# (NVIDIA H100 80GB HBM3, 700.00 W: 6.70 -> 8.75 in 4 steps at lr 3e-3;
# at 1e-3 / 3e-4 / 1e-4, 7.40 / 6.93 / 6.71 after 4 steps and 6.64 /
# 6.45 / 6.39 after 6), so it takes 6 steps at 1e-4
TRAIN_FAMILIES = [("qwen2-moe-a2.7b", 2, 2, 1024, 3e-3, 4),
                  ("deepseek-v2-lite-16b", 2, 2, 1024, 3e-3, 4),
                  ("mamba2-130m", 24, 8, 512, 3e-3, 4),
                  ("hymba-1.5b", 4, 2, 1536, 3e-3, 4),
                  ("hubert-xlarge", 48, 2, 1024, 1e-4, 6),
                  ("phi-3-vision-4.2b", 8, 2, 256, 3e-3, 4)]


def train_family(arch: str, layers: int, b: int, s: int, lr: float,
                 steps: int) -> dict:
    """One model of `train_families`: a fresh seed-0 train state at full
    width and ``layers`` of its depth, ``steps`` steps of the
    pipeline's batches (bf16 casts, remat, AdamW at train()'s settings
    with peak ``lr``; a leaf without a gradient raises in the step).
    Gated: every loss
    finite, the last below the first, K4 twice and K4b once a step in
    each attention layer (none for the MLA and SSD models). Reported:
    losses, step ms (median of steps 1 on), tokens (frames, positions)
    a second, peak memory, launches a step, and the port cost model's
    seconds for the same step (`analytic_terms` of the cut config at a
    train cell of this B and S, the card's peaks) beside the measured
    step; then `train_check` on a 2-layer cut."""
    with _depth(arch, layers):
        cfg = get_config(arch)
    if not cfg.remat:
        raise AssertionError(f"train_families {arch}: no remat")
    model = Model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    ds = make_dataset(cfg, b, s, SEED)
    step_fn = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**dict(TRAIN_OPT, lr=lr)),
        grad_comm_dtype="bfloat16"))
    _reset_peak()
    reset_counts()
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, ds.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = read_counts(TRAIN_COUNTERS)
    peak = torch.cuda.max_memory_allocated()
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"train_families {arch}: losses {losses}")
    per_step = {n: c / steps for n, c in launches.items()}
    attn = _k4_layers(cfg)
    if per_step != {"flash_attention": 2 * attn,
                    "flash_attention_bwd": attn}:
        raise AssertionError(f"train_families {arch}: launches a step "
                             f"{per_step}, want K4 {2 * attn} and K4b "
                             f"{attn} ({attn} attention layers, remat)")
    seq = s + (cfg.num_patches if cfg.frontend == "vision" else 0)
    step_med = float(np.median(step_s[1:]))
    terms = costmodel.analytic_terms(
        cfg, configs.ShapeCell(f"train_{seq}x{b}", seq, b, "train"), 1,
        False)
    bound_s = max(terms["analytic_compute_s"], terms["analytic_memory_s"])
    return dict(
        config=cfg.name, layers=layers, of=get_config(arch).num_layers,
        batch=b, seq=seq, steps=steps, optimizer=dict(TRAIN_OPT, lr=lr),
        params=cfg.n_params(), attention_layers=attn, losses=losses,
        step_ms=[1e3 * x for x in step_s], step_ms_median=1e3 * step_med,
        tokens_per_s=b * seq / step_med, peak_mem_bytes=peak,
        launches=launches, launches_per_step=per_step,
        analytic_compute_s=terms["analytic_compute_s"],
        analytic_memory_s=terms["analytic_memory_s"],
        analytic_flops=terms["analytic_flops_global"],
        analytic_bytes=terms["analytic_bytes_global"],
        step_over_bound=step_med / bound_s, check=train_check(model))


def train_families() -> dict:
    """Phase 32: `train_family` for each of ``TRAIN_FAMILIES``, each
    model's state freed before the next."""
    out = {}
    for arch, layers, b, s, lr, steps in TRAIN_FAMILIES:
        t = time.perf_counter()
        out[arch] = dict(train_family(arch, layers, b, s, lr, steps),
                         phase_s=time.perf_counter() - t)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------- phase tp_families
# the families whose tensor parallelism came last: MLA + MoE, SSD, hybrid,
# the audio encoder, the VLM; each trains on a (1 x 2) mesh on cuda:0 at
# train_families' depth, B x S, lr and seed
TP_FAMILIES = ("deepseek-v2-lite-16b", "mamba2-130m", "hymba-1.5b",
               "hubert-xlarge", "phi-3-vision-4.2b")
TP_FAMILY_STEPS = 2
# the packed forward's batch (B, S; phi-3-vision's 256 patches before it)
TP_FORWARD_BS = (2, 64)
KERNEL_PATHS = ("awq_matmul", "awq_gateup")


def _leaf_bytes(tree) -> dict:
    return {path: [t.numel() * t.element_size()
                   for t in (parts if parts is not None else [leaf])]
            for path, parts, leaf in layer_parts(tree)}


def _split_halves(state, logical: dict) -> tuple[int, int, bool]:
    """Over the leaves the ``model`` rule splits: (bytes of one shard's
    pieces, their logical bytes, every shard's piece exactly half its
    leaf)."""
    grid = state["params"][0]
    mine = [_leaf_bytes(t) for t in grid]
    shard = whole = 0
    exact = True
    for path, sparts, sleaf in layer_parts(state.specs):
        if (sparts[0] if sparts is not None else sleaf)[0] is None:
            continue
        whole += sum(logical[path])
        shard += sum(mine[0][path])
        exact &= all(2 * b == w for m in mine
                     for b, w in zip(m[path], logical[path]))
    return shard, whole, exact


def _tp_family_train(arch: str, layers: int, b: int, s: int, lr: float,
                     want: list) -> dict:
    """``TP_FAMILY_STEPS`` steps of one family on the (1 x 2) mesh from the
    seed-0 state `train_family` starts from. Gated: each loss within 1e-3
    (relative) of the unsharded ``want``; K4 twice and K4b once a step in
    each attention layer on every shard whose heads split (hymba's 25 q
    heads do not: on the first shard); every split leaf exactly half its
    bytes a shard; replicated leaves bit-equal to the first shard's after
    the steps."""
    with _depth(arch, layers):
        cfg = get_config(arch)
    model = Model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    logical = _leaf_bytes(state["params"])
    mesh = make_host_mesh(1, 2, devices=["cuda:0"] * 2)
    state = TrainSharding(mesh, cfg).place(state)
    gc.collect()
    step_fn = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**dict(TRAIN_OPT, lr=lr)),
        grad_comm_dtype="bfloat16"), mesh=mesh)
    ds = make_dataset(cfg, b, s, SEED)
    _reset_peak()
    reset_counts()
    state, losses, step_s, _ = _mesh_steps(step_fn, state, ds,
                                           TP_FAMILY_STEPS)
    launches = read_counts(TRAIN_COUNTERS)
    peak = torch.cuda.max_memory_allocated()
    shard_b, whole_b, halves = _split_halves(state, logical)
    equal = _replicas_bit_equal(state)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {n: c / TP_FAMILY_STEPS for n, c in launches.items()}
    attn = _k4_layers(cfg) * (2 if cfg.num_heads % 2 == 0 else 1)
    want_launches = {"flash_attention": 2 * attn,
                     "flash_attention_bwd": attn}
    close = [abs(a - w) <= 1e-3 * abs(w) for a, w in zip(losses, want)]
    if not (all(close) and per_step == want_launches and halves and equal):
        raise AssertionError(
            f"tp_families {arch}: losses {losses} vs unsharded {want}, "
            f"launches a step {per_step} (want {want_launches}), split "
            f"leaves halved {halves}, replicated bit-equal {equal}")
    return dict(losses=losses, unsharded_losses=want,
                worst_rel_loss_diff=max(abs(a - w) / abs(w)
                                        for a, w in zip(losses, want)),
                step_ms=[1e3 * x for x in step_s], peak_mem_bytes=peak,
                launches=launches, launches_per_step=per_step,
                split_bytes_per_shard=shard_b, split_bytes_logical=whole_b,
                split_leaves_halved=halves, replicated_bit_equal=equal)


def _tp_family_forward(arch: str, layers: int) -> dict:
    """The RTN int4 model at the same depth: `forward_logits(mesh=)` on the
    (1 x 2) mesh against the unsharded packed forward on the card (the
    `check` rule over every position; a MoE layer takes the unsharded
    forward's routing, `RouteTie`), under the default threshold and with
    every quantized linear on K1 / K3 (``ALL_KERNEL``). Gated besides:
    under ``ALL_KERNEL`` no quantized linear takes the generic path and
    every kernel call is one K1 or K3 launch on a shard's stripe."""
    with _depth(arch, layers):
        cfg = get_config(arch)
    model = Model(cfg)
    params, _ = quantize_params(model.init(
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
    b, s = TP_FORWARD_BS
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in make_dataset(cfg, b, s, SEED).batch_at(0).items()
             if k != "labels"}
    mesh = make_host_mesh(1, 2, devices=["cuda:0"] * 2)
    grid = [shard_params(params, rm, cfg) for rm in replica_meshes(mesh)]
    v = cfg.vocab_size
    out = {}
    for name, ecfg in (("default", qlinear.ExecutionConfig()),
                       ("all_kernel", ALL_KERNEL)):
        tie = RouteTie()
        with qlinear.execution_config(ecfg), torch.no_grad():
            with tie.record():
                want = model.forward_logits(params, batch)
            torch.cuda.synchronize()
            reset_counts()
            qlinear.COUNTS.kernel = qlinear.COUNTS.generic = 0
            t0 = time.perf_counter()
            with tie.force():
                got = model.forward_logits(grid, batch, mesh=mesh)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            launches = read_counts(KERNEL_PATHS)
            paths = {"kernel": qlinear.COUNTS.kernel,
                     "generic": qlinear.COUNTS.generic}
        if name == "all_kernel" and not (
                paths["generic"] == 0 and launches["awq_matmul"] > 0
                and paths["kernel"] == sum(launches.values())
                and (launches["awq_gateup"] > 0) == _uses_k3(cfg)):
            raise AssertionError(f"tp_families {arch} forward: launches "
                                 f"{launches}, paths {paths}")
        out[name] = dict(
            launches=launches, qlinear_calls=paths, forward_ms=1e3 * fwd_s,
            routing=tie.report(),
            **_check_rule(0, got.reshape(-1, v).float().cpu(),
                          want.reshape(-1, v).float().cpu(),
                          f"tp_families {arch} forward"))
    del params, grid
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=[b, s], logits=[int(x) for x in got.shape], **out)


def tp_families(families: dict) -> dict:
    """Phase 33: `_tp_family_train` and `_tp_family_forward` for each of
    ``TP_FAMILIES`` at its `train_families` depth, B × S and lr, its
    losses held against that phase's first steps."""
    cut = {arch: (layers, b, s, lr)
           for arch, layers, b, s, lr, _ in TRAIN_FAMILIES}
    out = {}
    for arch in TP_FAMILIES:
        t = time.perf_counter()
        layers, b, s, lr = cut[arch]
        out[arch] = dict(
            layers=layers, batch=b, seq=s, mesh="(data 1 x model 2) on cuda:0",
            unsharded_step_ms_median=families[arch]["step_ms_median"],
            unsharded_peak_mem_bytes=families[arch]["peak_mem_bytes"],
            **_tp_family_train(arch, layers, b, s, lr,
                               families[arch]["losses"][:TP_FAMILY_STEPS]),
            forward=_tp_family_forward(arch, layers),
            phase_s=time.perf_counter() - t)
    return out


# ---------------------------------------------------------- phase train_mesh
TRAIN_MESH_STEPS = 4         # 6 before the tp_families phase came
# qwen2-moe's float experts under the mesh: 1 of 24 layers, B 2 x S 512 a
# data replica (PERF.md §4: the card's memory with four shards)
TRAIN_MESH_MOE = (1, 4, 512, 2)


def _leaves(tree) -> list:
    return [t for _, parts, leaf in layer_parts(tree)
            for t in (parts if parts is not None else [leaf])]


def _replicas_bit_equal(state) -> bool:
    """Every replica's shard m equal to replica 0's bit for bit, and a
    leaf the ``model`` shards replicate equal to its first shard's."""
    grid = state["params"]
    flat = [[list(layer_parts(t)) for t in rep] for rep in grid]
    for i, (_, sparts, sleaf) in enumerate(layer_parts(state.specs)):
        split = (sparts[0] if sparts is not None else sleaf)[0] is not None
        for r, m in np.ndindex(len(grid), len(grid[0])):
            _, parts, leaf = flat[r][m][i]
            _, parts0, leaf0 = flat[0][m if split else 0][i]
            if not all(torch.equal(a, b) for a, b in zip(
                    parts or [leaf], parts0 or [leaf0])):
                return False
    return True


def _mesh_steps(step_fn, state, ds, steps: int, first: int = 0):
    losses, step_s, wire = [], [], 0
    for i in range(first, first + steps):
        t0 = time.perf_counter()
        state, met = step_fn(state, ds.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        wire = met["wire_bytes"]
    return state, losses, step_s, wire


def _train_mesh_ckpt(model, state, step_fn, ds, at_step: int) -> dict:
    """Save the (2 x 2) state after ``at_step`` steps (its logical
    arrays), restore it onto a (1 x 2) mesh, and take the next step on
    both: the losses within 2e-2 relative. The directory (under the
    checkout's git-ignored build/) is deleted after."""
    d = ROOT / "build" / "train_mesh"
    shutil.rmtree(d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save(str(d), at_step, state)
        save_s = time.perf_counter() - t0
        other = TrainSharding(make_host_mesh(1, 2, devices=["cuda:0"] * 2),
                              model.cfg)
        t0 = time.perf_counter()
        back, at = restore(str(d), train_state_shapes(model),
                           shardings=other)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        npz_bytes = (d / f"step_{at_step:08d}.npz").stat().st_size
    finally:
        shutil.rmtree(d, ignore_errors=True)
    batch = ds.batch_at(at_step)
    _, here = step_fn(state, batch)
    here = float(here["loss"])
    del state
    gc.collect()
    step12 = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**TRAIN_OPT), grad_comm_dtype="bfloat16"),
        mesh=other.mesh)
    _, there = step12(back, batch)
    there = float(there["loss"])
    del back
    if at != at_step or not (isinstance(there, float) and abs(
            there - here) <= 2e-2 * abs(here)):
        raise AssertionError(f"train_mesh checkpoint: step {at}, loss "
                             f"{there} on (1 x 2) vs {here} on (2 x 2)")
    return dict(npz_bytes=npz_bytes, save_s=save_s, restore_s=restore_s,
                restored_onto="(data 1 x model 2)", next_loss_2x2=here,
                next_loss_1x2=there)


def _train_mesh_int8(model, ds) -> dict:
    """`make_dp_train_step` (int8 codes + error feedback) over a 2-way
    ``data`` mesh on cuda:0, 3 steps from seed 0 (each replica's own
    loss on its batch half, no gradient casts: the reference's
    semantics).
    Gated: the losses fall, every residual within half its tensor's
    scale and not all zero, one int8 code an element and one f32 scale a
    tensor a shard on the wire."""
    mesh = Mesh(["cuda:0"] * 2, ("data",))
    state, ef = init_dp_state(model, torch.Generator(device="cuda")
                              .manual_seed(SEED), mesh, device="cuda")
    step = make_dp_train_step(model, mesh, AdamWConfig(**TRAIN_OPT),
                              compress=True)
    losses, step_s = [], []
    for i in range(3):
        t0 = time.perf_counter()
        state, ef, met = step(state, ef, ds.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    ratio = float(met["ef_over_scale"])
    arrays = ef_to_arrays(ef)
    n_el = sum(a[0].size for a in arrays.values())
    want_wire = 2 * (n_el + 4 * len(arrays))
    nonzero = any(bool(t.abs().max() > 0) for t in _leaves(ef))
    del state, ef
    # |g + ef - q · scale| <= scale / 2, plus the f32 rounding of values up
    # to 127 scales (127 · 2^-24 < 1e-5 of the scale, twice)
    if not (losses[-1] < losses[0] and 0 < ratio <= 0.5 + 2e-5 and nonzero
            and met["wire_bytes"] == want_wire):
        raise AssertionError(f"train_mesh int8: losses {losses}, ef/scale "
                             f"{ratio}, wire {met['wire_bytes']} of "
                             f"{want_wire}")
    return dict(mesh="data 2 on cuda:0", losses=losses,
                step_ms=[1e3 * x for x in step_s], ef_over_scale=ratio,
                wire_bytes=met["wire_bytes"], wire_bytes_f32=8 * n_el,
                wire_dtype="int8")


def _train_mesh_moe() -> dict:
    """qwen2-moe's float experts under the (2 x 2) mesh: full width, 1 of
    24 layers, B 2 x S 512 a data replica, 2 steps (experts split over
    ``model``, the dispatch grouped by replica, the global aux loss).
    Gated: finite losses, step 0's loss within 2e-2 of the unsharded
    loss on the same params and batch, K4 and K4b once a shard a
    step (remat: K4 twice)."""
    layers_, b, s, steps = TRAIN_MESH_MOE
    with _depth(TP_MOE_ARCH, layers_):
        cfg = get_config(TP_MOE_ARCH)
    model = Model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    ds = make_dataset(cfg, b, s, SEED)
    plain, _, _ = loss_and_grads(model, state["params"], {
        k: torch.as_tensor(v, device="cuda")
        for k, v in ds.batch_at(0).items()})
    plain = float(plain)
    mesh = make_host_mesh(2, 2, devices=["cuda:0"] * 4)
    state = TrainSharding(mesh, cfg).place(state)
    gc.collect()
    step_fn = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**TRAIN_OPT), grad_comm_dtype="bfloat16"),
        mesh=mesh)
    _reset_peak()
    reset_counts()
    state, losses, step_s, _ = _mesh_steps(step_fn, state, ds, steps)
    launches = read_counts(TRAIN_COUNTERS)
    peak = torch.cuda.max_memory_allocated()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {n: c / steps for n, c in launches.items()}
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - plain) <= 2e-2 * abs(plain)
            and per_step == {"flash_attention": 2 * 4 * layers_,
                             "flash_attention_bwd": 4 * layers_}):
        raise AssertionError(f"train_mesh qwen2-moe: losses {losses} "
                             f"(unsharded {plain}), launches {per_step}")
    return dict(config=cfg.name, layers=layers_, batch=b, seq=s,
                steps=steps, losses=losses, unsharded_loss=plain,
                step_ms=[1e3 * x for x in step_s], peak_mem_bytes=peak,
                launches=launches, launches_per_step=per_step)


def train_mesh(trained: dict) -> dict:
    """Training over a (data 2 x model 2) mesh, all four shards on
    cuda:0 (the card cannot show a speedup, only the function and the
    bytes): the `train` phase's model (`TRAIN_LAYERS` of Qwen2.5-0.5B's)
    from its seed and settings (B 8 x S 512 globally, bf16 casts, remat,
    AdamW), `TRAIN_MESH_STEPS` steps
    (the main path: counts from 0 here, read after). Gated: each loss
    within 2e-2 relative of `train`'s at the same step; K4 twice and K4b
    once a layer a shard a step; the replicas bit-equal after the last
    step; each data replica's moments (ZeRO-1) half the logical ones
    (within 0.1 %: a 1-D leaf split over ``model`` has no dim left to
    cut over ``data``).
    Then a save at (2 x 2) restored onto (1 x 2), the int8-EF arm and
    qwen2-moe's float experts."""
    cfg, model, state, ds, _ = _train_setup()
    mesh = make_host_mesh(2, 2, devices=["cuda:0"] * 4)
    sharding = TrainSharding(mesh, cfg)
    logical_moments = 2 * sum(t.numel() * 4 for t in _leaves(
        state["params"]))
    state = sharding.place(state)
    gc.collect()
    step_fn = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**TRAIN_OPT), grad_comm_dtype="bfloat16"),
        mesh=mesh)
    _reset_peak()
    reset_counts()
    state, losses, step_s, wire = _mesh_steps(step_fn, state, ds,
                                              TRAIN_MESH_STEPS)
    launches = read_counts(TRAIN_COUNTERS)
    peak = torch.cuda.max_memory_allocated()
    per_step = {n: c / TRAIN_MESH_STEPS for n, c in launches.items()}
    want = trained["losses"][:TRAIN_MESH_STEPS]
    if not all(abs(a - b) <= 2e-2 * abs(b) for a, b in zip(losses, want)):
        raise AssertionError(f"train_mesh: losses {losses}, unsharded "
                             f"{want}")
    if per_step != {"flash_attention": 2 * 4 * cfg.num_layers,
                    "flash_attention_bwd": 4 * cfg.num_layers}:
        raise AssertionError(f"train_mesh: launches a step {per_step}, "
                             f"want K4 twice and K4b once a layer a shard")
    equal = _replicas_bit_equal(state)
    moments = [sum(t.numel() * t.element_size() for m in range(2)
                   for key in ("m", "v")
                   for t in _leaves(state["opt"][key][r][m]))
               for r in range(2)]
    # half, but for the leaves the model split leaves no dim to cut over
    # data (the q / k / v biases: held whole by each replica, as the
    # reference's rule holds them)
    if not equal or any(not logical_moments <= 2 * b
                        <= 1.001 * logical_moments for b in moments):
        raise AssertionError(f"train_mesh: replicas bit-equal {equal}, "
                             f"moment bytes a replica {moments} of "
                             f"{logical_moments}")
    # one step bare and one profiled (busy / idle, PERF §5), then the
    # checkpoint from the state after them
    trainer = _Trainer(step_fn, state, ds, TRAIN_MESH_STEPS)
    del state
    prof = _profile_steps(trainer, 1, host_ops=False)
    state, at_step = trainer.state, trainer.i
    del trainer
    ckpt = _train_mesh_ckpt(model, state, step_fn, ds, at_step)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    int8 = _train_mesh_int8(model, ds)
    gc.collect()
    torch.cuda.empty_cache()
    moe_run = _train_mesh_moe()
    step_med = float(np.median(step_s[1:]))
    return dict(
        mesh="(data 2 x model 2), four shards on cuda:0", config=cfg.name,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_MESH_STEPS,
        losses=losses, unsharded_losses=want,
        step_ms=[1e3 * x for x in step_s], step_ms_median=1e3 * step_med,
        unsharded_step_ms_median=trained["step_ms_median"],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_med, peak_mem_bytes=peak,
        launches=launches, launches_per_step=per_step,
        grad_wire_bytes_per_step=wire, replicas_bit_equal=equal,
        moment_bytes_per_replica=moments,
        moment_bytes_logical=logical_moments, profile_step=prof,
        checkpoint=ckpt, int8_ef=int8, qwen2_moe=moe_run)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every phase line to this "
                                  "JSON file")
    ap.add_argument("--profile-only", action="store_true",
                    help="build, then only the profile phase (decode, "
                         "one-shot decode, chunk and verify steps); prints "
                         "no kernels or ok line")
    ap.add_argument("--k4b-only", nargs="?", const="", metavar="CU",
                    help="build, then only check_k4b and profiled train "
                         "steps (train's settings), with the checkout's K4b "
                         "or, given CU, another source with the same C "
                         "entry point (a parent commit's "
                         "csrc/flash_attention_bwd.cu) to compare two "
                         "versions on one card; prints no kernels or ok "
                         "line")
    ap.add_argument("--tp-oneshot-only", action="store_true",
                    help="build, then only the tp_oneshot phase on the "
                         "serving phases' Qwen2.5-0.5B; prints no kernels "
                         "or ok line")
    ap.add_argument("--tp-families-only", action="store_true",
                    help="build, then only the tensor-parallel stripes' "
                         "kernel shapes, train_families for the five "
                         "families tp_families splits, and tp_families; "
                         "prints no kernels or ok line")
    args = ap.parse_args()
    t_start = time.perf_counter()
    # the imported modules' objects live as long as the script: keep them
    # out of the peak-memory windows' many gc.collect() calls
    gc.freeze()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    device_name = torch.cuda.get_device_name(0)
    phase("device", name=device_name, capability=list(
        torch.cuda.get_device_capability(0)), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(smi, flush=True)

    t = time.perf_counter()
    built = build.build_all()
    with concurrent.futures.ThreadPoolExecutor(len(built)) as pool:
        mma = dict(zip(built, pool.map(lambda b: sass_mma_count(b.path),
                                       built.values())))
    phase("build", seconds=time.perf_counter() - t,
          per_source={n: b.seconds for n, b in built.items()},
          ptxas=[ln.strip() for b in built.values() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln],
          k4b_kernels=ptxas_by_kernel(built["flash_attention_bwd"].log),
          sass_tensor_core_instructions=mma)
    for n in ("awq_matmul", "awq_gateup", "flash_attention",
              "flash_attention_bwd"):
        if not mma[n] or mma[n]["HMMA"] + mma[n]["HGMMA"] <= 0:
            raise AssertionError(f"{n}: no tensor-core instruction in its "
                                 f"SASS ({mma[n]})")
    # K4b's tensor-core kernels keep their sums in registers at hd 32, 64,
    # 80, 96 and 128 (the train path's head dims): ptxas must spill
    # nothing there, and report all five
    k4b_regs = PHASES["build"]["k4b_kernels"]
    spilled = {n: r for n, r in k4b_regs.items()
               if "mma" in n and not n.endswith(" 256>")
               and r.get("spill_stores", 0) + r.get("spill_loads", 0) > 0}
    reported = {hd for hd in K4B_NO_SPILL
                if any(n.endswith(f"<bf16, {hd}>") for n in k4b_regs
                       if "mma" in n)}
    if spilled or reported != set(K4B_NO_SPILL):
        raise AssertionError(f"flash_attention_bwd: spills at hd 32 - 128 "
                             f"or a tensor-core kernel missing from ptxas' "
                             f"report ({k4b_regs})")

    if args.k4b_only is not None:
        if args.k4b_only:
            build.load_source("flash_attention_bwd", args.k4b_only)
        k4b_entry, k4b_detail = check_k4b(
            torch.Generator(device="cuda").manual_seed(SEED))
        phase("k4b", source=args.k4b_only or k4b_entry["source"], gpu=smi,
              **k4b_detail)
        phase("train_profile", gpu=smi, **train_profile())
        return

    if args.tp_families_only:
        phase("kernel_shapes", tp_stripes=check_tp_stripe_kernels(
            torch.Generator(device="cuda").manual_seed(SEED)))
        families = {}
        for arch, layers, b, s, lr, steps in TRAIN_FAMILIES:
            if arch in TP_FAMILIES:
                families[arch] = train_family(arch, layers, b, s, lr, steps)
                gc.collect()
                torch.cuda.empty_cache()
        phase("train_families", gpu=smi, **families)
        phase("tp_families", gpu=smi, **tp_families(families))
        phase("summary", gpu=smi, script_s=time.perf_counter() - t_start)
        return

    if args.tp_oneshot_only:
        model = Model(dataclasses.replace(get_config("qwen25-05b"),
                                          num_layers=SERVE_LAYERS))
        params, _ = quantize_params(model.init(
            torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
        phase("tp_oneshot", gpu=smi, **tp_oneshot(model, params))
        phase("summary", gpu=smi, script_s=time.perf_counter() - t_start)
        return

    if args.profile_only:
        model = Model(get_config("qwen25-05b"))
        params, _ = quantize_params(model.init(
            torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
        phase("profile", **profile(model, params))
        del params
        torch.cuda.empty_cache()
        # gemma3-4b at full size, RTN int4: a decode step past the window
        model = Model(get_config("gemma3-4b"))
        params, _ = quantize_params(model.init(
            torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
        phase("profile_gemma3", **profile_dense_decode(model, params))
        return

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    (k1_entry, k1_detail), (k2_entry, k2_detail) = check_k1(gen), check_k2(gen)
    k3_entry, k3_detail = check_k3(gen)
    k4_entry, k4_detail = check_k4(gen)
    k4b_entry, k4b_detail = check_k4b(gen)
    k2tp_entry, k2tp_detail = check_k2_tp(gen)
    kernels = [k1_entry, k2_entry, k3_entry, k4_entry]
    phase("kernel_shapes", awq_matmul=k1_detail,
          paged_attention_chunk=k2_detail, awq_gateup=k3_detail,
          paged_attention_chunk_sharded=k2tp_detail,
          flash_attention=k4_detail, flash_attention_bwd=k4b_detail,
          dense_models=check_dense_kernels(gen),
          moe_experts=check_expert_kernels(gen),
          moe_experts_shard=check_expert_shard_kernels(gen),
          tp_stripes=check_tp_stripe_kernels(gen))
    # the hd-32 instances (glm4-9b's smoke shapes and one larger shape)
    # on the kernels line beside each kernel's main-path numbers
    dense_k = PHASES["kernel_shapes"]["dense_models"]
    for entry, rows in ((k2_entry, dense_k["paged_attention_chunk"]),
                        (k4_entry, dense_k["flash_attention"]),
                        (k4b_entry, k4b_detail["shapes"])):
        entry["hd32"] = [{k: r[k] for k in (
            "model", "c", "b", "s", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms") if k in r}
            for r in rows if r["hd"] == 32]

    cfg = dataclasses.replace(get_config("qwen25-05b"),
                              num_layers=SERVE_LAYERS)
    model = Model(cfg)
    t = time.perf_counter()
    params, report = quantize_params(model.init(
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
    torch.cuda.synchronize()
    phase("model", config=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, quantized_linears=len(report.quantized),
          group_size=GS, init_quantize_s=time.perf_counter() - t)
    served = serve(model, params)
    phase("serve", **{k: v for k, v in served.items() if k != "streams"})
    oneshot = serve_oneshot(model, params)
    phase("serve_oneshot", **oneshot)
    identity = oneshot_identity(model, params)
    phase("oneshot_identity", **identity)
    phase("parallel", **parallel(model, params))
    refs = uninterrupted(model, params)
    preempted = preempt(model, params, refs)
    phase("preempt", **preempted)
    optimistic_run = optimistic(model, params, refs)
    phase("optimistic", **optimistic_run)
    disagged = disagg(model, params)
    unified_refs = disagged.pop("unified_streams")
    phase("disagg", **disagged)
    srefs = spec_refs(model, params)
    ngrammed = spec_ngram(model, params, srefs)
    phase("spec_ngram", **ngrammed)
    treed = spec_tree(model, params, srefs)
    phase("spec_tree", **treed)
    drafted = spec_draft(model, params, srefs)
    phase("spec_draft", **drafted)
    spec_runs = [ngrammed["all_kernel"], ngrammed["default"],
                 treed["all_kernel"], treed["default"], treed["alternate"],
                 drafted["all_kernel"]]
    prof = profile(model, params)
    phase("profile", **prof)
    cpu_logits = []
    checked = cross_check(model, params, cpu_logits)
    phase("check", **checked)
    tensor_parallel = tp(model, params, served, unified_refs, cpu_logits,
                         prof, disagged["wire_bytes"])
    phase("tp", **tensor_parallel)
    sp = sp_decode(model, params)
    phase("sp_decode", gpu=smi, **sp)
    tpo = tp_oneshot(model, params)
    phase("tp_oneshot", gpu=smi, **tpo)
    del params
    torch.cuda.empty_cache()

    launched, awq_params = launch()
    phase("launch", **launched)
    # each kernel's launches on the paths that carry it: K1, K2 and K3
    # while the engine serves (chunked, one-shot, speculating), K4 in the
    # one-shot engine's prefills, sp_decode's and tp_oneshot's (placed and
    # unsharded), the draft model's prefills and the launcher's
    # calibration and generate()
    for entry in (k1_entry, k2_entry, k3_entry):
        kernel = entry["name"]
        entry["launches"] = (served["launches"][kernel]
                             + oneshot["launches"][kernel]
                             + sum(run["launches"][kernel]
                                   for res in (preempted, optimistic_run)
                                   for run in (res["all_kernel"],
                                               res["default"]))
                             + disagged["launches"][kernel]
                             + sum(run["launches"][kernel]
                                   for run in spec_runs)
                             + sum(tensor_parallel[run]["launches"][kernel]
                                   for run in ("default", "all_kernel"))
                             + tpo["launches"].get(kernel, 0))
    # K2-TP on the mesh's serving runs and handoffs
    k2tp_entry["launches"] = (
        sum(tensor_parallel[run]["launches"]["paged_attention_chunk_sharded"]
            for run in ("default", "all_kernel"))
        + tensor_parallel["disagg"]["launches"][
            "paged_attention_chunk_sharded"])
    k4_entry["launches"] = (launched["launches"]["flash_attention"]
                            + oneshot["launches"]["flash_attention"]
                            + sp["k4_launches"]
                            + tpo["launches"]["flash_attention"]
                            + drafted["all_kernel"]["launches"][
                                "flash_attention"])
    # the launcher's params hold all 24 layers
    prefilled = check_prefill(Model(get_config("qwen25-05b")), awq_params)
    phase("check_prefill", **prefilled)
    del awq_params
    torch.cuda.empty_cache()
    served_fleet = fleet()
    unified = served_fleet.pop("streams")
    phase("fleet", **served_fleet)
    disagg_fleet = fleet(disagg=True, unified_streams=unified)
    del disagg_fleet["streams"]
    phase("fleet_disagg", **disagg_fleet)
    gc.collect()
    torch.cuda.empty_cache()
    # the other models: each one's phase line, and K1 - K4's launches on
    # its launcher and serving paths (K1's and K3's over a MoE layer's
    # experts also by model, as the expert axis's share)
    dense, dense_launches, tp_moe_run = dense_models()
    for entry in kernels:
        qwen = entry["launches"]
        entry["launches"] = qwen + sum(
            by[entry["name"]] for by in dense_launches.values())
        entry["launches_by_model"] = {"qwen25-05b": qwen, **{
            arch: by[entry["name"]] for arch, by in dense_launches.items()}}
    for entry in (k1_entry, k3_entry):
        entry["expert_axis_launches_by_model"] = {
            arch: by[f"{entry['name']}_experts"]
            for arch, by in dense_launches.items()
            if by[f"{entry['name']}_experts"]}
    # tp_moe's serving run: K1 - K3 on each shard (the experts' stripes
    # among them), K2 and K2-TP on each shard's kv heads
    for entry in (k1_entry, k2_entry, k3_entry):
        entry["launches"] += tp_moe_run["launches"][entry["name"]]
        entry["launches_by_model"]["tp_moe"] = \
            tp_moe_run["launches"][entry["name"]]
    for entry in (k1_entry, k3_entry):
        entry["expert_axis_launches_by_model"]["tp_moe"] = \
            tp_moe_run["launches"][f"{entry['name']}_experts"]
    k2tp_entry["launches"] += tp_moe_run["launches"][
        "paged_attention_chunk_sharded"]
    # glm4-9b's smoke config (hd 32): the launchers and the engine
    glm4 = glm4_smoke()
    phase("glm4_smoke", gpu=smi, **glm4)
    for entry in kernels:
        entry["launches"] += glm4["launches"][entry["name"]]
        entry["launches_by_model"]["glm4-9b-smoke"] = \
            glm4["launches"][entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_check()
    phase("dryrun", gpu=smi, **dry)
    # training: Qwen2.5-0.5B at full width (K4 forward and remat, K4b)
    trained = train()
    phase("train", **trained)
    resumed = train_resume()
    phase("train_resume", **resumed)
    families = train_families()
    phase("train_families", gpu=smi, **families)
    tp_fam = tp_families(families)
    phase("tp_families", gpu=smi, **tp_fam)
    # the packed forwards on the mesh: K1 and K3 on each shard's stripes
    for entry in (k1_entry, k3_entry):
        runs = [f["forward"][c]["launches"][entry["name"]]
                for f in tp_fam.values() for c in ("default", "all_kernel")]
        entry["launches"] += sum(runs)
        entry["launches_by_model"]["tp_families"] = sum(runs)
    meshed = train_mesh(trained)
    phase("train_mesh", gpu=smi, **meshed)
    by_path = {name: trained["launches"][name] + resumed["launches"][name]
               + sum(f["launches"][name] for f in families.values())
               + sum(f["launches"][name] for f in tp_fam.values())
               + meshed["launches"][name]
               + meshed["qwen2_moe"]["launches"][name]
               for name in TRAIN_COUNTERS}
    k4_entry["launches"] += by_path["flash_attention"]
    k4_entry["launches_train"] = by_path["flash_attention"]
    k4b_entry["launches"] = (by_path["flash_attention_bwd"]
                             + glm4["launches"]["flash_attention_bwd"])
    kernels += [k4b_entry, k2tp_entry]

    phase("summary", gpu=smi, script_s=time.perf_counter() - t_start,
          **{k: served[k] for k in (
        "decode_tokens_per_s", "decode_step_ms", "decode_steps", "steps",
        "serve_s", "peak_mem_bytes", "launches", "launches_per_decode_step",
        "qlinear_calls")},
        serve_oneshot={k: oneshot[k] for k in (
            "decode_tokens_per_s", "decode_step_ms", "prefill_commit_ms",
            "serve_s", "peak_mem_bytes", "launches")},
        profile={k: prof[k] for k in ("step_ms", "profiled_step_ms",
                                      "device_busy_ms", "device_idle_share",
                                      "device_launches")},
        profile_oneshot_decode_step={k: prof["oneshot_decode_step"][k]
                                     for k in ("step_ms", "profiled_step_ms",
                                               "device_busy_ms",
                                               "device_idle_share")},
        profile_chunk_step={k: prof["chunk_step"][k] for k in (
            "step_ms", "profiled_step_ms", "device_busy_ms",
            "device_idle_share")},
        profile_verify_step={k: prof["verify_step"][k] for k in (
            "step_ms", "profiled_step_ms", "device_busy_ms",
            "device_idle_share", "device_launches",
            "tokens_per_verify_row")},
        **{label: {cfg_name: {k: res[cfg_name][k] for k in (
            "identical_streams", "draft_tokens", "accepted_tokens",
            "acceptance_rate", "spec_tokens_per_row", "rollbacks",
            "spec_k_now", "spec_fanout_now", "tree_steps", "tree_moves",
            "decode_tokens_per_s", "verify_step_ms", "draft_ms_per_step")}
            for cfg_name in res if cfg_name in (
                "all_kernel", "default", "alternate")}
           for label, res in (("spec_ngram", ngrammed), ("spec_tree", treed),
                              ("spec_draft", drafted))},
        check={s: [v["max_abs_err"], v["tol"]] for s, v in checked.items()},
        tp={k: {f: tensor_parallel[k][f] for f in (
            "serve_s", "decode_step_ms", "decode_tokens_per_s",
            "identical_streams", "kv_pool_bytes_per_device")}
            for k in ("default", "all_kernel")},
        tp_profile_decode_step={k: tensor_parallel["profile_decode_step"][k]
                                for k in ("step_ms", "profiled_step_ms",
                                          "device_busy_ms",
                                          "device_idle_share",
                                          "device_launches")},
        launch={k: launched[k] for k in (
            "calibrate_s", "awq_s", "calibrated", "compression_ratio",
            "awq_macro_bytes", "tokens_per_s", "peak_mem_bytes",
            "launches_by_step")},
        awq_macro={k: launched["awq_macro"][k] for k in ("bytes",
                                                         "seconds")},
        check_prefill=[prefilled["max_abs_err"], prefilled["tol"]],
        oneshot_identity={name: [r["identical_streams"], r["requests"]]
                          for name, r in identity.items()},
        **{arch: _model_summary(f) for arch, f in dense.items()},
        fleet={k: served_fleet[k] for k in (
            "fleet_s", "tokens_per_s", "requests", "generated",
            "prefill_tokens_skipped", "placements", "affinity_hits",
            "peak_mem_bytes", "launches")},
        fleet_disagg={k: disagg_fleet[k] for k in (
            "fleet_s", "tokens_per_s", "requests", "generated",
            "placements", "affinity_hits", "identical_to_fleet",
            "peak_mem_bytes", "launches")},
        **{label: {cfg_name: {k: res[cfg_name][k] for k in (
            "preemptions", "pressure_spills", "restores", "spilled_pages",
            "spilled_bytes", "restore_ms_mean", "identical_streams",
            "decode_tokens_per_s", "peak_mem_bytes")}
            for cfg_name in ("all_kernel", "default")}
           for label, res in (("preempt", preempted),
                              ("optimistic", optimistic_run))},
        train={k: trained[k] for k in (
            "first_loss", "last_loss", "step_ms_median", "tokens_per_s",
            "peak_mem_bytes", "launches_per_step")},
        train_profile_step={k: trained["profile_step"][k] for k in (
            "profiled_step_ms", "device_busy_ms", "device_idle_share")},
        train_check=trained["check"]["worst_err_over_leaf_max"],
        train_resume={k: resumed[k] for k in (
            "steps", "recoveries", "npz_bytes", "save_s", "restore_s",
            "launch_s")},
        sp_decode={k: sp[k] for k in ("decode_step_ms",
                                      "unsharded_decode_step_ms")} | {
            "check": {s: [v["max_abs_err"], v["tol"]]
                      for s, v in sp["check"].items()}},
        tp_oneshot={k: tpo[k] for k in (
            "decode_step_ms", "unsharded_decode_step_ms", "max_err_over_max",
            "equal_greedy_streams", "prefill_launches", "launches")} | {
            "collectives": {"prefill": tpo["collectives"]["prefill"]["total"],
                            "per_step": tpo["collectives"]["per_step"]},
            "families": {arch: {k: f[k] for k in (
                "decode_step_ms", "unsharded_decode_step_ms",
                "max_err_over_max", "equal_greedy_streams")}
                for arch, f in tpo["families"].items()}},
        dryrun={k: dry[k] for k in ("param_bytes_per_device",
                                    "allocated_two_shards",
                                    "requested_two_shards",
                                    "rounding_bytes", "decode_32k_s")},
        glm4_smoke={k: glm4[k] for k in (
            "losses", "train_s", "launch_s", "tokens_per_s",
            "launches")} | {"check": {s: [v["max_abs_err"], v["tol"]]
                                      for s, v in glm4["check"]["check"]
                                      .items()}},
        tp_moe={k: tp_moe_run[k] for k in (
            "decode_step_ms", "unsharded_decode_step_ms",
            "expert_launches_per_step", "identical_streams",
            "first_tokens_equal", "kv_pool_bytes_per_device",
            "expert_bytes_per_shard", "peak_mem_bytes")},
        train_mesh={k: meshed[k] for k in (
            "losses", "step_ms_median", "unsharded_step_ms_median",
            "tokens_per_s", "peak_mem_bytes", "launches_per_step",
            "grad_wire_bytes_per_step", "moment_bytes_per_replica",
            "moment_bytes_logical")} | {
            "profile_step": {k: meshed["profile_step"][k] for k in (
                "profiled_step_ms", "device_busy_ms", "device_idle_share",
                "device_launches")},
            "int8_ef": {k: meshed["int8_ef"][k] for k in (
                "losses", "ef_over_scale", "wire_bytes")},
            "checkpoint": {k: meshed["checkpoint"][k] for k in (
                "save_s", "restore_s", "next_loss_2x2", "next_loss_1x2")},
            "qwen2_moe": {k: meshed["qwen2_moe"][k] for k in (
                "losses", "unsharded_loss", "step_ms", "peak_mem_bytes")}},
        tp_families={arch: {k: f[k] for k in (
            "losses", "unsharded_losses", "worst_rel_loss_diff", "step_ms",
            "unsharded_step_ms_median", "peak_mem_bytes",
            "unsharded_peak_mem_bytes", "launches_per_step",
            "split_bytes_per_shard", "split_bytes_logical", "phase_s")} | {
            "forward": {c: {k: f["forward"][c][k] for k in (
                "max_abs_err", "tol", "launches", "forward_ms")}
                for c in ("default", "all_kernel")}}
            for arch, f in tp_fam.items()},
        train_families={arch: {k: f[k] for k in (
            "layers", "batch", "seq", "losses", "step_ms_median",
            "tokens_per_s", "peak_mem_bytes", "launches_per_step",
            "analytic_compute_s", "analytic_memory_s", "step_over_bound",
            "phase_s")} | {"check": f["check"]["worst_err_over_leaf_max"]}
            for arch, f in families.items()},
        disagg={k: disagged[k] for k in (
            "handoffs", "direct", "wire_bytes", "adopt_ms_mean",
            "prefill_step_ms", "decode_step_ms", "peak_mem_bytes",
            "launches_by_side")})
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {**PHASES, "kernels": kernels}, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
