"""Chip smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit,
     TF32 off for matmul and cuDNN;
  2. build: the nine kernel sources (`src/repro_torch/kernels/*/csrc/*.cu`:
     the flash forward and backward each an fp32 and a bf16 source; the
     conv1d fp32 forward and backward one source, its bf16 streams one
     each), one
     nvcc each, started together, with build times, and beside them the
     four flash sources' and the bf16 conv1d forward stream's `-Xptxas -v`
     registers and spills per instantiation (the bf16 flash ones on
     warpgroup `wgmma`); then the static
     checks in-process (`python -m repro_torch.convserve.check --strict`:
     the IR verifier over the benched configs' plans, the lock analyzer,
     the rule linter over `src/repro_torch`), which must be clean;
  3. kernel vs plain: the CUDA tile kernel (`fused_tile_call`, at the
     geometry `launch_geometry` picks for each shape) against its plain
     PyTorch version (`matrix_tile_conv`) on the card, at every conv
     shape of the served nets, max rel err < 1e-5 (both fp32, with
     different summation orders); then `l3_fused_pallas` (the tile kernel
     under the reference's Winograd name) at vgg 64->64 @64 b4 F(5,3)
     against the plain version (< 1e-5), and the f32 tile kernel against
     the f64 `scan_tile_conv` oracle on the card at the served vgg and fft
     shapes (< 5e-5, the reference's tile-engine tolerance against
     direct);
  4. LM kernels vs plain: conv1d_fused, flash_attention and decode_mlp
     against `conv1d_ref`, `attention_ref` and `decode_mlp_ref` on the
     same card tensors, at the served shapes and at edge cases (ragged
     lengths, a conv1d slice that is not 16-byte aligned, K 1 and K 8,
     window on and off, GQA g=4 and g=1, non-causal, rows that see no
     key, decode B 1-11, a temporal `ConvSpec` through the registry), and
     the repaired walls: flash at hd 80 (stablelm-3b, B 4, 32 heads, S
     700, causal) and hd 112 (32 heads, causal with window 512, and
     non-causal), moonshot-v1-16b-a3b's prefill attention (MHA, hd 128,
     B 4, 16 heads, S 700, causal), deepseek-v3-671b's MLA prefill (B 4,
     128 heads, S 700, q/k hd 192, v hd 128, causal) and its MTP block's
     attention (B 4, 128 heads, S 1023, hd 56, padded in the kernel), each
     also at g 1 with ragged Sq / Sk and rows that see no key,
     seamless-m4t-medium's attention at hd 64 (B 4, 16 heads: the
     encoder at S 1024 non-causal, the decoder's causal self-attention at
     S 128 and at the training S 512, the cross attention at Sq 128, Sq 1
     and the training Sq 512 over 1024 frames) and its decode MLP (B 4,
     d 1024, f 4096), conv1d
     at K 9 and K 16 (B 4, L 768, the D 4352 slice, SiLU on and off); max
     rel err < 1e-5;
  5. serve ConvNets: `vgg_mixed_channel` and `fft_fewchannel` through
     `Engine` + `ConvServer` on the H100 hardware model, five requests
     cold and warm; every output finite, of the expected shape and within
     rel 1e-3 of the all-direct `run_direct` (cuDNN, TF32 off); the tile
     kernel's launch counter is zeroed before each net is served and must
     grow;
  6. serve LMs: gemma3-1b, mamba2-1.3b and zamba2-7b (81 mamba layers and
     13 invocations of the shared attention block with their LoRA, hd
     112, 6.79 B params) at full width and depth, fp32,
     random weights from seed 0, six requests (prompts 17..700 tokens) in
     waves of 4, 16 new tokens; prefill ms per wave, decode ms per step,
     tokens/s; every kernel count zeroed before each model and read
     after: flash launches = attention layers (shared invocations
     included) x waves, decode_mlp = MLP layers (the shared MLP's
     invocations included) x decode steps, conv1d = mamba layers x waves;
  7. card vs CPU: each model's weights cut to one period of depth (6 / 4
     layers; zamba2 the shared block, its 6 mamba layers and one more),
     and stablelm-3b (head dim 80) cut to 2 layers at full width
     from seed 0, one wave of two prompts (600 and 40 tokens) on the card
     and on the CPU through the port: prefill and teacher-forced decode
     logits within rel 1e-3, and equal greedy tokens; stablelm's prefill
     must launch flash once per layer;
  8. LM profile: one warm prefill of wave 1 and one decode step per
     model, host wall time beside `torch.profiler`'s device busy time,
     the idle share, the top kernels by device time, and the conv1d
     kernel's device time summed over mamba2's prefill launches;
  9. times: kernel, plain and library yardstick per phase-3 and phase-4
     case (`F.conv2d`; `F.scaled_dot_product_attention` on kv heads
     repeated beforehand, with the boolean mask and, for causal cases
     without a window, also with `is_causal=True`; grouped `F.conv1d` with
     bias, and that + `F.silu`; none for the decode MLP), median of
     CUDA-event-timed runs, beside the bound (fp32 FMA peak; for flash,
     whose products run on the tensor cores, three TF32 products per
     FLOP at the TF32 peak, with the fp32 FMA bound beside it), and
     `torch.profiler`'s device time of the tile kernel at vgg 64->64 and
     fft 8->8, of flash at the served global layer, of the decode MLP
     at the served step and of conv1d at mamba2's first prefill wave;
     per-stage profile of a warm ConvNet 64-bucket wave; flash at the
     hd-80, moonshot, MLA and MTP shapes gets the served row's columns
     (SDPA takes v's head dim apart from q's), and so do zamba2-7b's
     conv1d (wave 1) and decode MLP (B 4) shapes;
 10. online: `vgg_mixed_channel` through `ReplicaPool` (two replicas, a
     CUDA stream per worker) and `ServeRuntime`, replaying
     `serve_runtime_bench`'s seeded vgg trace (poisson 40 Hz, 120
     requests, sizes 32/48/64) on `H100_SXM` with roofs calibrated on the
     card (`tune.measure_calibration`), traced by a `Tracer` and a
     `FlightRecorder`: prints the calibration, e2e / compute / queue-wait
     p50 and p95, the makespan, waves and partial waves, each wave's
     replica, bucket, batch and compute time, the roofline table, the
     tracer's event and drop counts; fails unless every
     request is answered within rel 1e-3 of direct with no error or
     rejection, 0 cache misses after warmup, both replicas served, the
     tile kernel launched, calibration left the plan unchanged, every
     stage has a roofline row, no wave was lost and the Chrome trace is
     valid;
 11. adapt: `benchmarks/check_divergence.py`'s scenario on the card:
     `fft_fewchannel(4)` (seed 0) on phase 10's calibrated H100 model,
     one inline replica, a SimClock runtime (max_batch 2, bucket 64, SLO
     10 s), an `AdaptController` (divergence ratio 1.25, every wave
     shadowed, 2 shadow waves, promote margin 0.05, probes at bucket 64,
     3 reps) that measures the live stages with CUDA events, probes the
     unfused and direct alternatives, checks divergence, then serves 32
     seeded 64x64x4 requests while it shadows, promotes or rolls back.
     Prints the seed plan, each stage's measured and predicted time and
     their ratio, the trigger, the shadow's mode, waves and verdict, the
     audit log, the final plan, how many requests each plan served with
     its worst error against direct, and the seed-vs-final timing pair
     beside a seed-vs-seed reading (two compiles of the seed plan in the
     same turns).  Fails unless all 32 are answered, those served by the
     seed plan and those served by any later plan each within rel 1e-3
     of direct (cuDNN), the client e2e histogram counts exactly 32 (no
     shadow wave leaks in), the final plan is measured no slower than
     the seed plan (interleaved CUDA-event medians, slack ADAPT_SLACK),
     the tile-kernel launches
     equal the count derived from the live and shadow programs and the
     swap's warm waves, the seed and final plans verify clean, and no f32
     path reached `scan_tile_conv` (phases 5, 10 and 11).  The phase
     decides nothing about the outcome: promoting, keeping the fused
     group or dropping fusion are all valid.
 12. fleet: `benchmarks/fleet_bench.py`'s --smoke scenarios through
     `ElasticPool` + `FleetRuntime` + `Autoscaler` on the card, at
     `vgg_mixed_channel(3)`'s full widths (weights from seed 0) on phase
     10's calibrated H100 model; the bench's tiny net and 12/16 px become
     vgg and 32-64 px, nothing else changes.  The day: 6,000 diurnal
     requests (depth 0.8, sizes 48/64, seed 11) plus 600 in bursts of 120
     every 7.5 s over 60 simulated seconds, two replicas growing to at
     most six (startup 0.6 s, probes every 3 s), a crash of replica 0 at
     18 s, cache corruption at 30 s and replica 1 slowed x8 at 39 s (the
     trace ends first, so the fleet runs on, idle, to 42 s), simulated
     service `FixedServiceModel(0.004, 0.002)`, bucket 64, max_batch 8,
     SLO 0.5 s, the bench's autoscaler.  Scale-out: 480 requests at 5 kHz
     on 1, 2 and 4 replicas.  Exactness: 60 requests (45 Hz, sizes
     32/48/64, deadline 0.08 s, max_batch 4) on 3 replicas x 4 shards
     against 1 x 1, then once on a RealClock on two inline replicas.
     Every wave's outputs come from the card; latencies, makespans and
     throughputs are on the SIMULATED clock (the RealClock run's compute
     times are the host clock's after the output reached the host).
     Prints the plan, the weight-placement table, accounting, the pool's
     counters, quarantines by why, the autoscaler's events, the scale-out
     curve, the exactness figures and the tile-kernel launches.  Fails
     unless admitted == served + lost and total == admitted + rejected,
     every loss and rejection is reason-coded, the crash fired, the
     corruption was repaired once with mismatches only at the first probe
     after it, replica 1 was quarantined as slow, the fleet scaled up or
     replaced, SLO attainment >= 0.95, T(4) >= 2.5 T(1), every exactness
     request is within rel 1e-5 of the oracle with a partial wave among
     them, every served request is within rel 1e-3 of direct (cuDNN),
     no wave or observer error, the tile-kernel launches equal the count
     derived from every replica's executor calls (waves, shards, warm-ups
     and probes), and the plan verifies clean.

 13. train: gemma3-1b's training path.  (a) The flash forward with its
     log-sum-exp and the flash backward kernel against their plain
     versions on the same card tensors, at gemma3's training layers (B 4,
     Hq 4, Hkv 1, S 1024, hd 256, window 512 / 0, the model's layout),
     moonshot-v1-16b-a3b's (B 4, 16 heads, S 1024, hd 128, causal),
     deepseek-v3-671b's MLA (B 4, 128 heads, S 1024, q/k hd 192, v hd
     128) and MTP block (S 1023, hd 56), every instantiated (hd, vd) at
     g 1 and g 4 on S 700, non-causal, and rows that see no key (at the
     MLA and MTP head dims too): dq, dk, dv each within rel 5e-5 of
     `flash_attention_bwd_ref` fed the same o and lse (the reference's
     gradient tolerance), lse within rel 1e-5, o bitwise with and without
     lse, two backward runs bitwise equal, each printed beside its error
     against a float64 backward; o against the recorded outputs of the
     earlier flash source (`kernels/bitwise_check.py`, compared only
     under the nvcc release that recorded them).  (b) gemma3-1b at full
     width and depth in fp32 through `train_fp32` (the launcher's run --
     its TrainConfig, data, loop and seed -- on a float32 config; the
     launcher itself trains the config's dtype, bf16, phase 18), TF32
     off, 6 steps of 4 x 1024; per step loss (beside the run's recorded losses over the first
     backward kernel, commit 0c64a3e), grad norm, ms and tokens/s, peak
     `max_memory_allocated`; every count zeroed before and read after:
     flash forward = 26 x 2 (remat) x 6, backward = 26 x 6, the others 0;
     every loss and grad norm finite.  (c) gemma3-1b cut to one period (6
     layers) at full width, seed 0, B 1, S 576: `lm_loss` and every
     gradient on the card against the CPU (loss rel 1e-4, every leaf rel
     1e-3).  (d) the loop on `cfg.reduced()` on the card: 30 steps,
     checkpoints every 5, injected failures at steps 12 and 21 restored
     from disk, loss at step 29 below step 0's, then a resume from disk to
     step 34.  Then one warm full-width step under `torch.profiler` (wall,
     device busy, idle share, top kernels, the backward's device time a
     step) and the backward's times at gemma3-1b's global and local
     (window 512) training layers, at moonshot's and at deepseek's MLA
     and MTP layers: CUDA events, the profiler's device time
     of each kernel of a call (delta, main) with its launches a call, the
     wrapper's host time a call and the card's idle time between the
     call's two kernels, the plain backward, SDPA's fp32 backward
     as the library yardstick (`is_causal`; the local band as a boolean
     mask; where SDPA refuses a shape the row says so), and the bound
     both ways (five products a band pair, three of 2 hd FLOPs and two of
     2 vd: split-TF32 at the TF32 peak, and the fp32 FMA peak).  Phase 2
     prints the flash sources' `nvcc -Xptxas -v` registers and spills per
     instantiation.  (e) conv1d under autograd (`Conv1dFused`: the
     forward kernel, then the conv1d backward kernel) against
     `conv1d_bwd_ref` on the same card tensors, at mamba2's and zamba2's
     training slices (B 4, L 1024), a ragged unaligned one and K 9: dx,
     dw, db (and the forward's y) within rel 1e-5, one launch forward and one backward, bitwise
     run to run; the backward's time (events, device time of its two
     kernels) beside the plain one, the library's (autograd of grouped
     `F.conv1d` + SiLU) and its bound.  (f) the
     paths the main run bypasses, on gemma3-1b at full width: a step at
     microbatches 2 against 1 (rel 1e-4), two steps each with bf16 and
     int8 moments (two AdamW updates with them on identical inputs, card
     against CPU: params within 1e-6 after the first and, after the
     second, wherever the first stored both moments alike; for int8 the
     cause of moments stored a step apart), an async checkpoint of the
     trained state with its copy, write and restore times (bitwise), and
     the loop's SIGTERM save.  (g)
     mamba2-1.3b in fp32 through `train_fp32` at full width on 24 of its
     48 layers (the bf16 run of phase 18 takes the full depth), 6 steps
     of 4x1024 (conv1d launches 24 x 2 x 6: forward and remat's forward,
     its backward 24 x 6; flash 0), a 4-layer card-vs-CPU cut, a
     profiled step and the conv backward's share of it; zamba2 at full
     width on 12 layers (the shared block twice), 6 steps (flash 2 x 2 x
     6, backward 2 x 6, conv1d 12 x 2 x 6, its backward 12 x 6), its
     peak memory, and a cut
     of 4 mamba layers with the shared block every 2 (twice) against the
     CPU, LoRA b drawn first.
 14. moonshot-v1-16b-a3b (48 layers of MHA, 16 heads of hd 128, and a
     mixture of 64 experts, top-6, d_ff 1408 each, vocab 163,840), after
     every earlier model is dropped (less than 1 GiB may stay allocated):
     (a) served at full width on 30 of its 48 layers (all 48 in fp32 are
     104.5 GiB), fp32, seed 0, phase 6's six requests through `Engine`:
     prefill ms a wave, decode ms a step, the param count, peak
     `max_memory_allocated` (at least 6 GiB of the card left), the pairs
     wave 1's capacity (328 an expert) dropped per layer; flash launches
     = layers x waves, the decode MLP, conv1d and the tile kernel none;
     layer 0's `moe_forward` at wave 1's and a decode step's shapes with
     the card in sync-debug mode "error" (no host sync).  (b) cut to 2
     layers, card against CPU as in phase 7 (capacity 144 drops the
     pads): logits rel 1e-3, equal greedy tokens, and per MoE call equal
     top-6 sets (a token's may differ only where its 6th and 7th
     probability lie within 1e-5) and equal kept (token, expert) pairs.
     (c) one profiled warm prefill of wave 1 and decode step, as phase 8.
     (d) trained at full width on 5 layers (3.52 B params), `launch.train`'s
     run for 6 steps of 4 x 1024: step ms, tokens/s, peak memory,
     `moe_aux` and `moe_z` a step (finite, non-zero); flash 2 x 5 and its
     backward 5 launches a step; a profiled step; one batch's loss, aux
     losses and gradients computed twice from one state bitwise equal; a
     2-layer cut's loss, aux losses and gradients card against CPU at B
     1, S 512.
 15. deepseek-v3-671b (MLA with 128 heads -- q_lora 1536, kv_lora 512,
     q/k hd 192, v hd 128 --, 256 experts top-8 and one shared of d_ff
     2048, vocab 129,280, the MTP head), after phase 14's model is dropped
     (less than 1 GiB may stay allocated): (a) served at full width on 1
     of its 61 layers (13.74 B params, 51.18 GiB; two layers are 94.05
     GiB), fp32, seed 0, phase 6's six requests through `Engine` with the
     absorbed MLA decode: prefill ms a wave, decode ms a step, the param
     count, peak memory (at least 6 GiB of the card left), the pairs wave
     1's capacity (112 an expert) drops; flash launches = waves (at q/k
     hd 192, v hd 128), the decode MLP, conv1d and the tile kernel none;
     layer 0's `moe_forward` and its MLA decode step
     (`mla_decode_absorbed`) in sync-debug mode "error".  (b) the layer's
     experts cut to 16, card against CPU (prompts 600 and 40): prefill
     and teacher-forced absorbed-decode logits rel 1e-3, equal greedy
     tokens, per MoE call equal top-8 sets and kept pairs.  (c) a
     profiled warm prefill of wave 1 and decode step, as phase 8.  (d)
     trained at full width with the experts cut to 16 (256 need ~184 GB
     of param, gradient and moments for one layer) on the layer and the
     MTP head (3.17 B params), `launch.train`'s run for 6 steps of 4 x
     1024: step ms, tokens/s, peak memory, nll, mtp_nll, moe_aux, moe_z a
     step (finite, mtp_nll non-zero); flash 3 (MLA x 2 for remat + the
     MTP block, hd 56) and its backward 2 launches a step; a profiled
     step; one batch's loss and gradients twice from one state, bitwise;
     an 8-expert cut's loss, mtp_nll and every gradient leaf card against
     CPU at B 1, S 512.
 16. seamless-m4t-medium (an encoder-decoder: 12 bidirectional encoder
     layers, 12 decoder layers with causal self-attention, cross attention
     over the encoder's output and a SwiGLU MLP; d 1024, 16 heads of hd
     64, d_ff 4096, vocab 256,206, an untied head), after phase 15's
     model is dropped (less than 1 GiB may stay allocated): (a) served at
     full size (981,530,624 params, held exactly), fp32, seed 0: one wave
     of B 4 over 1,024 seeded N(0, 1) source frames (the reference's
     SRC_FRAMES) with a 128-token prompt, 16 new tokens greedy through
     `lm_prefill` and `lm_decode_step`; flash exactly 36 a wave (12
     encoder self at S 1024, 12 decoder self causal at S 128, 12 cross at
     Sq 128 / Sk 1024) and 12 a decode step (cross at Sq 1 / Sk 1024),
     the decode MLP 12 a step; the encoder's, the prefill's and a decode
     step's warm ms and tokens/s.  (b) cut to 2 encoder and 2 decoder
     layers, card against CPU: B 2, 600 frames, a 40-token prompt,
     prefill and 8 teacher-forced decode steps' logits rel 1e-3, equal
     greedy tokens.  (c) a profiled warm prefill and decode step, and the
     cross K/V projections a decode step recomputes, timed alone by
     events and profiled, with their share of the profiled step's busy
     time.  (d)
     trained at full size, `launch.train`'s run (`_train_cut`) for 6
     steps of B 4 x 512 target tokens of `TokenStream` beside 1,024
     frames (the cross attention's backward at Sq 512 != Sk 1024): step
     ms, tokens/s, peak memory, nll a step; flash exactly 60 a step
     (encoder 12 without remat, decoder self and cross 2 x 12 each) and
     its backward 36; a profiled step; one batch's loss and gradients
     twice from one state, bitwise; a 2 + 2-layer cut's loss (rel 1e-5)
     and every gradient leaf card against CPU at B 1, S 512 over 1,024
     frames.  Phases 4 and 9 also hold and time the flash forward at
     every shape the path gives it (encoder, decoder self at S 128 and
     512, cross at Sq 128, 1 and 512), phase 13 the forward with lse and
     the backward at the training shapes (cross Sq 512 / Sk 1024, encoder
     S 1024, decoder self S 512 causal; rel 1e-5).

 17. bf16 serving, the registered configs' own dtype, after phase 16's
     model is dropped (less than 1 GiB may stay allocated), the caller's
     cuBLAS setting left at PyTorch's default (the served entry points sum
     bf16 products in f32 themselves, as the reference's dots do):
     (a) the bf16 flash forward (gemma3-1b's global layer, hd 256 GQA
     4:1; zamba2-7b's hd 112; moonshot's hd 128 MHA, each B 4 S 700
     causal; seamless-m4t-medium's encoder, hd 64 S 1024, and its cross
     attention at Sq 1 over 1,024 frames; and at phase 18's other training
     layers: deepseek's MLA (192, 128) at S 1024 and MTP hd 56 at S 1023,
     B 4, 128 heads, and seamless's causal decoder self-attention at S
     512), the bf16 instantiations of the decode MLP (gemma3's, zamba2's
     and seamless's widths at B 4, 2 and 1; gemma3's also timed with its
     weights rotated over 5 copies, read from HBM as a served step over 26
     layers reads them) and the bf16 conv1d forward's TMA stream
     (mamba2's and zamba2's xBC slices at B 4 L 768, mamba2's second wave
     at B 2 L 129 and its training slice at B 4 L 1024), each against its
     plain version on the same bf16 inputs and both against float64 from
     those inputs: the kernel's max error at most twice the plain
     version's plus one bf16 ulp of max |out|, and bitwise the same twice;
     then the conv1d forward at every K 1..8, SiLU on and off, at a ragged
     length (B 2 L 301, D 512 of 1024 at column 256), at L 1 and at L 2 <
     K-1, one launch a call, by the same rule against its plain version;
     each one's time (CUDA events; device time by the profiler), the plain
     version's, the library's (SDPA in bf16, `is_causal` where causal;
     grouped `F.conv1d` + `F.silu` in bf16; none for the MLP) and the bound
     (bytes at 2 a value, operations at 989 TFLOP/s).  (b) gemma3-1b,
     mamba2-1.3b, zamba2-7b and moonshot-v1-16b-a3b (48 of 48 layers) at
     full size in bf16 as registered (`init_lm(get_arch(name), seed=0)`),
     phase 6's six requests through `Engine`: prefill and decode a wave
     beside the fp32 phase's (phase 6; phase 14 for moonshot, 30 layers),
     peak memory beside the fp32 one, every launch count held exactly,
     wave 1's warm prefill by CUDA events and profiled, a decode step
     profiled (wall and device busy).  (c) each cut to its config's first
     2 layers (zamba2: 2 mamba layers), card against the port's bf16 CPU
     run: prompts 600 and 40, the prefill and 8 teacher-forced decode
     steps' logits within rel 2e-2 of max |logits| (two devices, other
     summation orders, bf16's eps 2^-8), the greedy tokens' agreement
     printed; zamba2's shared block (a cut of one mamba layer with the
     block before it) held at its own output, rel 2e-2 of max |x|, at the
     prefill and every step.
 18. bf16 training, the registered configs' own dtype, after phase 17's
     models are dropped (less than 1 GiB may stay allocated): (a) the bf16
     instantiations of the flash backward (every `HEAD_DIMS` pair at g 1
     and g 4 on S 300 with a window, non-causal Sq != Sk, rows that see no
     key, and phase 13's training layers: gemma3's global and local,
     moonshot's hd 128, deepseek's MLA (192, 128) and MTP hd 56,
     seamless's cross, encoder and decoder) and the bf16 conv1d backward
     (`conv1d_fused_bwd_bf16.cu`, a TMA stream; mamba2's and zamba2's
     training slices at B 4 L 1024, a ragged unaligned one on zero-padded
     copies, K 9 on the segment-walk kernel it keeps), each against its
     plain version on the same bf16 inputs (the flash backward fed the
     bf16 forward kernel's o and lse) and both against float64 from
     those inputs: every gradient's max error at
     most twice the plain version's plus one bf16 ulp of its max, bitwise
     the same twice; at the training shapes each one's time (events,
     device time), the plain version's, the library's (SDPA's bf16
     backward; autograd of grouped `F.conv1d` + bias + `F.silu` in bf16)
     and the bound (bytes at 2 a value; the flash backward's five
     products at 989 TFLOP/s, the conv's f32 FMAs at the fp32 peak).  (b)
     `launch.train.main` on gemma3-1b and mamba2-1.3b at full size in
     bf16 as registered, 6 steps of 4 x 1024: per step loss, grad norm
     and ms beside this run's fp32 steps (phase 13) and the fp32 steps of
     record (PERF.md), peak memory, every launch count held exactly
     (flash 26 x 2 x 6 and its backward 26 x 6; conv1d 48 x 2 x 6 and its
     backward 48 x 6), every loss finite and the mean loss of the 6
     steps' batches after the steps below their mean at init (batch 0's
     own printed beside it), one profiled warm step (wall, busy, idle
     share).  (c) each
     cut to its first 2 layers at full width, seed 0, B 1 (gemma3 S 576,
     mamba2 S 512), card against CPU in bf16 under `f32_accumulation` as
     the train step runs: the loss within rel 1e-2 and every gradient leaf
     within rel 2e-2 of its max |grad|, or, for a leaf past that, within
     the CPU's own distance from its f32 gradient of the same weights plus
     2e-2 (the CPU tests' rule, `tests/test_torch_train_bf16_archs.py`).
 19. the one-card tools, at most 60 s: (a) bf16 through the ConvNet path:
     vgg_mixed_channel's first wave (four requests, buckets 32 and 64) on
     the H100 model in fp32 and in bf16 on the card and in bf16 on the
     CPU: the bf16 tile-kernel launches equal the fp32 ones, and the card's
     bf16 outputs are within one bf16 ulp of the CPU's, elementwise, or rel
     1e-2 overall.  (b) `launch.serve.main` on gemma3-1b with `--trace`
     under build/: a valid Chrome trace (phase 10's check) with one
     `request:<rid>` instant per request, flash and decode-MLP launches
     above 0.  (c) the five `examples/torch_*.py`, each through its
     `main(argv)` on the card at a small size with its own checks
     (`torch_train_lm` 20 steps and its checkpoint resume under build/).
     (d) the dry run (`launch.dryrun.lower_cell`, meta device, one card) of
     phase 18's gemma3-1b bf16 step (4 x 1024): its flash forward,
     backward and conv1d calls equal the card's `LAUNCHES` a step of
     phase 18's run, its state (parameters, gradients, moments) is no
     more than that run's peak, and model FLOPs / the run's warm step
     time and `t_bound` are printed beside the step.  The dry run counts
     under `--impl optimized` (its default is `baseline`).
 20. the runtime flags and the compressed all-reduce, at most 90 s (aim
     60): (a) gemma3-1b at full size in fp32 and bf16, phase 6's six
     requests in two waves, prefill and 16 decode steps under
     `set_baseline()` (the chunked loop at S 700, two 512-key chunks; the
     decode loop over 512-slot chunks) against the same run under
     `Flags()`, teacher-forced on the default's greedy tokens: logits
     within rel 1e-4 of max |logits| in fp32, 2e-2 in bf16 (phase 17's
     rule); no flash launch under the baseline; prefill and decode ms of
     both.  (b) deepseek-v3-671b's MLA at full width (layer 0's
     attention), fp32, B 4 over a 700-position latent cache: 4 decode
     steps with `mla_absorb=False` (one masked pass, and the baseline's
     chunk loop) against the absorbed form, rel 1e-4.  (c) mamba2-1.3b
     at full width on 24 layers, fp32: two rounds of a train step with
     `ssm_chunk_remat` off and on, the first round's loss and every
     gradient within rel 1e-6, every step's ms and peak memory; wave 1's
     prefill and every position's logits at `ssm_chunk_override=128`
     against the config's chunk within rel 1e-3.  (d) `launch.dryrun
     --impl baseline` on gemma3-1b train_4k: status ok, no flash call.
     (e) the int8 compressed all-reduce with error feedback on gemma3-1b
     layer 0's seeded gradient tree, 3 steps, at world 1 over NCCL and at
     world 4 over gloo (four subprocesses on cuda:0, one FileStore): each
     bitwise the same reduction computed in one process on the card, and
     within one quantisation step of the CPU's (CUDA's division by 127
     multiplies by the reciprocal); the NCCL call's ms beside a plain f32
     all-reduce's; with n > 1 visible cards also at world n over NCCL
     (n more subprocesses started once gloo's have ended, rank i on
     cuda:i, their seconds outside the phase's limit), each rank's
     payload bitwise gloo's rank's where the worlds are one size.
     `python3 chip_smoke.py --phase 20` runs phases 1, 2 and 20 alone and
     prints no result line.
 21. the mesh, at most 90 s (aim 60 on one card): a mesh of 4 entries on
     cuda:{i % n} over the n visible cards (on one card all four share
     cuda:0, and the output says so); every card's name and power limit.
     (a) every kernel source at its largest shape (phase 3's widest vgg
     layer; zamba2's conv1d wave and decode MLP; deepseek-v3's MLA
     prefill; gemma3-1b's global training layer and mamba2's training
     slice for the backwards; fp32 and bf16) on every distinct card,
     against its plain version there (fp32 rel 1e-5, backwards 5e-5, bf16
     2e-2) and bitwise the first card's output, its launches counted on
     that card.  (b) `vgg_mixed_channel(3)` waves of 4, 16 and 64 rows
     and a ragged 16 through `ShardedWaveExecutor` on data meshes of N =
     1, 2, 4 entries against the unsharded wave (rel 1e-5, the bitwise
     count beside it), the tile launches each card made (those of the
     checked waves at N = 2 and 4, and only those, are the mesh path's
     count in the kernels line), and each wave's
     latency (median of 20, CUDA events on cuda:0 and host wall, host
     input to output on cuda:0).  (c) weight placement on the 4-entry
     mesh, unplaced, all REPLICATE, all SHARD and the 1 MiB decision:
     resident transform bytes by card, each position's share, bytes
     brought from other cards a 64-row wave, the wave's time, the output
     bitwise the unplaced one.  (d) an `ElasticPool` of 2 replicas x 4
     shards on the mesh on phase 12's exactness trace against 1 x 1
     (rel 1e-5; mesh and logical waves counted).  (e) gemma3-1b at full
     width on 2 layers, fp32, B 4 x S 700: logits with q stripes over a
     4-entry model axis (`use_mesh`) against the whole chunked attention,
     rel 1e-5.  `python3 chip_smoke.py --phase 21` runs phases 1, 2 and
     21 alone and prints no result line.

`python3 chip_smoke.py --phase 3` runs phase 1 and then phase 3's tile
kernel cases 20 times, every other round with the caching allocator's
free blocks filled with NaN, and prints no result line; a failed case,
here or in the full run, also reports the kernel's and the plain
version's error against a float64 `conv2d` on the CPU, whether a second
launch gives the same bits, and where the wrong elements lie.

Two studies run on their own, after phases 1 and 2, and print no result
line: `--ssm-chunk-gap` (where (c)'s chunk-128 gap comes from: by depth,
on the card and the CPU, against a float64 recurrence and planted
faults) and `--chunk-remat-cost` (what the default per-chunk remat costs
mamba2's train step, bf16 on 48 layers and fp32 on 24, over six rounds).

The line before the last is a JSON object listing the ported kernels; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX and
nothing of the reference package.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# phases 14-16 run within ~8 GiB of the card's memory: with fixed-size
# segments, deepseek-v3's training step once failed to place a 3.5 GiB
# block beside 7.2 GiB of reserved but fragmented memory; expandable
# segments remap free pages instead (set before CUDA initialises)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
PEAK_TF32 = 495e12  # H100 SXM TF32 tensor cores, dense (data sheet)
PEAK_BF16 = 989e12  # H100 SXM bf16 tensor cores, dense (data sheet)
HBM_BW = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
REL_TOL_KERNEL = 1e-5
PHASE3_ROUNDS = 20  # `--phase 3`: phase 3's tile-kernel cases this many times
REL_TOL_SERVE = 1e-3  # the reference's own net-level tolerance
SIZES = (64, 64, 32, 64, 32)  # the example's five requests
BUCKETS = (32, 64)
MAX_BATCH = 4
REPS = 25
KERNEL_SOURCE = "src/repro_torch/kernels/fused_tile/csrc/fused_tile.cu"
REL_TOL_ORACLE = 5e-5  # f32 tile kernel vs the f64 scan (the reference's vs direct)
# every planner of the run reads its wisdom here, in the checkout's build
# directory (phase 10 keeps its calibration in a file of its own)
PLAN_WISDOM = os.path.join(ROOT, "build", "chip_smoke_plan_wisdom.json")
REPLACES = "src/repro/kernels/fused_tile/kernel.py:53"


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max() / (ref.abs().max() + 1e-30))


def time_ms(fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event-timed calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


# ------------------------------------------------------------ phase 1 + 2


def phase_environment() -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device {name}")
    print(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def kernel_libraries():
    """name -> (CudaLibrary, wrapper module) for every kernel of the port."""
    from repro_torch.kernels.conv1d_fused import backward as conv1d_bwd_kernel
    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel
    from repro_torch.kernels.decode_mlp import kernel as mlp_kernel
    from repro_torch.kernels.flash_attention import backward as flash_bwd_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.fused_tile import kernel as tile_kernel

    return {
        "fused_tile": tile_kernel,
        "conv1d_fused": conv1d_kernel,
        "flash_attention": flash_kernel,
        "decode_mlp": mlp_kernel,
        "flash_attention_bwd": flash_bwd_kernel,
        "conv1d_fused_bwd": conv1d_bwd_kernel,
    }


def ptxas_report(source: str) -> dict:
    """`nvcc -Xptxas -v` on a kernel source (the build's flags, into a
    scratch library under build/): {entry function: (registers, stack
    frame bytes, spill store bytes, spill load bytes)}."""
    import tempfile

    from repro_torch.kernels import _build

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        out = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "ptxas.so"), os.path.join(ROOT, source)],
            capture_output=True, text=True, check=True)
    report, name, frame = {}, None, None
    for line in (out.stdout + out.stderr).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            frame = tuple(int(x) for x in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and name and frame:
            report[name] = (int(m.group(1)), *frame)
            name = frame = None
    return report


def phase_build() -> dict:
    """Every kernel built from the checkout's sources, one nvcc per
    source, all started together; beside them the ptxas reports of the
    flash forward's and backward's fp32 and bf16 sources, per
    instantiation (hd / vd), and of the bf16 conv1d forward stream's (K).
    Returns the fp32 backward's main kernel's
    registers and spills at hd 256."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    def timed(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return path, time.perf_counter() - t0

    # one library a source: the conv1d backward is an entry point of the
    # conv1d source's library; the flash kernels' bf16 instantiations are
    # sources of their own (`LIB_BF16`)
    libs = {}
    for name, mod in kernel_libraries().items():
        if hasattr(mod, "LIB"):
            libs[name] = mod.LIB
        if hasattr(mod, "LIB_BF16"):
            libs[f"{name}_bf16"] = mod.LIB_BF16
    sources = (LM_KERNELS["flash_attention"][0], FLASH_BF16_SOURCE, FLASH_BWD_SOURCE,
               FLASH_BWD_BF16_SOURCE, CONV1D_FWD_BF16_SOURCE)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)  # ptxas_report's scratch
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + len(sources)) as pool:
        futs = {name: pool.submit(timed, lib) for name, lib in libs.items()}
        reports = {src: pool.submit(ptxas_report, src) for src in sources}
        done = {name: f.result() for name, f in futs.items()}
        reports = {src: f.result() for src, f in reports.items()}
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}")
    for name, (lib, secs) in done.items():
        print(f"  {name:24s} {os.path.relpath(libs[name].source, ROOT)} -> "
              f"{os.path.relpath(lib, ROOT)} in {secs:.2f} s")
    print(f"  all {len(done)} kernels built in {time.perf_counter() - t0:.2f} s")
    hd256 = None
    for src, ptxas in reports.items():
        print(f"ptxas -v {src} (registers, stack frame / spill store / spill load bytes):")
        for fn, (regs, frame, st, ld) in sorted(ptxas.items()):
            kind = ("delta" if "delta" in fn else "bf16" if "bf16" in fn or "bfloat16" in fn
                    else "main")
            # the instantiation's template arguments: (hd, vd), or vd alone for
            # delta; the conv1d stream's tap count K
            dims = "/".join(re.findall(r"Li(\d+)E", fn)) or "?"
            arg = "K" if "conv1d" in fn else "hd"
            print(f"  {kind:5s} {arg:2s} {dims:>7s}: {regs} registers, {frame} / {st} / {ld} "
                  "bytes")
            if src == FLASH_BWD_SOURCE and kind == "main" and dims == "256/256":
                hd256 = dict(registers=regs, stack_frame_bytes=frame, spill_store_bytes=st,
                             spill_load_bytes=ld)
    if hd256 is None:
        raise AssertionError("ptxas reported no hd-256 instance of the backward's main kernel")
    return hd256


def phase_check() -> None:
    """`python -m repro_torch.convserve.check --strict`, in-process."""
    from repro_torch.convserve.check.__main__ import main as check_main

    t0 = time.perf_counter()
    rc = check_main(["--strict"])
    print(f"check: --strict exit {rc} in {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError("python -m repro_torch.convserve.check --strict failed")


# ----------------------------------------------------------------- phase 3


def kernel_cases():
    """(label, transform, batch, h, w, c_in, c_out, groups, bias_relu, r)
    at the served nets' own conv shapes, plus a grouped and a
    ragged-width case.  R is what the planner gives each layer under
    the H100 model (lowered by `fit_r` exactly as the served path does)."""
    from repro_torch.configs.convnets import fft_fewchannel, vgg_mixed_channel
    from repro_torch.core import analysis, transforms, tune

    hw = analysis.H100_SXM
    wino = transforms.WinogradTransform(m=5, k=3)
    fft = transforms.FFTTransform(t=16, k=3)
    cases = []
    for bucket in (64, 32):
        h = bucket
        for layer in vgg_mixed_channel(3).layers:
            if layer.kind == "maxpool":
                h //= 2
            if layer.kind != "conv":
                continue
            r = tune.predict_r(layer.c_in, layer.c_out, transform=wino, hw=hw)
            cases.append((
                f"vgg b{bucket} {layer.c_in}->{layer.c_out}@{h}", wino,
                MAX_BATCH, h, h, layer.c_in, layer.c_out, 1, False, r,
            ))
    seen = set()
    for layer in fft_fewchannel(4).layers:
        key = (layer.c_in, layer.c_out)
        if layer.kind != "conv" or key in seen:
            continue
        seen.add(key)
        r = tune.predict_r(layer.c_in, layer.c_out, transform=fft, hw=hw)
        cases.append((
            f"fft b64 {layer.c_in}->{layer.c_out}@64 +bias+relu", fft,
            MAX_BATCH, 64, 64, layer.c_in, layer.c_out, 1, True, r,
        ))
    cases.append(("fft grouped g=2 8->8@32", fft, 2, 32, 32, 8, 8, 2, True, 8))
    cases.append(("wino ragged 5->7@37x29", wino, 3, 37, 29, 5, 7, 1, False, 8))
    return cases


def make_case(case, gen: np.random.Generator):
    """Device tensors for one case: the kernel's operands and the plain
    version's, built from one seeded draw."""
    from repro_torch.core import registry, tiling
    from repro_torch.kernels.fused_tile import kernel

    label, tr, b, h, w, c_in, c_out, groups, bias_relu, r = case
    dev = torch.device("cuda")
    spec = tr.kernel_spec()
    x = torch.tensor(gen.standard_normal((b, h, w, c_in)) * 0.1,
                     dtype=torch.float32, device=dev)
    wk = torch.tensor(gen.standard_normal((3, 3, c_in // groups, c_out)) * 0.1,
                      dtype=torch.float32, device=dev)
    bvec = torch.tensor(gen.standard_normal(c_out) * 0.1,
                        dtype=torch.float32, device=dev)
    ep = registry.ElementwiseOps((("bias", bvec), ("relu",))) if bias_relu else None
    plan = tiling.TilePlan.build(h, w, tr.k, 1, tr.t)
    r = kernel.fit_r(spec, r, c_in, c_out)
    n_tiles = b * plan.n_tiles_h * plan.n_tiles_w
    geo = kernel.launch_geometry(spec, n_tiles, c_in, c_out, groups, r)
    rhs = spec.pack_rhs(tr.kernel_transform(wk), groups)
    if ep is not None:
        tags, biases = ep.kernel_form()
    else:
        tags, biases = (), torch.zeros((1, c_out), device=dev)
    return dict(
        label=label, spec=spec, plan=plan, geo=geo, r=r,
        blocks=geo.blocks(n_tiles, c_out),
        groups=groups, ep=ep, tags=tags, biases=biases.contiguous(),
        x=x, wk=wk, bvec=bvec, rhs=rhs,
        xp=tiling.pad_input(x, plan).contiguous(),
    )


def run_kernel(c):
    from repro_torch.kernels.fused_tile import fused_tile_call

    y = fused_tile_call(
        c["xp"], c["rhs"], c["biases"], spec=c["spec"],
        n_tiles_h=c["plan"].n_tiles_h, n_tiles_w=c["plan"].n_tiles_w,
        r=c["r"], groups=c["groups"], ep_ops=c["tags"],
    )
    return y[:, : c["plan"].h_out, : c["plan"].w_out, :]


def run_plain(c):
    from repro_torch.kernels.fused_tile import matrix_tile_conv

    return matrix_tile_conv(
        c["xp"], c["rhs"], c["plan"], c["spec"],
        groups=c["groups"], epilogue=c["ep"],
    )


def conv_f64(c) -> torch.Tensor:
    """The case's convolution in float64 on the CPU (`F.conv2d`, padding 1,
    the bias and ReLU where the case has them): a reference that shares
    no code with the kernel or its plain version."""
    import torch.nn.functional as F

    x = c["x"].double().cpu().permute(0, 3, 1, 2)
    w = c["wk"].double().cpu().permute(3, 2, 0, 1)
    y = F.conv2d(x, w, padding=1, groups=c["groups"])
    if c["ep"] is not None:
        y = torch.relu(y + c["bvec"].double().cpu()[None, :, None, None])
    return y.permute(0, 2, 3, 1)


def diagnose(c, y: torch.Tensor, ref: torch.Tensor) -> str:
    """Why a case failed: which of the kernel's and the plain version's
    outputs is wrong (each against float64), whether the kernel gives the
    same bits on a second launch, and where the wrong elements lie."""
    want = conv_f64(c)
    y2 = run_kernel(c)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    bad = ((y.double().cpu() - want).abs() > 1e-3 * scale).nonzero()
    where = "none"
    if len(bad):
        where = (f"{len(bad)} of {y.numel()} elements, first (b, h, w, c) "
                 f"{tuple(bad[0].tolist())}, last {tuple(bad[-1].tolist())}")
    return (f"kernel vs f64 {rel_err(y.double().cpu(), want):.3e}, plain vs f64 "
            f"{rel_err(ref.double().cpu(), want):.3e}, second launch vs f64 "
            f"{rel_err(y2.double().cpu(), want):.3e} (same bits as the first: "
            f"{bool(torch.equal(y, y2))}); kernel elements off f64 by > 1e-3 of "
            f"max: {where}")


def phase_kernel_vs_plain():
    gen = np.random.default_rng(0)
    made, worst_abs, worst_rel = [], 0.0, 0.0
    for case in kernel_cases():
        c = make_case(case, gen)
        y, ref = run_kernel(c), run_plain(c)
        torch.cuda.synchronize()
        if tuple(y.shape) != tuple(ref.shape) or not torch.isfinite(y).all():
            raise AssertionError(f"{c['label']}: bad kernel output {tuple(y.shape)}")
        err = rel_err(y, ref)
        abs_err = float((y - ref).abs().max())
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, err)
        g = c["geo"]
        print(f"kernel-vs-plain {c['label']:34s} R={g.r} ns={g.ns} sc={g.sc} "
              f"split={g.n_split} blocks={c['blocks']} "
              f"max_abs_err={abs_err:.3e} max_rel_err={err:.3e}")
        if not err < REL_TOL_KERNEL:
            raise AssertionError(
                f"{c['label']}: kernel vs plain rel err {err:.3e} >= {REL_TOL_KERNEL}; "
                f"{diagnose(c, y, ref)}"
            )
        made.append(c)
    return made, worst_abs, worst_rel


def poison_allocator() -> None:
    """Fill the caching allocator's free blocks with NaN: blocks of both of
    its pools (small requests up to 1 MB, large ones above) allocated,
    filled and freed, so that later `torch.empty` tensors start as NaN and
    an element a kernel leaves unwritten, or a read of memory no one
    wrote, shows in the output."""
    torch.cuda.empty_cache()
    junk = [torch.full((n,), float("nan"), device=DEV)
            for n, count in ((1 << 16, 256), (1 << 22, 8), (1 << 26, 4)) for _ in range(count)]
    torch.cuda.synchronize()
    del junk


def phase3_rounds(rounds: int = PHASE3_ROUNDS) -> int:
    """`python3 chip_smoke.py --phase 3`: phase 3's tile-kernel cases
    `rounds` times in this process, every other round on an allocator
    whose free blocks hold NaN (`poison_allocator`).  A failure raises
    with `diagnose`'s reading; no result line is printed."""
    for i in range(rounds):
        poisoned = i % 2 == 1
        if poisoned:
            poison_allocator()
        made, _, worst = phase_kernel_vs_plain()
        print(f"phase 3 round {i + 1}/{rounds}{' (NaN-filled allocator)' if poisoned else ''}: "
              f"{len(made)} cases, worst rel err {worst:.3e}")
        del made
    return 0


def phase_winograd_and_oracle() -> dict:
    """`l3_fused_pallas` against the plain version at vgg 64->64 @64 b4
    F(5,3), then the f32 tile kernel against the f64 `scan_tile_conv`
    oracle at the served vgg and fft shapes.  Comparison launches, outside
    every counted run."""
    from repro_torch.core import analysis, pipeline, registry, tiling, transforms, tune
    from repro_torch.kernels.fused_tile import conv2d_fused_tile, matrix_tile_conv
    from repro_torch.kernels.fused_winograd import conv2d_fused_pallas

    gen = np.random.default_rng(4)
    dev = torch.device(DEV)
    wino = transforms.WinogradTransform(m=5, k=3)
    x = torch.tensor(gen.standard_normal((MAX_BATCH, 64, 64, 64)) * 0.1,
                     dtype=torch.float32, device=dev)
    wk = torch.tensor(gen.standard_normal((3, 3, 64, 64)) * 0.1, dtype=torch.float32, device=dev)
    r = tune.predict_r(64, 64, transform=wino, hw=analysis.H100_SXM)
    spec = wino.kernel_spec()
    plan = tiling.TilePlan.build(64, 64, 3, 1, wino.t)
    ref = matrix_tile_conv(tiling.pad_input(x, plan), spec.pack_rhs(wino.kernel_transform(wk)),
                           plan, spec)
    y = conv2d_fused_pallas(x, wk, pad=1, m=5, r_tiles=r, device=dev)
    torch.cuda.synchronize()
    err = rel_err(y, ref)
    print(f"l3_fused_pallas vgg b4 64->64@64 F(5,3) R={r}: max_abs_err "
          f"{float((y - ref).abs().max()):.3e} max_rel_err {err:.3e} (tol {REL_TOL_KERNEL:g})")
    if not err < REL_TOL_KERNEL:
        raise AssertionError(f"l3_fused_pallas vs plain rel err {err:.3e}")
    worst = {"l3_fused_pallas": err}

    fft = transforms.FFTTransform(t=16, k=3)
    for label, tr, c_in, c_out, bias_relu in (
        ("vgg b4 64->64@64", wino, 64, 64, False),
        ("fft b4 8->8@64 +bias+relu", fft, 8, 8, True),
    ):
        xo = torch.tensor(gen.standard_normal((MAX_BATCH, 64, 64, c_in)) * 0.1,
                          dtype=torch.float32, device=dev)
        wo = torch.tensor(gen.standard_normal((3, 3, c_in, c_out)) * 0.1,
                          dtype=torch.float32, device=dev)
        bo = torch.tensor(gen.standard_normal(c_out) * 0.1, dtype=torch.float32, device=dev)
        ep = registry.ElementwiseOps((("bias", bo), ("relu",))) if bias_relu else None
        ep64 = (registry.ElementwiseOps((("bias", bo.double()), ("relu",)))
                if bias_relu else None)
        before = pipeline.SCAN_CALLS
        y = conv2d_fused_tile(xo, wo, tr, pad=1, epilogue=ep, device=dev)
        oracle = pipeline.scan_tile_conv(xo.double(), wo.double(), tr, pad=1, r_tiles=64,
                                         epilogue=ep64)
        torch.cuda.synchronize()
        if pipeline.SCAN_CALLS != before + 1 or oracle.dtype != torch.float64:
            raise AssertionError(f"{label}: the f64 oracle did not run through the scan")
        err = rel_err(y.double(), oracle)
        worst[f"oracle {label}"] = err
        print(f"f32 tile kernel vs f64 scan oracle {label}: max_rel_err {err:.3e} "
              f"(tol {REL_TOL_ORACLE:g})")
        if not err < REL_TOL_ORACLE:
            raise AssertionError(f"{label}: kernel vs f64 oracle rel err {err:.3e}")
    pipeline.SCAN_CALLS = 0  # from here on only f32 paths run: they must not reach it
    return worst


# ----------------------------------------------------------------- phase 5


def phase_serve():
    from repro_torch.configs.convnets import fft_fewchannel, vgg_mixed_channel
    from repro_torch.convserve import (
        ConvServeConfig, ConvServer, Engine, ImageRequest, init_weights,
        run_direct,
    )
    from repro_torch.core import analysis
    from repro_torch.kernels.fused_tile import kernel

    served = {}
    for spec in (vgg_mixed_channel(3), fft_fewchannel(4)):
        c_in = spec.conv_layers()[0][1].c_in
        engine = Engine(hw=analysis.H100_SXM, device="cuda")
        ws = init_weights(spec, seed=0)
        net = engine.compile(spec, ws, input_hw=(64, 64))
        srv = ConvServer(net, ConvServeConfig(max_batch=MAX_BATCH, buckets=BUCKETS))
        rng = np.random.default_rng(0)
        imgs = [rng.standard_normal((s, s, c_in)).astype(np.float32) * 0.1
                for s in SIZES]
        print(f"net {spec.name!r} on {engine.hw.name}:")
        print("  " + net.describe().replace("\n", "\n  "))
        print(f"  algorithms: {list(net.plan.algos())}")
        fused = [p.layer for p in net.plan.layers if p.algo in ("l3_fused", "fft_fused")]
        if not fused:
            print(f"  NOTE: {spec.name} plans no fused layer under {engine.hw.name}")

        kernel.LAUNCHES = 0  # main path: count only the served run
        t0 = time.perf_counter()
        out = srv.run([ImageRequest(i, im) for i, im in enumerate(imgs)])
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches_cold = kernel.LAUNCHES
        waves_cold = srv.stats()["waves"]

        kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        out2 = srv.run([ImageRequest(10 + i, im) for i, im in enumerate(imgs)])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches_warm = kernel.LAUNCHES
        waves_warm = srv.stats()["waves"] - waves_cold

        worst = 0.0
        for i, im in enumerate(imgs):
            ref = run_direct(spec, ws, torch.from_numpy(im)[None].cuda())[0]
            want = spec.out_shape(*im.shape)
            for y in (out[i], out2[10 + i]):
                if tuple(y.shape) != want or not np.isfinite(y).all():
                    raise AssertionError(f"{spec.name} rid {i}: bad output {y.shape}")
                worst = max(worst, rel_err(torch.from_numpy(y).cuda(), ref))
        print(f"  served {len(out)}+{len(out2)} requests: cold {cold_s * 1e3:.1f} ms, "
              f"warm {warm_s * 1e3:.1f} ms; max rel err vs direct {worst:.3e}")
        print(f"  stats: {srv.stats()}")
        print(f"  tile-kernel launches: cold {launches_cold} over {waves_cold} waves, "
              f"warm {launches_warm} over {waves_warm} waves "
              f"({launches_warm / max(waves_warm, 1):.1f} per wave)")
        if not worst < REL_TOL_SERVE:
            raise AssertionError(f"{spec.name}: rel err {worst:.3e} >= {REL_TOL_SERVE}")
        if fused and launches_cold < 1:
            raise AssertionError(f"{spec.name}: plan has fused layers {fused} "
                                 "but the tile kernel never launched")
        served[spec.name] = dict(
            net=net, fused=fused, launches=launches_cold + launches_warm,
            per_wave=launches_warm / max(waves_warm, 1), c_in=c_in,
        )
    if sum(s["launches"] for s in served.values()) < 1:
        raise AssertionError("the tile kernel never launched on the served path")
    return served


# ----------------------------------------------------------------- phase 9


def bound(c) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for this
    call -- operations at the fp32 peak vs each input read and each
    output written once at the HBM rate."""
    from repro_torch.kernels.fused_tile import cost

    spec, plan = c["spec"], c["plan"]
    b, _, _, c_in = c["x"].shape
    c_out = c["bvec"].shape[0]
    return _bound_of(cost(spec, plan.n_tiles_h, plan.n_tiles_w, b, c_in, c_out, c["groups"],
                          c["xp"].numel(), c["rhs"].numel(),
                          b * plan.h_out * plan.w_out * c_out))


# tile-kernel shapes whose device time phase 9 reads from the profiler
DEVICE_TIMED = ("vgg b64 64->64@64", "fft b64 8->8@64 +bias+relu")


# profiler sessions a measurement may take: in phase 13, after the gemma3
# paths, the first few sessions have recorded no device event at all
PROFILER_TRIES = 6


def kernel_breakdown(fn, key: str, reps: int = 20) -> list:
    """(kernel name, device ms a call, launches a call) of each kernel
    whose name holds `key` that `fn` launches, from `torch.profiler`'s
    device events over `reps` calls.  Each kernel counts its mean time a
    launch times its launches a call (its count over `reps`, rounded): the
    profiler now and then drops an event, and a total over `reps` would
    read that as a faster call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for attempt in range(PROFILER_TRIES):  # a session that records no device event runs again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        for e in events:
            if key in e.key and e.count:
                per_call = max(1, round(e.count / reps))
                rows.append((e.key, _device_ms(e) / e.count * per_call, per_call))
        if rows:
            break
        print(f"  profiler session {attempt + 1}: {len(events)} device events, none named "
              f"{key!r}")
    return rows


def device_ms(fn, key: str, reps: int = 20):
    """Device time per call of the kernels whose names hold `key` that
    `fn` launches (with their second passes, e.g. a reduction), summed
    over `kernel_breakdown`; None when the profiler saw no such event."""
    return sum(ms for _, ms, _ in kernel_breakdown(fn, key, reps)) or None


def phase_times(cases, served):
    import torch.nn.functional as F

    from repro_torch.convserve.planner import predict_stage_times

    rows = []
    for c in cases:
        x_nchw = c["x"].permute(0, 3, 1, 2).contiguous()
        w_oihw = c["wk"].permute(3, 2, 0, 1).contiguous()
        bias = c["bvec"] if c["ep"] is not None else None

        def library(x=x_nchw, w=w_oihw, bias=bias, g=c["groups"]):
            return F.conv2d(x, w, bias, padding=1, groups=g)

        k_ms = time_ms(lambda: run_kernel(c))
        p_ms = time_ms(lambda: run_plain(c))
        l_ms = time_ms(library)
        b_ms, b_by = bound(c)
        d_ms = device_ms(lambda: run_kernel(c), "tile_") if c["label"] in DEVICE_TIMED else None
        rows.append(dict(label=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        dev = "" if d_ms is None else f" (profiler device time {d_ms:.4f} ms)"
        print(f"time {c['label']:34s} kernel {k_ms:.4f} ms{dev}  plain {p_ms:.4f} ms  "
              f"F.conv2d {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    gen = np.random.default_rng(1)
    for name, s in served.items():
        net = s["net"]
        x = torch.tensor(gen.standard_normal((MAX_BATCH, 64, 64, s["c_in"])) * 0.1,
                         dtype=torch.float32, device="cuda")
        predicted = dict(predict_stage_times(net.program, net.hw))
        print(f"profile_stages {name} (warm 64-bucket wave, batch {MAX_BATCH}):")
        for label, secs in net.profile_stages(x):
            print(f"  {label:14s} {secs * 1e3:8.3f} ms  (roofline model "
                  f"{predicted[label] * 1e3:.3f} ms)")
        print(f"  tile-kernel launches per warm wave: {s['per_wave']:.1f}")
    return rows


# ----------------------------------------------------------------- phase 4

# the LM path's served requests: prompt lengths (wave 1 = the first four,
# longer than gemma3's 512 window; its mamba2 prefill pads 700 -> 768)
LM_PROMPTS = (700, 17, 300, 520, 64, 129)
LM_NEW = 16
LM_MAX_LEN = 768
LM_ARCHS = ("gemma3-1b", "mamba2-1.3b", "zamba2-7b")
DEV = "cuda"  # every LM phase runs its tensors here
# the card-vs-CPU cuts, in the config's layers: one period of depth
# (zamba2: one super-block -- the shared block and 6 mamba layers -- plus
# one mamba layer of the tail's kind)
LM_CUT = {"gemma3-1b": 6, "mamba2-1.3b": 4, "zamba2-7b": 7}
REL_TOL_LM_KERNEL = 1e-5  # kernel vs plain, both fp32, other sum orders
REL_TOL_LM_CPU = 1e-3  # card vs CPU logits, the reference's net tolerance
HD80_LABEL = "stablelm-3b hd80 B4 H32 S700 causal"
# zamba2-7b's served shapes of conv1d and the decode MLP: held against the
# plain versions and timed (with device time) beside the served row
ZAMBA_CONV_LABEL = "zamba2 wave1 B4 L768 D7296 (slice of 14576) silu"
ZAMBA_DECODE_LABEL = "zamba2 decode B4 d3584 f14336"
# seamless-m4t-medium's decoder MLP a decode step (d 1024, f 4096, B 4)
SEAMLESS_DECODE_MLP_LABEL = "seamless decode B4 d1024 f4096"
# shapes of conv1d and the decode MLP other than the served row that are
# timed (with device time) into the kernels line, by row key
SHAPE_TIMED = {ZAMBA_CONV_LABEL: "conv1d_fused_zamba2", ZAMBA_DECODE_LABEL: "decode_mlp_zamba2",
               SEAMLESS_DECODE_MLP_LABEL: "decode_mlp_seamless"}
# moonshot-v1-16b-a3b's prefill attention (MHA, hd 128, wave 1): held
# against the plain version and timed beside the served row, as hd 80 is
MOON_FLASH_LABEL = "moonshot hd128 B4 H16 S700 causal"
# deepseek-v3-671b's MLA prefill attention (MHA, q/k hd 192, v hd 128, wave
# 1) and its MTP block's attention (hd 56 in the padded instantiation, the
# training shape S 1023): held against the plain version and timed
# beside the served row
MLA_FLASH_LABEL = "deepseek MLA hd192/128 B4 H128 S700 causal"
MTP_FLASH_LABEL = "deepseek MTP hd56 B4 H128 S1023 causal"
# seamless-m4t-medium's serving attention (MHA, 16 heads of hd 64, B 4,
# 1024 source frames): the encoder's bidirectional self-attention, the
# decoder's causal self-attention over the 128-token prompt, the cross
# attention at the prefill and at a decode step
SEAMLESS_ENC_LABEL = "seamless encoder hd64 B4 H16 S1024 non-causal"
SEAMLESS_DEC_LABEL = "seamless decoder self hd64 B4 H16 S128 causal"
SEAMLESS_CROSS_LABEL = "seamless cross hd64 B4 H16 Sq128 Sk1024"
SEAMLESS_STEP_LABEL = "seamless cross decode hd64 B4 H16 Sq1 Sk1024"
# and its training forward (512 target tokens): decoder self and cross
SEAMLESS_DEC_TRAIN_LABEL = "seamless decoder self train hd64 B4 H16 S512 causal"
SEAMLESS_CROSS_TRAIN_LABEL = "seamless cross train hd64 B4 H16 Sq512 Sk1024"
FLASH_TIMED = {HD80_LABEL: "flash_attention_hd80", MOON_FLASH_LABEL: "flash_attention_moonshot",
               SEAMLESS_ENC_LABEL: "flash_attention_seamless_encoder",
               SEAMLESS_DEC_LABEL: "flash_attention_seamless_decoder",
               SEAMLESS_CROSS_LABEL: "flash_attention_seamless_cross",
               SEAMLESS_STEP_LABEL: "flash_attention_seamless_decode",
               SEAMLESS_DEC_TRAIN_LABEL: "flash_attention_seamless_decoder_train",
               SEAMLESS_CROSS_TRAIN_LABEL: "flash_attention_seamless_cross_train",
               MLA_FLASH_LABEL: "flash_attention_mla", MTP_FLASH_LABEL: "flash_attention_mtp"}
STABLELM_CUT = 2  # layers of stablelm-3b at full width in phase 7
# the flash forward's bf16 instantiation: a source of its own, on wgmma
FLASH_BF16_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bf16.cu"
# the bf16 conv1d backward: a TMA-fed source of its own
CONV1D_BWD_BF16_SOURCE = "src/repro_torch/kernels/conv1d_fused/csrc/conv1d_fused_bwd_bf16.cu"
# copies of gemma3-1b's MLP weights phase 17 rotates the decode MLP over
# (47.8 MB each in bf16, 239 MB together: more than the 50 MB L2)
DECODE_MLP_ROTATE = 5
LM_KERNELS = {
    "conv1d_fused": ("src/repro_torch/kernels/conv1d_fused/csrc/conv1d_fused.cu",
                     "src/repro/kernels/conv1d_fused/kernel.py:24"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:30"),
    "decode_mlp": ("src/repro_torch/kernels/decode_mlp/csrc/decode_mlp.cu",
                   "src/repro/kernels/decode_mlp/kernel.py:28"),
}


def _cuda(gen: np.random.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.tensor(gen.standard_normal(shape) * scale,
                        dtype=torch.float32, device=DEV)


def _bound(n_bytes: float, ops: float, peak: float = PEAK_FP32) -> tuple:
    t_ops, t_bytes = ops / peak * 1e3, n_bytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bound_of(cost: tuple, peak: float = PEAK_FP32, ops_factor: int = 1) -> tuple:
    """`_bound` of a kernel package's `cost` (FLOPs, bytes): its FLOPs
    times `ops_factor` at `peak`."""
    flops, n_bytes = cost
    return _bound(n_bytes, ops_factor * flops, peak)


def conv1d_cases(gen):
    """One dict per case: kernel, label, served, run / plain / library
    callables (library None where no single PyTorch call exists), bound."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.core import analysis, registry
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref, cost

    def xbc(arch):  # (d_inner, D of the xBC slice, width of zxbcdt, K)
        cfg = get_arch(arch)
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        d_xbc = d_inner + 2 * s.n_groups * s.d_state
        return d_inner, d_xbc, d_inner + d_xbc + d_inner // s.head_dim, s.d_conv

    d_inner, d_xbc, width, k_conv = xbc("mamba2-1.3b")  # 4096, 4352, 8512, 4
    z_inner, z_xbc, z_width, z_conv = xbc("zamba2-7b")  # 7168, 7296, 14576, 4
    cases = []
    for label, b, length, d, k, row, offset, act, served in (
        ("mamba2 wave1 B4 L768 D4352 (slice of 8512) silu", 4, 768, d_xbc, k_conv, width,
         d_inner, "silu", True),
        ("mamba2 wave2 B2 L129 D4352 (slice of 8512) silu", 2, 129, d_xbc, k_conv, width,
         d_inner, "silu", False),
        (ZAMBA_CONV_LABEL, 4, 768, z_xbc, z_conv, z_width, z_inner, "silu", False),
        ("zamba2 wave2 B2 L129 D7296 (slice of 14576) silu", 2, 129, z_xbc, z_conv, z_width,
         z_inner, "silu", False),
        ("ragged L777 D100 K4 none", 2, 777, 100, 4, 100, 0, "none", False),
        ("L5 < strip D64 K3 silu", 3, 5, 64, 3, 64, 0, "silu", False),
        # not 16-byte aligned: one channel per thread
        ("slice at column 65 D71 K4 silu", 2, 300, 71, 4, 200, 65, "silu", False),
        ("K1 L300 D256 none", 2, 300, 256, 1, 256, 0, "none", False),
        ("K8 L300 D256 silu", 2, 300, 256, 8, 256, 0, "silu", False),
        # the any-K instance: K-1 halo rows over one and two 8-row strips
        ("K9 B4 L768 D4352 (slice of 8512) silu", 4, 768, d_xbc, 9, width, d_inner, "silu",
         False),
        ("K9 B4 L768 D4352 (slice of 8512) none", 4, 768, d_xbc, 9, width, d_inner, "none",
         False),
        ("K16 B4 L768 D4352 (slice of 8512) silu", 4, 768, d_xbc, 16, width, d_inner, "silu",
         False),
        ("K16 B4 L768 D4352 (slice of 8512) none", 4, 768, d_xbc, 16, width, d_inner, "none",
         False),
    ):
        x = _cuda(gen, (b, length, row))[..., offset:offset + d]
        w, bias = _cuda(gen, (k, d), 0.5), _cuda(gen, (d,), 0.1)
        xt = x.transpose(1, 2).contiguous()  # (B, D, L) for F.conv1d
        wt = w.t().contiguous()[:, None, :]  # (D, 1, K)

        def library(xt=xt, wt=wt, bias=bias, k=k, length=length):
            # grouped F.conv1d with bias; the SiLU is a second call
            return F.conv1d(xt, wt, bias, padding=k - 1, groups=wt.shape[0])[..., :length]

        cases.append(dict(
            kernel="conv1d_fused", label=label, served=served,
            run=lambda x=x, w=w, bias=bias, act=act: conv1d_fused(x, w, bias, activation=act),
            plain=lambda x=x, w=w, bias=bias, act=act: conv1d_ref(x, w, bias, activation=act),
            library=library,
            library_silu=lambda library=library: F.silu(library()),
            bound=_bound_of(cost(b, length, d, k)),
            device_key="conv1d_fused_kernel",
        ))
    # a temporal ConvSpec planned and executed through the registry
    spec = registry.ConvSpec(h=1, w=300, c_in=48, c_out=48, k=4, pad=3, groups=48)
    ap = registry.plan_conv(spec, analysis.H100_SXM)
    if ap.algo != "conv1d_fused":
        raise AssertionError(f"temporal spec planned {ap.algo}, not conv1d_fused")
    x4, w4 = _cuda(gen, (2, 1, 300, 48)), _cuda(gen, (1, 4, 1, 48), 0.5)
    zero = torch.zeros(48, device=DEV)
    alg = registry.get(ap.algo)
    cases.append(dict(
        kernel="conv1d_fused", label="registry temporal ConvSpec L300 D48 K4", served=False,
        run=lambda: alg.execute(x4, w4, None, ap),
        plain=lambda: conv1d_ref(x4[:, 0], w4[0, :, 0, :], zero, activation="none")[:, None],
        library=None,
        bound=_bound_of(cost(2, 300, 48, 4)),
    ))
    return cases


def flash_cases(gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, cost, flash_attention

    cases = []
    # (the hd-80, moonshot, MLA and MTP rows are timed in phase 9 beside the
    # served one); vd is v's head dim, hd q's and k's
    for label, b, hq, hkv, sq, sk, hd, vd, causal, window, model_layout, served in (
        ("gemma3 wave1 global B4 S700 hd256 g4", 4, 4, 1, 700, 700, 256, 256, True, 0, True,
         True),
        ("gemma3 wave1 local w512 B4 S700 hd256 g4", 4, 4, 1, 700, 700, 256, 256, True, 512,
         True, False),
        ("gemma3 wave2 local w512 B2 S129 hd256 g4", 2, 4, 1, 129, 129, 256, 256, True, 512,
         True, False),
        ("g=1 B2 H4 S100 hd64 causal", 2, 4, 4, 100, 100, 64, 64, True, 0, False, False),
        ("non-causal Sq77 Sk256 hd128 g2", 1, 2, 1, 77, 256, 128, 128, False, 0, False, False),
        ("causal w40 Sq50 Sk200 hd32 g4", 2, 8, 2, 50, 200, 32, 32, True, 40, False, False),
        ("causal w8 S33 hd16 g4", 1, 4, 1, 33, 33, 16, 16, True, 8, False, False),
        ("causal w40 Sq200 > Sk50 + w hd64 g2", 1, 2, 1, 200, 50, 64, 64, True, 40, False,
         False),
        # head dims of registered configs in chunks of 8 columns
        (HD80_LABEL, 4, 32, 32, 700, 700, 80, 80, True, 0, True, False),
        ("zamba2 hd112 B2 H32 S768 causal w512", 2, 32, 32, 768, 768, 112, 112, True, 512,
         True, False),
        ("zamba2 hd112 B2 H32 S768 non-causal", 2, 32, 32, 768, 768, 112, 112, False, 0,
         False, False),
        (MOON_FLASH_LABEL, 4, 16, 16, 700, 700, 128, 128, True, 0, True, False),
        # deepseek-v3-671b: MLA's q/k and v head dims apart, the MTP block's
        # 56 padded in the kernel; at g 1, ragged Sq / Sk and rows that see
        # no key at both
        (MLA_FLASH_LABEL, 4, 128, 128, 700, 700, 192, 128, True, 0, True, False),
        (MTP_FLASH_LABEL, 4, 128, 128, 1023, 1023, 56, 56, True, 0, True, False),
        ("MLA g1 w40 Sq200 > Sk50 + w hd192/128", 1, 4, 4, 200, 50, 192, 128, True, 40, True,
         False),
        ("MLA g1 non-causal Sq77 Sk256 hd192/128", 1, 4, 4, 77, 256, 192, 128, False, 0,
         False, False),
        ("MTP g1 w40 Sq200 > Sk50 + w hd56", 1, 4, 4, 200, 50, 56, 56, True, 40, True, False),
        ("MTP g1 non-causal Sq77 Sk256 hd56", 1, 4, 4, 77, 256, 56, 56, False, 0, False,
         False),
        # seamless-m4t-medium at hd 64: 1,024 unmasked keys a row in the
        # encoder and the cross attention; Sq 1 puts one q row in a 64-row
        # tile; the decoder's causal self-attention; the training forward's
        # decoder self (S 512) and cross (Sq 512) shapes
        (SEAMLESS_ENC_LABEL, 4, 16, 16, 1024, 1024, 64, 64, False, 0, True, False),
        (SEAMLESS_DEC_LABEL, 4, 16, 16, 128, 128, 64, 64, True, 0, True, False),
        (SEAMLESS_CROSS_LABEL, 4, 16, 16, 128, 1024, 64, 64, False, 0, True, False),
        (SEAMLESS_STEP_LABEL, 4, 16, 16, 1, 1024, 64, 64, False, 0, True, False),
        (SEAMLESS_DEC_TRAIN_LABEL, 4, 16, 16, 512, 512, 64, 64, True, 0, True, False),
        (SEAMLESS_CROSS_TRAIN_LABEL, 4, 16, 16, 512, 1024, 64, 64, False, 0, True, False),
    ):
        if model_layout:  # the model's (B, S, H, hd), viewed as (B, H, S, hd)
            q = _cuda(gen, (b, sq, hq, hd)).transpose(1, 2)
            k = _cuda(gen, (b, sk, hkv, hd)).transpose(1, 2)
            v = _cuda(gen, (b, sk, hkv, vd)).transpose(1, 2)
        else:
            q, k, v = (_cuda(gen, (b, hq, sq, hd)), _cuda(gen, (b, hkv, sk, hd)),
                       _cuda(gen, (b, hkv, sk, vd)))
        # the SDPA yardstick gets kv heads repeated before the timed call
        qc = q.contiguous()
        kr = k.repeat_interleave(hq // hkv, 1).contiguous()
        vr = v.repeat_interleave(hq // hkv, 1).contiguous()
        qp = torch.arange(sq, device=DEV)[:, None]
        kp = torch.arange(sk, device=DEV)[None, :]
        ok = torch.ones((sq, sk), dtype=torch.bool, device=DEV)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= qp - kp < window

        # every key visible (non-causal, no window): SDPA without a mask
        mask = None if not (causal or window) else ok

        def library(qc=qc, kr=kr, vr=vr, mask=mask):
            return F.scaled_dot_product_attention(qc, kr, vr, attn_mask=mask)

        def library_causal(qc=qc, kr=kr, vr=vr):
            # no mask tensor: SDPA may skip the upper triangle
            return F.scaled_dot_product_attention(qc, kr, vr, is_causal=True)

        # QK^T over hd, P.V over vd on the band's pairs; q, k, v in, o out
        fc = cost(b, hq, hkv, sq, sk, hd, vd, causal=causal, window=window)
        cases.append(dict(
            kernel="flash_attention", label=label, served=served,
            run=lambda q=q, k=k, v=v, c=causal, w=window: flash_attention(q, k, v, causal=c, window=w),
            plain=lambda q=q, k=k, v=v, c=causal, w=window: attention_ref(q, k, v, causal=c, window=w),
            library=library,
            library_causal=library_causal if causal and not window and sq == sk else None,
            # the kernel's fp32-accurate products run on the tensor cores as
            # three TF32 products each (split operands): its bound is theirs;
            # the same FLOPs on the fp32 FMA units are the secondary bound
            bound=_bound_of(fc, PEAK_TF32, ops_factor=3),
            bound_fp32_ms=_bound_of(fc)[0],
            device_key="flash_fwd",
        ))
    return cases


def decode_mlp_cases(gen):
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_mlp import cost, decode_mlp, decode_mlp_ref

    cfg, z = get_arch("gemma3-1b"), get_arch("zamba2-7b")
    cases = []
    for label, b, d, f, served in (
        (f"gemma3 decode B4 d{cfg.d_model} f{cfg.d_ff}", 4, cfg.d_model, cfg.d_ff, True),
        (f"gemma3 decode B2 d{cfg.d_model} f{cfg.d_ff}", 2, cfg.d_model, cfg.d_ff, False),
        (f"gemma3 decode B1 d{cfg.d_model} f{cfg.d_ff}", 1, cfg.d_model, cfg.d_ff, False),
        # zamba2's shared MLP: its own launch geometry (~179 KB of shared memory at B4)
        (ZAMBA_DECODE_LABEL, 4, z.d_model, z.d_ff, False),
        (f"zamba2 decode B2 d{z.d_model} f{z.d_ff}", 2, z.d_model, z.d_ff, False),
        (f"zamba2 decode B1 d{z.d_model} f{z.d_ff}", 1, z.d_model, z.d_ff, False),
        (SEAMLESS_DECODE_MLP_LABEL, 4, 1024, 4096, False),
        ("ragged B11 d200 f700", 11, 200, 700, False),
        ("B1 d64 f33", 1, 64, 33, False),
    ):
        x = _cuda(gen, (b, d))
        w1, w3 = _cuda(gen, (d, f), d ** -0.5), _cuda(gen, (d, f), d ** -0.5)
        w2 = _cuda(gen, (f, d), f ** -0.5)
        cases.append(dict(
            kernel="decode_mlp", label=label, served=served,
            run=lambda x=x, w1=w1, w3=w3, w2=w2: decode_mlp(x, w1, w3, w2),
            plain=lambda x=x, w1=w1, w3=w3, w2=w2: decode_mlp_ref(x, w1, w3, w2),
            library=None,
            bound=_bound_of(cost(b, d, f)),
            device_key="decode_mlp",
        ))
    return cases


def phase_lm_kernels_vs_plain():
    """Each LM kernel against its plain version on the card, on the same
    inputs, at the served shapes and at the edge cases."""
    gen = np.random.default_rng(0)
    cases = conv1d_cases(gen) + flash_cases(gen) + decode_mlp_cases(gen)
    worst = {}
    for c in cases:
        y, ref = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        if tuple(y.shape) != tuple(ref.shape) or not torch.isfinite(y).all():
            raise AssertionError(f"{c['label']}: bad kernel output {tuple(y.shape)}")
        abs_err = float((y - ref).abs().max())
        err = rel_err(y, ref)
        w = worst.setdefault(c["kernel"], [0.0, 0.0])
        w[0], w[1] = max(w[0], abs_err), max(w[1], err)
        print(f"kernel-vs-plain {c['kernel']:15s} {c['label']:48s} "
              f"max_abs_err={abs_err:.3e} max_rel_err={err:.3e} "
              f"(tol rel {REL_TOL_LM_KERNEL:g})")
        if not err < REL_TOL_LM_KERNEL:
            raise AssertionError(
                f"{c['label']}: kernel vs plain rel err {err:.3e} >= {REL_TOL_LM_KERNEL}"
            )
    return cases, worst


# ------------------------------------------------------------ phase 6 - 8


def lm_requests(cfg, lengths, seed: int = 0):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=LM_NEW) for i, n in enumerate(lengths)]


def phase_serve_lm():
    """gemma3-1b and mamba2-1.3b at full published width and depth, fp32,
    random weights from seed 0: six requests, max_batch 4 (one full and
    one partial wave), 16 new tokens each.  Every kernel count is zeroed
    just before a model is served and read just after."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, ServeConfig

    mods = kernel_libraries()
    served = {}
    for name in LM_ARCHS:
        cfg = dataclasses.replace(get_arch(name), dtype="float32")
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_lm(cfg, seed=0, device=DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{n_params / 1e9:.3f} B params fp32, init {time.perf_counter() - t0:.2f} s")
        reqs = lm_requests(cfg, LM_PROMPTS)
        engine = Engine(model, ServeConfig(max_batch=MAX_BATCH, max_len=LM_MAX_LEN))
        for mod in mods.values():
            mod.LAUNCHES = 0  # main path: count only the served run
        t0 = time.perf_counter()
        out = engine.run(reqs, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: mod.LAUNCHES for k, mod in mods.items()}
        for r in reqs:
            toks = out[r.rid]
            if len(toks) != LM_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"{name} rid {r.rid}: bad tokens {toks}")
        waves, steps = len(engine.waves), sum(w["decode_steps"] for w in engine.waves)
        n_tok = sum(w["tokens"] for w in engine.waves)
        for i, w in enumerate(engine.waves):
            print(f"  wave {i}: {w['size']} requests, prompt {w['prompt_len']} tokens, "
                  f"prefill {w['prefill_s'] * 1e3:.2f} ms, decode "
                  f"{w['decode_s'] / max(w['decode_steps'], 1) * 1e3:.3f} ms/step "
                  f"over {w['decode_steps']} steps")
        print(f"  {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s "
              f"({n_tok / wall:.1f} tokens/s, host clock after synchronize)")
        specs = model.specs
        want = {
            "fused_tile": 0,
            "flash_attention_bwd": 0,
            "conv1d_fused_bwd": 0,
            "flash_attention": sum(s.mixer in ("attn", "shared_attn") for s in specs) * waves,
            "decode_mlp": sum(s.has_mlp for s in specs) * steps,
            "conv1d_fused": sum(s.mixer == "mamba" for s in specs) * waves,
        }
        print(f"  launches: {launches} over {waves} waves, {steps} decode steps "
              f"(per prefill wave: flash {launches['flash_attention'] / waves:g}, "
              f"conv1d {launches['conv1d_fused'] / waves:g}; per decode step: "
              f"decode_mlp {launches['decode_mlp'] / steps:g})")
        for k, n in want.items():
            if launches[k] != n:
                raise AssertionError(f"{name}: {k} launched {launches[k]} times, "
                                     f"expected {n} (layers x waves or steps)")
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak max_memory_allocated {peak / 2**30:.2f} GiB (from before the init)")
        served[name] = dict(model=model, cfg=cfg, launches=launches, waves=waves,
                            steps=steps, peak_bytes=peak, wave_stats=engine.waves)
    return served


def _cut(model, n_layers: int, **changes):
    """The same weights (shared, not copied), cut to `n_layers` of the
    config's layers (and any other `changes` of its config, e.g. a shorter
    shared-attention period): the cut plan's layers, each the next layer
    of the full stack with the same mixer (a prefix, except where the
    cut's plan skips the full stack's next shared-attention invocation)."""
    import dataclasses

    from repro_torch.models import blocks
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers, **changes)
    tree = {k: model[k] for k in ("embed", "final_norm", "lm_head", "shared") if k in model}
    full = iter(zip(model.specs, model.layers))
    tree["layers"] = []
    for spec in blocks.plan_layer_specs(blocks.build_stack_plan(cfg)):
        tree["layers"].append(next(lp for s, lp in full if s.mixer == spec.mixer))
    return LM(cfg, tree)


def _logits_run(model, toks: np.ndarray, steps: int, forced=None, src=None):
    """Prefill `toks` (an encoder-decoder: over the source frames `src`, a
    host array), then `steps` decode steps fed greedily from this model's
    own logits, or teacher-forced on `forced`.  Returns the logits (steps
    + 1, B, V) on the host and the tokens fed."""
    from repro_torch.models import lm_decode_step, lm_prefill

    dev = model.device
    kw = {} if src is None else {"src_embeds": torch.from_numpy(src).to(dev)}
    logits, state = lm_prefill(model, torch.from_numpy(toks).to(dev), LM_MAX_LEN, **kw)
    out, fed = [logits.float().cpu()], []
    for t in range(steps):
        cur = forced[t] if forced is not None else out[-1].argmax(-1).numpy()
        fed.append(cur)
        logits, state = lm_decode_step(
            model, torch.from_numpy(np.asarray(cur, np.int64)).to(dev),
            toks.shape[1] + t, state)
        out.append(logits.float().cpu())
    return torch.stack(out), fed


def _card_vs_cpu(name: str, cut, cfg, n_layers: int):
    """One wave of two requests (600 and 40 tokens, one longer than a
    512 window) through `cut` on the card and through a copy on the CPU:
    prefill and teacher-forced decode logits within REL_TOL_LM_CPU, and
    the same greedy tokens.  Returns the kernel launches of the card run
    and each device's MoE routing, one `Routing` per MoE layer and call
    (none without experts)."""
    from repro_torch.models import record_routing

    cpu = _cpu_copy(cut)
    reqs = lm_requests(cfg, (600, 40), seed=1)
    toks = np.zeros((2, 600), np.int64)
    for i, r in enumerate(reqs):
        toks[i, 600 - len(r.prompt):] = r.prompt
    mods = kernel_libraries()
    for mod in mods.values():
        mod.LAUNCHES = 0  # count only the card run
    t0 = time.perf_counter()
    with record_routing() as card_routes:
        card, fed = _logits_run(cut, toks, LM_NEW)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    t0 = time.perf_counter()
    with record_routing() as cpu_routes:
        host, _ = _logits_run(cpu, toks, LM_NEW, forced=fed)
    t_cpu = time.perf_counter() - t0
    if not (torch.isfinite(card).all() and torch.isfinite(host).all()):
        raise AssertionError(f"{name}: non-finite logits")
    scale = float(host.abs().max())
    errs = [float((card[i] - host[i]).abs().max()) / scale for i in range(len(card))]
    top2 = card.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    same = bool((card.argmax(-1) == host.argmax(-1)).all())
    print(f"card-vs-cpu {name} cut to {n_layers} layers, prompts (600, 40): "
          f"prefill rel err {errs[0]:.3e}, decode max rel err {max(errs[1:]):.3e} "
          f"(tol {REL_TOL_LM_CPU:g}); greedy tokens equal: {same} "
          f"(smallest top-2 logit margin {margin:.3e}); card {t_card:.2f} s, "
          f"cpu {t_cpu:.2f} s; card launches {launches}")
    if not max(errs) < REL_TOL_LM_CPU:
        raise AssertionError(f"{name}: card vs cpu rel err {max(errs):.3e}")
    if not same:
        raise AssertionError(f"{name}: greedy tokens differ between card and cpu")
    return launches, dict(card=card_routes, cpu=cpu_routes)


def phase_lm_vs_cpu(served):
    """The served weights cut to one period of depth, card against CPU
    (`_card_vs_cpu`)."""
    for name, s in served.items():
        _card_vs_cpu(name, _cut(s["model"], LM_CUT[name]), s["cfg"], LM_CUT[name])


def phase_stablelm_vs_cpu() -> dict:
    """stablelm-3b, whose head dim 80 the flash kernel takes in chunks of
    8 columns: STABLELM_CUT layers at full width (d 2560, 32 heads of 80,
    d_ff 6912, vocab 50304), fp32, random weights from seed 0, card
    against CPU (`_card_vs_cpu`).  The prefill must launch flash once per
    attention layer."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_arch("stablelm-3b"), dtype="float32",
                              n_layers=STABLELM_CUT)
    published_width(cfg, (2560, 32, 80, 6912, 50304))
    model = init_lm(cfg, seed=0, device=DEV)
    launches, _ = _card_vs_cpu("stablelm-3b", model, cfg, STABLELM_CUT)
    attn = sum(s.mixer == "attn" for s in model.specs)
    if launches["flash_attention"] != attn:
        raise AssertionError(f"stablelm-3b: flash launched {launches['flash_attention']} "
                             f"times in one prefill, expected {attn} (attention layers)")
    return launches


def published_width(cfg, dims: tuple) -> None:
    """Raise unless `cfg` has the published (d_model, heads, head dim,
    d_ff[, vocab]) `dims`: a depth cut keeps the width."""
    have = (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
    if have[:len(dims)] != tuple(dims):
        raise AssertionError(f"{cfg.name} is not at its published width: {have}")


def _kernel_events(prof) -> list:
    """The profiler's device-side events (kernels, copies, memsets),
    averaged by name.  Host-side operator events also carry the device
    time of the kernels they launched, so summing them too would count
    each kernel twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _device_ms(event) -> float:
    """An averaged device event's total time, ms."""
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0)
    return us / 1e3


def profile_call(name: str, label: str, fn) -> dict:
    """One warm call of `fn` timed on the host (after synchronize, without
    the profiler), then one under `torch.profiler`: wall time beside
    device busy time summed over the device events, the idle share
    between them, and the kernels that take the most device time.
    Returns wall_ms, busy_ms (None when the profiler saw no device event),
    idle_share and the events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = _kernel_events(prof)
    busy = sum(_device_ms(e) for e in events)
    if busy <= 0:
        print(f"profile {name} {label}: wall {wall:.3f} ms; device time not "
              "measured (the profiler saw no device events)")
        return dict(wall_ms=wall, busy_ms=None, idle_share=None, events=[])
    idle = max(0.0, 1 - busy / wall)
    print(f"profile {name} {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"in {sum(e.count for e in events)} device events, idle share {idle:.3f}")
    for e in sorted(events, key=_device_ms, reverse=True)[:8]:
        print(f"  {_device_ms(e):9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=idle, events=events)


def phase_lm_profile(served):
    """Where a wave's time goes: one warm prefill of wave 1's four prompts
    and one decode step after it, per model.  Wall time on the host clock
    (after synchronize, without the profiler), device busy time summed
    over `torch.profiler`'s device events, the idle share between them,
    and the kernels that take the most device time.  Returns, per model
    whose prefill launches the conv1d kernel, its device time summed over
    those launches."""
    from repro_torch.models import lm_decode_step, lm_prefill

    totals = {}  # conv1d's device time in a prefill, per model that launches it
    for name, s in served.items():
        model, cfg = s["model"], s["cfg"]
        reqs = lm_requests(cfg, LM_PROMPTS[:MAX_BATCH])
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt
        toks = torch.from_numpy(toks).to(DEV)
        _, state = lm_prefill(model, toks, LM_MAX_LEN)
        tok = toks[:, -1]
        calls = {
            f"prefill B{len(reqs)} S{plen}": lambda: lm_prefill(model, toks, LM_MAX_LEN),
            f"decode step B{len(reqs)}": lambda: lm_decode_step(model, tok, plen, state),
        }
        for label, fn in calls.items():
            events = profile_call(name, label, fn)["events"]
            conv = [e for e in events if "conv1d_fused_kernel" in e.key]
            if conv:
                conv_ms = sum(_device_ms(e) for e in conv)
                n = sum(e.count for e in conv)
                print(f"  conv1d kernel: {conv_ms:.4f} ms device time in {n} launches "
                      f"({conv_ms / n:.4f} ms each)")
                totals[name] = dict(prefill_wave_device_ms=conv_ms, prefill_wave_launches=n)
    return totals


def phase_lm_times(cases):
    """Kernel, plain and library times at every LM case (median of CUDA
    events), beside the bound; at each kernel's served shape also
    `torch.profiler`'s device time; for causal flash cases with no window
    SDPA with `is_causal=True` beside the masked call; for conv1d,
    `F.conv1d` + `F.silu` beside `F.conv1d`.  The served shape's row goes
    into the kernels line."""
    rows = {}
    for c in cases:
        k_ms = time_ms(c["run"])
        p_ms = time_ms(c["plain"])
        l_ms = time_ms(c["library"]) if c["library"] is not None else None
        lc_ms = time_ms(c["library_causal"]) if c.get("library_causal") else None
        ls_ms = time_ms(c["library_silu"]) if c.get("library_silu") else None
        timed = c["served"] or c["label"] in (*FLASH_TIMED, *SHAPE_TIMED)
        d_ms = device_ms(c["run"], c["device_key"]) if timed and "device_key" in c else None
        b_ms, b_by = c["bound"]
        lib = f"{l_ms:.4f} ms" if l_ms is not None else "-"
        extra = "" if d_ms is None else f" (profiler device time {d_ms:.4f} ms)"
        if lc_ms is not None:
            lib += f", is_causal {lc_ms:.4f} ms"
        if ls_ms is not None:
            lib += f", + F.silu {ls_ms:.4f} ms"
        fp32 = c.get("bound_fp32_ms")
        bounds = f"bound {b_ms:.4f} ms ({b_by}"
        bounds += ")" if fp32 is None else (
            f", split-TF32 tensor cores), fp32 FMA bound {fp32:.4f} ms")
        print(f"time {c['kernel']:15s} {c['label']:48s} kernel {k_ms:.4f} ms{extra}  "
              f"plain {p_ms:.4f} ms  library {lib}  {bounds}")
        if c["label"] in FLASH_TIMED:
            rows[FLASH_TIMED[c["label"]]] = dict(
                shape=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
                library_is_causal_ms=lc_ms, bound_ms=b_ms, bound_by=b_by,
                bound_fp32_ms=c.get("bound_fp32_ms"))
        if c["label"] in SHAPE_TIMED:
            rows[SHAPE_TIMED[c["label"]]] = dict(
                shape=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, bound_by=b_by)
        if c["served"]:
            row = dict(shape=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
            if c["kernel"] == "flash_attention":
                row.update(library_is_causal_ms=lc_ms, bound_fp32_ms=fp32)
            if c["kernel"] == "conv1d_fused":
                row.update(library_silu_ms=ls_ms, library_note=(
                    "library_ms is grouped F.conv1d with bias, without the SiLU; "
                    "library_silu_ms adds F.silu; no single PyTorch call computes "
                    "the fused function"))
            rows[c["kernel"]] = row
    return rows


# ------------------------------------------------------------ phase 10

ONLINE_WISDOM = os.path.join(ROOT, "build", "chip_smoke_wisdom.json")
ONLINE_RECORDER = os.path.join(ROOT, "build", "chip_smoke_online")
ONLINE_TRACE = os.path.join(ROOT, "build", "chip_smoke_online.trace.json")


# the algorithms the tile kernel runs
TILE_ALGOS = ("l3_fused", "l3_fused_pallas", "fft_fused")


def tile_launches_per_wave(spec, program, bucket: int) -> int:
    """Tile-kernel launches one wave at `bucket` makes, from the replica's
    program: one per tile-kernel conv of a single stage, and one per
    tile-kernel conv per row super-tile of a fusion group."""
    shapes = spec.infer_shapes(bucket, bucket, spec.conv_layers()[0][1].c_in)
    n = 0
    for stage in program.stages:
        convs = sum(u.plan.algo in TILE_ALGOS for u in stage.units)
        tiles = 1
        if stage.fused and stage.tile_rows > 0:
            rows = shapes[stage.units[-1].layer][0]  # the group's output rows
            tiles = -(-rows // stage.tile_rows)
        n += convs * tiles
    return n


def phase_online(smi: str) -> dict:
    """vgg_mixed_channel served online through `ServeRuntime`, as
    `benchmarks/serve_runtime_bench.py` serves it: two replicas of one
    `ReplicaPool` (each worker on its own CUDA stream), RuntimeConfig(
    max_batch=8, buckets=(32, 64), queue_depth=128, slo_s=1.0,
    service_est_s=0.05), the seeded trace poisson_trace(40.0, 120, seed=7,
    sizes=(32, 48, 64)) replayed on the real clock, images from
    make_images(seed=1).  The engine plans on `H100_SXM` with roofs
    calibrated on this card (`tune.measure_calibration`, into a wisdom
    file under build/); a `Tracer` and a `FlightRecorder` ride along.
    Fails unless every request is answered within REL_TOL_SERVE of the
    direct oracle with no error and no rejection, the shared cache misses
    nothing after warmup, both replicas served, the tile kernel launched,
    the calibrated plan equals the uncalibrated one, the roofline has a
    row per stage, no wave was lost and the exported trace is valid.
    These are one run's times, not a metric."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights, plan_net, run_direct
    from repro_torch.convserve.obs import (
        TRIP_WAVE_LOSS, FlightRecorder, Tracer, roofline_table, validate_chrome_trace,
        write_trace,
    )
    from repro_torch.convserve.runtime import (
        ReplicaPool, RuntimeConfig, ServeRuntime, make_images, poisson_trace,
    )
    from repro_torch.core import analysis, tune
    from repro_torch.kernels.fused_tile import kernel as tile_kernel

    if os.path.exists(ONLINE_WISDOM):
        os.unlink(ONLINE_WISDOM)
    t0 = time.perf_counter()
    calib = tune.measure_calibration(ONLINE_WISDOM, device="cuda")
    print(f"online: calibration on {smi} in {time.perf_counter() - t0:.2f} s: "
          f"peak_flops {calib['peak_flops']:.6e} FLOP/s (fp32 GEMM n={calib['gemm_n']}, "
          f"TF32 off), dram_bw {calib['dram_bw']:.6e} B/s ({calib['stream_mb']} MB read + "
          f"{calib['stream_mb']} MB written); data sheet {analysis.H100_SXM.peak_flops:.3e} "
          f"FLOP/s, {analysis.H100_SXM.dram_bw:.3e} B/s")
    hw = analysis.calibrated_hw(analysis.H100_SXM, wisdom_path=ONLINE_WISDOM, device="cuda")
    spec = vgg_mixed_channel(3)
    ws = init_weights(spec, seed=0)
    tracer = Tracer()
    engine = Engine(hw=hw, device="cuda", tracer=tracer)
    pool = ReplicaPool.build(engine, spec, ws, n=2, input_hw=(64, 64),
                             wisdom_path=ONLINE_WISDOM)
    plain = plan_net(spec, 64, 64, hw=analysis.H100_SXM, wisdom_path=ONLINE_WISDOM,
                     device="cuda")
    algos = list(pool.executors[0].plan.algos())
    print(f"online: plan on {hw.name} (CMR_fast {hw.cmr_fast:g}, min R "
          f"{analysis.min_r(hw)}): {algos}; uncalibrated {list(plain.algos())}")
    if algos != list(plain.algos()):
        raise AssertionError("calibration moved the plan: CMR_fast was not preserved")
    recorder = FlightRecorder(tracer, path_prefix=ONLINE_RECORDER)
    cfg = RuntimeConfig(max_batch=8, buckets=(32, 64), queue_depth=128, slo_s=1.0,
                        service_est_s=0.05)
    rt = ServeRuntime(pool, cfg, tracer=tracer, recorder=recorder)
    served_waves = []  # (replica, bucket, padded batch, requests, compute s) per wave
    rt.add_wave_observer(lambda res: served_waves.append((
        res.replica, res.wave.bucket, res.wave.batch_size, len(res.wave.requests),
        res.compute_s)))
    trace = poisson_trace(40.0, 120, seed=7, sizes=(32, 48, 64))
    images = make_images(trace, spec.conv_layers()[0][1].c_in, seed=1)
    try:
        t0 = time.perf_counter()
        rt.warmup()
        print(f"online: warmup {time.perf_counter() - t0:.2f} s")
        warm_misses = pool.cache.stats()["misses"]
        tile_kernel.LAUNCHES = 0  # main path: count only the served run
        t0 = time.perf_counter()
        results = rt.play(trace, images)
        torch.cuda.synchronize()
        makespan = time.perf_counter() - t0
        launches = tile_kernel.LAUNCHES
        doc = rt.stats(profile_bucket=64)
    finally:
        rt.shutdown()
    lat = doc["latency"]
    for name in ("e2e", "compute", "queue_wait"):
        h = lat.get(name, {})
        print(f"online: {name:10s} p50 {h.get('p50_s', 0) * 1e3:.3f} ms  p95 "
              f"{h.get('p95_s', 0) * 1e3:.3f} ms  max {h.get('max_s', 0) * 1e3:.3f} ms  "
              f"over {h.get('count', 0)}")
    counters, sched = doc["counters"], doc["scheduler"]
    print(f"online: {len(results)} of {len(trace)} requests in makespan {makespan:.3f} s "
          f"({len(results) / makespan:.2f} requests/s); waves {counters.get('waves', 0)}, "
          f"partial {counters.get('partial_waves', 0)}, cold {counters.get('cold_waves', 0)}; "
          f"by reason {sched['waves_by_reason']}; dispatched {doc['pool']['dispatched']}")
    print("online: waves in completion order (replica, bucket, batch, requests, compute ms): "
          + ", ".join(f"({r}, {b}, {n}, {k}, {c * 1e3:.2f})" for r, b, n, k, c in served_waves))
    program = pool.executors[0].program
    per_bucket = {b: tile_launches_per_wave(spec, program, b) for b in cfg.buckets}
    want_launches = sum(per_bucket[b] for _, b, _, _, _ in served_waves)
    print(f"online: cache {doc['cache']}; misses after warmup "
          f"{doc['cache']['misses'] - warm_misses}; tile-kernel launches {launches}, "
          f"expected {want_launches} (per wave by bucket {per_bucket}, over "
          f"{len(served_waves)} waves)")
    print(f"online: counters {counters}")
    rows = (doc.get("roofline") or {}).get("stages", [])
    print(roofline_table(rows, hw_name=f"{hw.name} ({smi})"))
    n_events = write_trace(tracer, ONLINE_TRACE)
    with open(ONLINE_TRACE) as f:
        problems = validate_chrome_trace(json.load(f))
    st = tracer.stats()
    print(f"online: trace {n_events} Chrome events, {st['recorded']} recorded, "
          f"{st['dropped']} dropped, {st['open_spans']} open; recorder trips "
          f"{recorder.stats()['trips']}")

    worst = 0.0
    for a in trace:
        y = results.get(a.rid)
        ref = run_direct(spec, ws, torch.from_numpy(images[a.rid])[None].cuda())[0]
        want = spec.out_shape(a.h, a.w, images[a.rid].shape[2])
        if y is None or tuple(y.shape) != want or not np.isfinite(y).all():
            raise AssertionError(f"online rid {a.rid}: bad or missing output")
        worst = max(worst, rel_err(torch.from_numpy(y).cuda(), ref))
    print(f"online: max rel err vs direct (cuDNN, TF32 off) {worst:.3e} (tol {REL_TOL_SERVE:g})")
    labels = [st_.label for st_ in pool.executors[0].program.stages]
    checks = {
        "every request answered": len(results) == len(trace),
        "no wave error": not rt.errors and counters.get("wave_errors", 0) == 0,
        "no rejection": not rt.rejections and counters.get("rejected", 0) == 0,
        "within tolerance of direct": worst < REL_TOL_SERVE,
        "no cache miss after warmup": doc["cache"]["misses"] == warm_misses,
        "both replicas dispatched": all(d > 0 for d in doc["pool"]["dispatched"]),
        "tile kernel launched once per tile conv and wave": launches == want_launches > 0,
        "a roofline row per stage": [r["stage"] for r in rows] == labels,
        "no wave lost": TRIP_WAVE_LOSS not in recorder.stats()["trips"],
        "valid Chrome trace": not problems,
    }
    failed = [k for k, ok in checks.items() if not ok]
    print(f"online: checks {'all pass' if not failed else 'FAILED: ' + ', '.join(failed)}")
    if failed:
        raise AssertionError(f"online phase failed: {failed} {problems[:3]}")
    return dict(launches=launches, calib=calib, makespan_s=makespan, hw=hw,
                e2e_p50_s=lat["e2e"]["p50_s"], e2e_p95_s=lat["e2e"]["p95_s"])


# ------------------------------------------------------------ phase 11

ADAPT_SIDE = 64
ADAPT_REQUESTS = 32
# final vs seed plan, interleaved CUDA-event medians: the final plan may
# read this much slower and still count as no slower.  The phase prints
# the seed against a second compile of the seed in the same turns, the
# reading of this noise (PERF.md cites it beside the limit).
ADAPT_SLACK = 1.10
ADAPT_PAIRS = 25


def interleaved_ms(fns, x, pairs: int = ADAPT_PAIRS) -> list:
    """Median CUDA-event ms of each of `fns` on `x`, called in turns whose
    order alternates (a b, b a, ...), after warm-up."""
    for f in fns:
        for _ in range(3):
            f(x)
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for i in range(pairs):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fns[j](x)
            t1.record()
            t1.synchronize()
            times[j].append(t0.elapsed_time(t1))
    return [statistics.median(t) for t in times]


def _plan_text(plan) -> str:
    groups = ", ".join(f"{list(g.layers)} tile_rows {g.tile_rows}" for g in plan.groups)
    return f"algos {list(plan.algos())}, groups [{groups}]"


def phase_adapt(hw, smi: str) -> dict:
    """`benchmarks/check_divergence.py`'s scenario on the card (see the
    module docstring, phase 11).  Every number printed is one run's."""
    from repro_torch.configs.convnets import fft_fewchannel
    from repro_torch.convserve import (
        AdaptConfig, AdaptController, Engine, init_weights, run_direct,
    )
    from repro_torch.convserve.check.ir import verify_program
    from repro_torch.convserve.runtime import ReplicaPool, RuntimeConfig, ServeRuntime, SimClock
    from repro_torch.core import pipeline
    from repro_torch.kernels.fused_tile import kernel as tile_kernel

    side = ADAPT_SIDE
    spec = fft_fewchannel(4)
    ws = init_weights(spec, seed=0)
    engine = Engine(hw=hw, device=DEV)
    pool = ReplicaPool.build(engine, spec, ws, n=1, workers=0, input_hw=(side, side))
    seed_plan = pool.executors[0].plan
    print(f"adapt: {spec.name!r} on {hw.name} ({smi}); seed plan {_plan_text(seed_plan)}")
    cfg = RuntimeConfig(max_batch=2, buckets=(side,), slo_s=10.0, service_est_s=1e-3)
    rt = ServeRuntime(pool, cfg, clock=SimClock())
    holder = {}
    waves = []  # per wave: what served it, and what the controller did after it

    def before_controller(res):
        ac = holder["ac"]
        waves.append(dict(
            bucket=res.wave.bucket, rids=list(res.outputs), live=pool.executors[0].program,
            cand=ac.candidate[0].program if ac.candidate else None,
            shadows=ac.shadows_run, promotions=ac.promotions))

    def after_controller(res):
        ac = holder["ac"]
        waves[-1].update(shadowed=ac.shadows_run > waves[-1]["shadows"],
                         promoted=ac.promotions > waves[-1]["promotions"],
                         sizes=rt.scheduler.compiled_sizes())

    rt.add_wave_observer(before_controller)
    ac = holder["ac"] = AdaptController(rt, engine, spec, ws, AdaptConfig(
        divergence_ratio=1.25, shadow_fraction=1.0, shadow_min_waves=2,
        promote_margin=0.05, probe_bucket=side, probe_reps=3,
    ))
    rt.add_wave_observer(after_controller)

    ac.measure()
    probed = ac.probe_alternatives()
    reason = ac.check()
    print(f"adapt: probed {probed}; store scale (median measured/predicted) "
          f"{ac.store.ratio_scale():.6g}")
    for row in ac.divergence():
        alt = row["alternative_s"]
        print(f"adapt: stage {row['stage']:14s} measured {row['measured_s'] * 1e3:.6f} ms  "
              f"predicted {row['predicted_s'] * 1e3:.6f} ms  ratio {row['ratio']:.6g}  "
              f"divergence {row['divergence']:.6g}  best alternative "
              f"{'-' if alt is None else f'{alt * 1e3:.6f} ms'}  regret "
              f"{'-' if row['regret'] is None else format(row['regret'], '.6g')}")
    for key, e in sorted(ac.store.to_json().items()):
        print(f"adapt: store {key}: measured {e['measured_s'] * 1e3:.6f} ms, predicted "
              f"{(e['predicted_s'] or 0) * 1e3:.6f} ms, n {e['n']}")
    print(f"adapt: trigger: {reason or 'within threshold'}")
    if ac.candidate_plan is not None:
        print(f"adapt: candidate {_plan_text(ac.candidate_plan)}, shadow mode {ac.verifier.mode}")

    rng = np.random.default_rng(0)
    imgs = {i: (rng.standard_normal((side, side, 4)) * 0.1).astype(np.float32)
            for i in range(ADAPT_REQUESTS)}
    scan_before = pipeline.SCAN_CALLS
    tile_kernel.LAUNCHES = 0  # main path: count only the served run
    for i in range(ADAPT_REQUESTS):
        if rt.submit(imgs[i], rid=i) is not None:
            raise AssertionError(f"adapt: request {i} rejected")
        rt.poll()
    rt.drain()
    torch.cuda.synchronize()
    launches = tile_kernel.LAUNCHES
    snap = rt.stats()
    final = rt.pool.executors[0]
    stats = ac.stats()
    shadow = stats["shadow"]
    print(f"adapt: shadow {shadow}")
    for a in ac.audit:
        detail = {k: v for k, v in a.items() if k not in ("t", "event", "reason")}
        print(f"adapt: audit t={a['t']:.6f} {a['event']}: {a['reason']} {detail or ''}")
    print(f"adapt: replans {ac.replans_triggered}, shadows {ac.shadows_run}, promotions "
          f"{ac.promotions}, rollbacks {ac.rollbacks}; counters "
          f"{ {k: v for k, v in snap['counters'].items() if k.startswith('adapt.')} }")
    print(f"adapt: final plan {_plan_text(final.plan)}")

    per_wave = {}

    def tile(program, bucket):
        key = (id(program), bucket)
        if key not in per_wave:
            per_wave[key] = tile_launches_per_wave(spec, program, bucket)
        return per_wave[key]

    want = 0
    for w in waves:
        want += tile(w["live"], w["bucket"])
        if w["shadowed"]:
            want += tile(w["cand"], w["bucket"])
        if w["promoted"]:  # hot_swap warmed the candidate at every compiled shape
            want += sum(tile(w["cand"], b) * len(sizes) for b, sizes in w["sizes"].items())
    print(f"adapt: {len(waves)} waves ({sum(w['shadowed'] for w in waves)} shadowed); "
          f"tile-kernel launches {launches}, expected {want}")

    # each request against direct, grouped by the program that served it
    served_by = {rid: w["live"] for w in waves for rid in w["rids"]}
    seed_program, final_program = waves[0]["live"], final.program
    by_plan = {}  # "seed" / "final" / "between" -> [requests, max rel err]
    for i, im in imgs.items():
        y = rt.results.get(i)
        ref = run_direct(spec, ws, torch.from_numpy(im)[None].to(DEV))[0]
        if y is None or tuple(y.shape) != spec.out_shape(side, side, 4) or not np.isfinite(y).all():
            raise AssertionError(f"adapt rid {i}: bad or missing output")
        prog = served_by.get(i)
        label = ("seed" if prog is seed_program else
                 "final" if prog is final_program else "between")
        row = by_plan.setdefault(label, [0, 0.0])
        row[0] += 1
        row[1] = max(row[1], rel_err(torch.from_numpy(y).to(DEV), ref))
    for label, (n, err) in by_plan.items():
        print(f"adapt: {n} requests served by the {label} plan: max rel err vs direct "
              f"(cuDNN, TF32 off) {err:.3e} (tol {REL_TOL_SERVE:g})")

    seed_net = engine.compile(spec, ws, plan=seed_plan, fuse=None)
    seed_again = engine.compile(spec, ws, plan=seed_plan, fuse=None)
    x = torch.from_numpy(np.stack([imgs[0], imgs[1]])).to(DEV)
    t_final, t_seed, t_seed_again = interleaved_ms([final, seed_net, seed_again], x)
    promoted = final.plan != seed_plan
    print(f"adapt: timing pair (batch 2, {side}x{side}, median of {ADAPT_PAIRS} interleaved "
          f"CUDA-event calls): final {t_final:.6f} ms ({'promoted' if promoted else 'seed kept'}), "
          f"seed {t_seed:.6f} ms, ratio {t_final / t_seed:.6f} (slack {ADAPT_SLACK:g}); "
          f"seed compiled twice in the same turns: {t_seed_again:.6f} ms, ratio "
          f"{t_seed_again / t_seed:.6f}")
    seed_report = verify_program(spec, seed_plan, hw=hw)
    final_report = verify_program(spec, final.plan, hw=hw)
    print(f"adapt: verify seed {seed_report.format()}; final {final_report.format()}")
    checks = {
        "every request answered": len(rt.results) == ADAPT_REQUESTS and not rt.errors,
        "every request mapped to the wave that served it": (
            sum(n for n, _ in by_plan.values()) == ADAPT_REQUESTS
            and set(served_by) == set(imgs)),
        "seed plan's requests within tolerance of direct": (
            "seed" in by_plan and by_plan["seed"][1] < REL_TOL_SERVE),
        "other plans' requests within tolerance of direct": all(
            err < REL_TOL_SERVE for label, (_, err) in by_plan.items() if label != "seed"),
        "no shadow wave in client e2e": snap["latency"]["e2e"]["count"] == ADAPT_REQUESTS,
        "final plan no slower than seed": t_final <= t_seed * ADAPT_SLACK,
        "tile launches equal the derived count": launches == want > 0,
        "no f32 path reached scan_tile_conv": pipeline.SCAN_CALLS == scan_before == 0,
        "seed and final plans verify clean": seed_report.ok and final_report.ok,
    }
    failed = [k for k, ok in checks.items() if not ok]
    print(f"adapt: checks {'all pass' if not failed else 'FAILED: ' + ', '.join(failed)}")
    if failed:
        raise AssertionError(f"adapt phase failed: {failed}")
    return dict(launches=launches, promoted=promoted, final_algos=list(final.plan.algos()),
                t_final_ms=t_final, t_seed_ms=t_seed, t_seed_again_ms=t_seed_again,
                trigger=reason)


# ------------------------------------------------------------ phase 12

FLEET_SIDE = 64
FLEET_SEED = 11  # fleet_bench's default --seed
FLEET_DAY_S = 60.0  # the --smoke day
FLEET_REQUESTS = 6000  # the --smoke day's base trace
FLEET_SERVICE = dict(base_s=0.004, per_image_s=0.002)  # simulated service model
FLEET_SCALEOUT = 480  # requests per fleet size, --smoke
REL_TOL_SHARD = 1e-5  # sharded wave vs the unsharded wave of one plan


class ImageBank:
    """`benchmarks/fleet_bench.py`'s bounded pool of seeded images,
    cycled by rid (a day of traffic holds a few hundred images)."""

    def __init__(self, trace, c: int, *, seed: int, slots: int = 256):
        sizes = sorted({(a.h, a.w) for a in trace})
        rng = np.random.default_rng(seed)
        per = max(1, slots // max(1, len(sizes)))
        self._pool = {
            hw: [(rng.standard_normal((hw[0], hw[1], c)) * 0.1).astype(np.float32)
                 for _ in range(per)]
            for hw in sizes
        }

    def get(self, arrival) -> np.ndarray:
        bucket = self._pool[(arrival.h, arrival.w)]
        return bucket[arrival.rid % len(bucket)]


class DirectCheck:
    """Holds every served request against `run_direct` (cuDNN, TF32 off)
    from a wave observer: the direct output of each distinct input image
    is computed once and kept; a wave's outputs are compared on the host
    as the wave lands (the day drops results as it goes)."""

    def __init__(self, spec, ws):
        from repro_torch.convserve import run_direct

        self._direct = lambda im: run_direct(
            spec, ws, torch.from_numpy(im)[None].to(DEV))[0].cpu().numpy()
        self._memo = {}  # id(image) -> (image, direct output)
        self.spec = spec
        self.checked = 0
        self.worst = 0.0
        self.bad = []  # rids with a missing, misshapen or non-finite output

    def watch(self, rt, image_of) -> None:
        """Check every wave `rt` serves; `image_of(rid)` is its input."""
        def observe(res):
            for rid, y in res.outputs.items():
                im = image_of(rid)
                hit = self._memo.get(id(im))
                if hit is None:
                    hit = self._memo[id(im)] = (im, self._direct(im))
                ref = hit[1]
                want = self.spec.out_shape(im.shape[0], im.shape[1], im.shape[2])
                if tuple(y.shape) != want or not np.isfinite(y).all():
                    self.bad.append(rid)
                    continue
                err = float(np.abs(y.astype(np.float64) - ref).max()
                            / (np.abs(ref).max() + 1e-30))
                self.worst = max(self.worst, err)
                self.checked += 1

        rt.add_wave_observer(observe)


def fleet_calls(pool) -> int:
    """Executor calls of every replica the pool ever held (failed, retired
    and grown ones included): waves, shards, warm-ups and probes."""
    return sum(r.executor.net.executor.calls for r in pool.replicas)


def phase_fleet(hw, smi: str) -> dict:
    """The elastic fleet on the card (module docstring, phase 12):
    `benchmarks/fleet_bench.py`'s --smoke scenarios at vgg's full width.
    Latencies, makespans and throughputs are on the SIMULATED clock of
    the fleet's service model, not the card's; the card computes every
    output.  Every number printed is one run's."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights
    from repro_torch.convserve.check.ir import verify_program
    from repro_torch.convserve.fleet import (
        LOSS_REASONS, AutoscalerConfig, ElasticPool, FixedServiceModel, FleetRuntime,
        apply_placement, plan_weight_placement,
    )
    from repro_torch.convserve.obs import Tracer
    from repro_torch.convserve.runtime import (
        REJECT_REASONS, RealClock, RuntimeConfig, SimClock, burst_trace, diurnal_trace,
        make_images, merge_traces, poisson_trace,
    )
    from repro_torch.kernels.fused_tile import kernel as tile_kernel
    from repro_torch.runtime.fault import FaultPlan, ReplicaFault

    t_phase = time.perf_counter()
    side = FLEET_SIDE
    spec = vgg_mixed_channel(3)
    ws = init_weights(spec, seed=0)
    c0 = spec.conv_layers()[0][1].c_in
    service = FixedServiceModel(**FLEET_SERVICE)
    direct = DirectCheck(spec, ws)
    runs = {}  # scenario -> dict(launches=, calls=, want=)
    runtimes = []  # every FleetRuntime of the phase
    per_call = {}

    def build(n, clock, **kw):
        engine = Engine(hw=hw, device=DEV)
        return ElasticPool.build(engine, spec, ws, n=n, clock=clock,
                                 input_hw=(side, side), service_model=service, **kw)

    def account(rt, total):
        c = rt.stats()["counters"]
        served, lost = c.get("images", 0), c.get("lost_images", 0)
        admitted, rejected = c.get("admitted", 0), c.get("rejected", 0)
        return dict(total=total, admitted=admitted, served=served, lost=lost,
                    rejected=rejected, deadline_miss=c.get("deadline_miss", 0),
                    slo_attainment=1.0 - c.get("deadline_miss", 0) / served if served else 0.0)

    def close(name, pool, launches):
        if "n" not in per_call:  # every replica of every pool runs one plan
            per_call["n"] = tile_launches_per_wave(
                spec, pool.replicas[0].executor.program, side)
        calls = fleet_calls(pool)
        runs[name] = dict(launches=launches, calls=calls, want=calls * per_call["n"])

    def replay(rt, trace, image_of):
        t0 = rt.clock.now()
        for a in trace:
            rt.run_until(t0 + a.t)
            rt.submit(image_of(a.rid), rid=a.rid, priority=a.priority,
                      deadline_s=a.deadline_s)
            if len(rt.results) > 4096:
                rt.results.clear()
        rt.drain()
        return rt.clock.now() - t0

    # -- the day: diurnal base + bursts, autoscaling, the fault drill
    day_s, requests = FLEET_DAY_S, FLEET_REQUESTS
    base = diurnal_trace(requests / (day_s * 0.72), requests, seed=FLEET_SEED, depth=0.8,
                         period_s=day_s, sizes=(48, 64), deadline_s=None)
    bursts = burst_trace(max(requests // 10, 40), burst=max(requests // 50, 20),
                         period_s=day_s / 8, seed=FLEET_SEED + 1, sizes=(64,))
    trace = [a for a in merge_traces(base, bursts) if a.t <= day_s * 1.5]
    by_rid = {a.rid: a for a in trace}
    clock = SimClock()
    drill = [ReplicaFault(t=day_s * 0.30, kind="crash", replica=0),
             ReplicaFault(t=day_s * 0.50, kind="cache_corrupt"),
             ReplicaFault(t=day_s * 0.65, kind="slow", replica=1, factor=8.0)]
    tracer = Tracer(clock=clock)  # the pool's lifecycle, fault and probe instants
    tile_kernel.LAUNCHES = 0  # main path: the day, warm-ups and probes included
    t_wall = time.perf_counter()
    pool = build(2, clock, fault_plan=FaultPlan(drill, clock=clock),
                 startup_s=day_s / 100, probe_interval_s=day_s / 20, max_replicas=6,
                 tracer=tracer)
    cfg = RuntimeConfig(max_batch=8, buckets=(side,), queue_depth=512, slo_s=0.5,
                        service_est_s=service.base_s + 8 * service.per_image_s)
    auto = AutoscalerConfig(min_replicas=2, max_replicas=6, tick_interval_s=day_s / 200,
                            cooldown_s=day_s / 50, queue_high=6.0, queue_low=0.5,
                            slack_min_s=0.05, admission_queue_per_replica=256.0)
    rt = FleetRuntime(pool, cfg, clock=clock, autoscaler=auto)
    runtimes.append(rt)
    rt.warmup()
    bank = ImageBank(trace, c0, seed=1)
    direct.watch(rt, lambda rid: bank.get(by_rid[rid]))
    plan = pool.executors[0].plan
    report = verify_program(spec, plan, hw=hw)
    placement = plan_weight_placement(pool.executors[0])
    placed = apply_placement(pool.executors[0].net, None, placement)
    print(f"fleet: {spec.name!r} on {hw.name} ({smi}); plan {list(plan.algos())}, groups "
          f"{[tuple(g.layers) for g in plan.groups]}; verify {report.format()}")
    print("fleet: weight placement (plan_weight_placement, threshold 1 MiB; one card: "
          f"apply_placement {placed}):")
    algo_of = {p.layer: p.algo for p in plan.layers}
    for layer, d in sorted(placement.items()):
        print(f"  layer {layer:2d} {algo_of[layer]:14s} {d['bytes']:10d} B  "
              f"{d['placement']:9s}  {d['why']}")
    makespan = replay(rt, trace, lambda rid: bank.get(by_rid[rid]))
    # the day's trace ends before the drill's last fault: run the fleet on,
    # idle, through it and the probe that sees it
    t_end = max(f.t for f in drill) + day_s / 20
    rt.run_until(t_end)
    wall = time.perf_counter() - t_wall
    launches = tile_kernel.LAUNCHES
    doc = rt.stats()
    acct = account(rt, len(trace))
    p, a_st = doc["pool"], doc["autoscaler"]
    instants = [e for e in tracer.events() if not hasattr(e, "sid")]
    quarantines = [(round(e.t, 6), e.args.get("replica"), e.args.get("why"))
                   for e in instants if e.name == "fleet.quarantine"]
    repairs = [(round(e.t, 6), e.args.get("probed"))
               for e in instants if e.name == "fleet.cache_repair"]
    corrupt_t = drill[1].t
    close("day", pool, launches)
    print(f"fleet: day (simulated {day_s:g} s, {len(trace)} requests, seed {FLEET_SEED}): "
          f"{wall:.2f} s of wall time; simulated makespan {makespan:.6f} s, run on to "
          f"{t_end:g} s for the drill")
    print(f"fleet: accounting {acct}; lost by reason {doc['losses']['by_reason']}; rejected "
          f"by reason { {k: v for k, v in doc['counters'].items() if k.startswith('rejected.')} }")
    print(f"fleet: pool failures {p['failures']}, retries {p['retries']}, orphaned "
          f"{p['orphaned']}, quarantines {p['quarantines']} (by why "
          f"{ {w: sum(q[2] == w for q in quarantines) for w in {q[2] for q in quarantines}} }: "
          f"{quarantines}), cache repairs {p['cache_repairs']} {repairs}, probe mismatches "
          f"{p['probe_mismatches']}, grown {p['grown']}, retired {p['retired']}; states "
          f"{p['states']}; faults fired {p['faults']['fired']}")
    print(f"fleet: autoscaler ticks {a_st['ticks']}, ups {a_st['scale_ups']}, downs "
          f"{a_st['scale_downs']}, replacements {a_st['replacements']}")
    for ev in a_st["events"]:
        print(f"fleet: autoscaler t={ev['t']:.6f} {ev['action']} n={ev['n']} "
              f"({ev['why']}; queue ewma {ev['queue_ewma']}, slack ewma {ev['slack_ewma']})")
    lat = doc["latency"]
    print("fleet: SIMULATED e2e " + "  ".join(
        f"{q} {lat['e2e'][q + '_s'] * 1e3:.6f} ms" for q in ("p50", "p95", "p99"))
        + f"; queue wait p95 {lat['queue_wait']['p95_s'] * 1e3:.6f} ms "
        f"(service model {FLEET_SERVICE}, not the card's time)")

    # -- scale-out: one saturating trace at fleet sizes 1, 2, 4
    curve = {}
    so_trace = poisson_trace(5000.0, FLEET_SCALEOUT, seed=FLEET_SEED, sizes=(side,))
    so_by = {a.rid: a for a in so_trace}
    so_bank = ImageBank(so_trace, c0, seed=1)
    for n in (1, 2, 4):
        clock = SimClock()
        tile_kernel.LAUNCHES = 0
        so_pool = build(n, clock, startup_s=1.0, max_replicas=n)
        so_rt = FleetRuntime(so_pool, RuntimeConfig(
            max_batch=8, buckets=(side,), queue_depth=FLEET_SCALEOUT, slo_s=None,
            service_est_s=0.02), clock=clock)
        runtimes.append(so_rt)
        so_rt.warmup()
        direct.watch(so_rt, lambda rid: so_bank.get(so_by[rid]))
        span = replay(so_rt, so_trace, lambda rid: so_bank.get(so_by[rid]))
        so_acct = account(so_rt, len(so_trace))
        close(f"scale-out N={n}", so_pool, tile_kernel.LAUNCHES)
        curve[n] = dict(served=so_acct["served"], makespan=span,
                        rps=so_acct["served"] / span,
                        p95=so_rt.stats()["latency"]["e2e"]["p95_s"])
    print("fleet: SIMULATED scale-out (poisson 5000 Hz, 480 requests): " + "; ".join(
        f"N={n} makespan {c['makespan']:.6f} s, {c['rps']:.3f} requests/s, e2e p95 "
        f"{c['p95'] * 1e3:.6f} ms" for n, c in curve.items())
        + f"; T(4)/T(1) {curve[4]['rps'] / curve[1]['rps']:.6f}")

    # -- exactness: 3 replicas x 4 shards against 1 replica x 1 shard
    ex_trace = poisson_trace(45.0, 60, seed=FLEET_SEED, sizes=(32, 48, 64), deadline_s=0.08)
    ex_images = make_images(ex_trace, c0, seed=1)
    ex_cfg = dict(max_batch=4, buckets=(side,), queue_depth=128, slo_s=0.1,
                  service_est_s=0.01)

    def serve(n, shards, clock):
        tile_kernel.LAUNCHES = 0
        pool_ = build(n, clock, startup_s=1.0, shards=shards, max_replicas=n)
        rt_ = FleetRuntime(pool_, RuntimeConfig(**ex_cfg), clock=clock)
        runtimes.append(rt_)
        rt_.warmup([2, 4])
        direct.watch(rt_, ex_images.__getitem__)
        out = rt_.play(ex_trace, ex_images)
        return out, rt_.stats(), pool_, tile_kernel.LAUNCHES

    fleet_out, fleet_doc, fleet_pool, fleet_launches = serve(3, 4, SimClock())
    close("exactness 3x4 shards", fleet_pool, fleet_launches)
    oracle_out, _, oracle_pool, oracle_launches = serve(1, 1, SimClock())
    close("exactness oracle 1x1", oracle_pool, oracle_launches)
    worst_shard, bitwise = 0.0, 0
    for rid, ref in oracle_out.items():
        y = fleet_out.get(rid)
        if y is None:
            worst_shard = float("inf")
            continue
        bitwise += bool(np.array_equal(y, ref))
        worst_shard = max(worst_shard, float(
            np.abs(y.astype(np.float64) - ref).max() / (np.abs(ref).max() + 1e-30)))
    partial = fleet_doc["scheduler"]["partial_waves"]
    print(f"fleet: exactness ({len(ex_trace)} requests, poisson 45 Hz, sizes 32/48/64, "
          f"bucket {side}): 3 replicas x 4 shards vs 1 replica x 1 shard: worst rel "
          f"{worst_shard:.3e} (tol {REL_TOL_SHARD:g}), bitwise {bitwise} of {len(oracle_out)}, "
          f"partial waves {partial}")

    # -- one RealClock run of the exactness trace on two replicas
    real_out, real_doc, real_pool, real_launches = serve(2, 1, RealClock())
    close("exactness RealClock 2x1", real_pool, real_launches)
    comp = real_doc["latency"].get("compute", {})
    print(f"fleet: RealClock, 2 inline replicas on {smi}: compute (host clock after the "
          f"output reached the host) p50 {comp.get('p50_s', 0) * 1e3:.3f} ms, p95 "
          f"{comp.get('p95_s', 0) * 1e3:.3f} ms over {comp.get('count', 0)} warm waves; "
          f"{len(real_out)} of {len(ex_trace)} served")

    launches = sum(r["launches"] for r in runs.values())
    want = sum(r["want"] for r in runs.values())
    print(f"fleet: tile-kernel launches {launches}, derived {want} ({per_call['n']} per "
          f"executor call at bucket {side} x " + ", ".join(
              f"{k} {r['calls']}" for k, r in runs.items()) + " calls)")
    print(f"fleet: {direct.checked} served outputs within rel {direct.worst:.3e} of direct "
          f"(cuDNN, TF32 off; tol {REL_TOL_SERVE:g})")
    loss_reasons = set(rt.losses.values()) | set(p["losses"])
    rej_reasons = {k.split(".", 1)[1] for k in doc["counters"] if k.startswith("rejected.")}
    replica1_slow = any(q[1] == 1 and q[2] == "slow" for q in quarantines)
    checks = {
        "admitted == served + lost": acct["admitted"] == acct["served"] + acct["lost"],
        "total == admitted + rejected": acct["total"] == acct["admitted"] + acct["rejected"],
        "losses and rejections reason-coded": (loss_reasons <= set(LOSS_REASONS)
                                               and rej_reasons <= set(REJECT_REASONS)),
        "the crash fired": p["failures"] >= 1,
        "corruption repaired once, at the first probe after it": (
            p["cache_repairs"] == 1 and len(repairs) == 1 and repairs[0][0] == corrupt_t
            and p["probe_mismatches"] == repairs[0][1]),
        "slowed replica quarantined as slow": replica1_slow,
        "a scale-up or replacement": a_st["scale_ups"] + a_st["replacements"] >= 1,
        "SLO attainment >= 0.95": acct["slo_attainment"] >= 0.95,
        "T(4) >= 2.5 T(1)": curve[4]["rps"] >= 2.5 * curve[1]["rps"],
        "every scale-out request served": all(c["served"] == FLEET_SCALEOUT
                                              for c in curve.values()),
        "exactness within 1e-5 of the oracle": (
            fleet_out.keys() == oracle_out.keys() == {a.rid for a in ex_trace}
            and worst_shard <= REL_TOL_SHARD),
        "exactness with partial waves": partial >= 1,
        "RealClock run served every request": len(real_out) == len(ex_trace),
        "every served request within 1e-3 of direct": (
            not direct.bad and direct.checked > 0 and direct.worst < REL_TOL_SERVE),
        "no wave or observer error": not any(
            r_.errors or r_.telemetry.counter("wave_observer_errors") for r_ in runtimes),
        "tile launches equal the derived count": launches == want > 0,
        "the plan verifies clean": report.ok,
    }
    failed = [k for k, ok in checks.items() if not ok]
    print(f"fleet: phase wall time {time.perf_counter() - t_phase:.2f} s; checks "
          f"{'all pass' if not failed else 'FAILED: ' + ', '.join(failed)}")
    if failed:
        raise AssertionError(f"fleet phase failed: {failed}")
    return dict(launches=launches)


# ------------------------------------------------------------ phase 13

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 1024
TRAIN_ARGS = ["--arch", "gemma3-1b", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ)]
TRAIN_CUT = 6  # layers of gemma3-1b (one period) in the card-vs-CPU part
TRAIN_CUT_S = 576  # above the 512 window: the local band skip shows
REL_TOL_BWD = 5e-5  # the reference's gradient tolerance (tests/test_flash_attention.py)
REL_TOL_LSE = 1e-5
REL_TOL_TRAIN_LOSS = 1e-4  # card vs CPU loss
REL_TOL_TRAIN_GRAD = 1e-3  # card vs CPU gradient leaves, the reference's net tolerance
FLASH_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
FLASH_BWD_BF16_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_bf16.cu"
FLASH_BWD_REPLACES = "src/repro/models/flash_attention.py:142"
DRILL_FAULTS = (12, 21)
MOON_TRAIN_ATTN = "moonshot train B4 H16 S1024 hd128 causal"
MLA_TRAIN_ATTN = "deepseek MLA train B4 H128 S1024 hd192/128 causal"
MTP_TRAIN_ATTN = "deepseek MTP train B4 H128 S1023 hd56 causal"
# seamless-m4t-medium's training attention (B 4, 1024 frames, 512 target
# tokens), MHA hd 64: the cross attention (non-causal, Sq 512 != Sk 1024),
# the encoder's bidirectional and the decoder's causal self-attention;
# held at rel 1e-5
SEAMLESS_CROSS_TRAIN_ATTN = "seamless cross train B4 H16 Sq512 Sk1024 hd64"
SEAMLESS_ENC_TRAIN_ATTN = "seamless encoder train B4 H16 S1024 hd64 non-causal"
SEAMLESS_DEC_TRAIN_ATTN = "seamless decoder self train B4 H16 S512 hd64 causal"
REL_TOL_BWD_NEW = {SEAMLESS_CROSS_TRAIN_ATTN: 1e-5, SEAMLESS_ENC_TRAIN_ATTN: 1e-5,
                   SEAMLESS_DEC_TRAIN_ATTN: 1e-5}
# the six losses of the same run over the first backward kernel (FMA units,
# commit 0c64a3e), printed beside this run's: the forward is unchanged, so
# step 0 matches; later steps carry the backward's other sum order
RECORDED_TRAIN_LOSSES = (12.893015, 12.801218, 12.848528, 12.843199, 12.788089, 12.800722)
TRAIN_CKPT = os.path.join(ROOT, "build", "chip_smoke_ckpt")


def flash_bwd_cases(gen):
    """(label, B, Hq, Hkv, S_q, S_k, hd, vd, causal, window, model layout):
    gemma3-1b's two training layers, moonshot's and deepseek-v3's (MLA at
    q/k hd 192 and v hd 128, the MTP block at hd 56), every instantiated
    (hd, vd) at g 1 and g 4 on a ragged S, non-causal, and rows that see
    no key (at the new shapes too)."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    cases = [
        ("gemma3 train global B4 S1024 hd256 g4", 4, 4, 1, 1024, 1024, 256, 256, True, 0, True),
        ("gemma3 train local w512 B4 S1024 hd256 g4", 4, 4, 1, 1024, 1024, 256, 256, True, 512,
         True),
        ("non-causal Sq77 Sk256 hd128 g2", 1, 2, 1, 77, 256, 128, 128, False, 0, False),
        ("rows that see no key Sq200 Sk50 w40 hd64 g2", 1, 2, 1, 200, 50, 64, 64, True, 40,
         False),
        (MOON_TRAIN_ATTN, 4, 16, 16, 1024, 1024, 128, 128, True, 0, True),
        (MLA_TRAIN_ATTN, 4, 128, 128, 1024, 1024, 192, 128, True, 0, True),
        (MTP_TRAIN_ATTN, 4, 128, 128, 1023, 1023, 56, 56, True, 0, True),
        ("MLA rows that see no key Sq200 Sk50 w40 hd192/128 g1", 1, 4, 4, 200, 50, 192, 128,
         True, 40, True),
        ("MTP rows that see no key Sq200 Sk50 w40 hd56 g1", 1, 4, 4, 200, 50, 56, 56, True, 40,
         True),
        (SEAMLESS_CROSS_TRAIN_ATTN, 4, 16, 16, 512, 1024, 64, 64, False, 0, True),
        (SEAMLESS_ENC_TRAIN_ATTN, 4, 16, 16, 1024, 1024, 64, 64, False, 0, True),
        (SEAMLESS_DEC_TRAIN_ATTN, 4, 16, 16, 512, 512, 64, 64, True, 0, True),
    ]
    for hd, vd in HEAD_DIMS:
        for hkv in (4, 1):
            cases.append((f"hd{hd}/{vd} g{4 // hkv} B2 S700 causal w300", 2, 4, hkv, 700, 700,
                          hd, vd, True, 300, False))
    out = []
    for label, b, hq, hkv, sq, sk, hd, vd, causal, window, model_layout in cases:
        def mk(bb, h, s, d):
            if model_layout:
                return _cuda(gen, (bb, s, h, d)).transpose(1, 2)
            return _cuda(gen, (bb, h, s, d))
        q, k, v, do = mk(b, hq, sq, hd), mk(b, hkv, sk, hd), mk(b, hkv, sk, vd), mk(b, hq, sq, vd)
        out.append(dict(label=label, q=q, k=k, v=v, do=do, causal=causal, window=window))
    return out


def _f64_backward(c):
    """dq, dk, dv in float64 from float64 forward statistics: the error
    the kernel and the f32 plain backward each carry."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bwd_ref, lse_ref

    q, k, v, do = (c[n].double() for n in ("q", "k", "v", "do"))
    kw = dict(causal=c["causal"], window=c["window"])
    return flash_attention_bwd_ref(q, k, v, attention_ref(q, k, v, **kw), lse_ref(q, k, **kw),
                                   do, **kw)


def train_kernels_vs_plain():
    """Part 1: the forward with lse and the backward kernel against their
    plain versions on the same card tensors; o bitwise without and with
    lse, and against the recorded outputs of the earlier source."""
    from repro_torch.kernels import bitwise_check
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref, lse_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    gen = np.random.default_rng(13)
    cases = flash_bwd_cases(gen)
    worst = dict(abs=0.0, rel=0.0, lse=0.0, f64_kernel=0.0, f64_plain=0.0)
    for c in cases:
        q, k, v, do, kw = c["q"], c["k"], c["v"], c["do"], dict(causal=c["causal"],
                                                                 window=c["window"])
        o0 = flash_kernel.flash_attention_call(q, k, v, **kw)
        o, lse = flash_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
        grads = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, **kw)
        again = bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        plain = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        lse_want = lse_ref(q, k, **kw)
        f64 = _f64_backward(c)
        if not all(torch.isfinite(g).all() and g.shape == p.shape for g, p in zip(grads, plain)):
            raise AssertionError(f"{c['label']}: bad backward output")
        rels = [rel_err(g, p) for g, p in zip(grads, plain)]
        abs_err = max(float((g - p).abs().max()) for g, p in zip(grads, plain))
        lse_rel = rel_err(lse, lse_want)
        k64 = max(rel_err(g.double(), r) for g, r in zip(grads, f64))
        p64 = max(rel_err(p.double(), r) for p, r in zip(plain, f64))
        same_o = bool(torch.equal(o0, o))
        same_bwd = all(torch.equal(a, b) for a, b in zip(grads, again))
        worst.update(abs=max(worst["abs"], abs_err), rel=max(worst["rel"], *rels),
                     lse=max(worst["lse"], lse_rel), f64_kernel=max(worst["f64_kernel"], k64),
                     f64_plain=max(worst["f64_plain"], p64))
        tol = REL_TOL_BWD_NEW.get(c["label"], REL_TOL_BWD)
        print(f"train-kernel flash_attention_bwd {c['label']:44s} dq/dk/dv rel "
              f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} (tol {tol:g}) "
              f"lse rel {lse_rel:.3e} (tol {REL_TOL_LSE:g}); vs float64: kernel {k64:.3e}, "
              f"plain {p64:.3e}; o bitwise with lse {same_o}; backward bitwise {same_bwd}")
        if not (max(rels) < tol and lse_rel < REL_TOL_LSE and same_o and same_bwd):
            raise AssertionError(f"{c['label']}: flash training kernels vs plain failed")
    rec = bitwise_check.check_recorded()
    if rec["comparable"]:
        print(f"train-kernel flash o vs the recorded outputs of {rec['source']}: "
              f"{rec['cases'] - len(rec['mismatched'])}/{rec['cases']} cases bitwise equal "
              f"without and with lse ({rec['nvcc']})")
        if rec["mismatched"]:
            raise AssertionError(f"flash o differs from {rec['source']}: {rec['mismatched']}")
    else:
        print(f"train-kernel flash o vs the recorded outputs of {rec['source']}: not "
              f"comparable (recorded with {rec['recorded_nvcc']}, this run has {rec['nvcc']}; "
              "or the case list changed)")
    return worst


def train_fp32(name: str, n_layers: int = 0):
    """fp32 training of a registered config (cut to `n_layers` when given)
    at full width: `launch.train.main`'s run on a float32 config
    (`_train_cut`), as the launcher trained before it trained each
    config's own dtype; returns the state and the per-step history."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(name), dtype="float32")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return _train_cut(cfg, TRAIN_STEPS)


def train_full_width(smi: str):
    """Part 2: gemma3-1b at full width and depth in fp32 (`train_fp32`);
    per-step loss, grad norm, time and tokens/s; the flash forward and
    backward launch counts of the run."""
    mods = kernel_libraries()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.LAUNCHES = 0  # main path: count only the training run
    t0 = time.perf_counter()
    state, history = train_fp32("gemma3-1b")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    model = state["params"]
    steps, batch, seq = len(history), TRAIN_BATCH, TRAIN_SEQ
    for h, rec in zip(history, RECORDED_TRAIN_LOSSES):
        print(f"  train step {h['step']}: loss {h['loss']:.6f} (commit 0c64a3e's backward: "
              f"{rec:.6f}) grad_norm {h['grad_norm']:.6f} {h['seconds'] * 1e3:.2f} ms "
              f"{batch * seq / h['seconds']:.1f} tokens/s")
    attn = sum(s.mixer == "attn" for s in model.specs)
    want = {"flash_attention": attn * 2 * steps, "flash_attention_bwd": attn * steps,
            "fused_tile": 0, "conv1d_fused": 0, "decode_mlp": 0, "conv1d_fused_bwd": 0}
    print(f"train {model.cfg.name}: {len(model.specs)} layers, d_model {model.cfg.d_model}, "
          f"vocab {model.cfg.vocab_size}, {sum(p.numel() for p in model.parameters()) / 1e9:.4f} "
          f"B params fp32, {steps} steps of {batch}x{seq} in {wall:.2f} s (with init); peak "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches} (want {want}); "
          f"card {smi}")
    if steps != TRAIN_STEPS:
        raise AssertionError(f"train: {steps} steps recorded")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError("train: a loss or grad norm is not finite")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"train: {k} launched {launches[k]} times, expected {n}")
    return dict(state=state, history=history, launches=launches, peak_bytes=peak,
                tokens=batch * seq)


def train_card_vs_cpu(label: str, cfg, b: int, s: int, *, lora_std: float = 0.0,
                      src_frames: int = 0, loss_tol: float = REL_TOL_TRAIN_LOSS):
    """Part 3: `cfg` (a depth cut at full width), seed 0, B `b`, S `s`:
    `lm_loss` and every gradient on the card and on the CPU (and, with
    experts, the summed aux losses, and with an MTP head its `mtp_nll`, at
    the loss's tolerance).  With
    `lora_std`, every `lora_*_b` (zeros at init, so the LoRA would add
    nothing and its `lora_*_a` get no gradient) is drawn from N(0,
    lora_std^2) first (seed 3), the same on both.  With `src_frames`, an
    encoder-decoder's batch carries that many source frames (N(0, 1),
    seed 2).  The loss is held to `loss_tol`."""
    import copy

    from repro_torch.models import init_lm, lm_loss

    card = init_lm(cfg, seed=0, device=DEV)
    if lora_std:
        gen = torch.Generator(device=DEV).manual_seed(3)
        with torch.no_grad():
            for n, p in card.named_parameters():
                if n.rsplit(".", 1)[-1].startswith("lora_") and n.endswith("_b"):
                    p.normal_(0.0, lora_std, generator=gen)
    cpu = copy.deepcopy(card).to("cpu")
    card.requires_grad_(True)
    cpu.requires_grad_(True)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if src_frames:
        batch["src_embeds"] = torch.from_numpy(
            rng.standard_normal((b, src_frames, cfg.d_model)).astype(np.float32))
    out, aux = {}, {}
    for name, model in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        dev = model.device
        loss, metrics = lm_loss(model, {k: t.to(dev) for k, t in batch.items()})
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        aux[name] = {k: float(metrics[k].detach()) for k in ("moe_aux", "moe_z", "mtp_nll")
                     if k in metrics}
        out[name] = (float(loss.detach()), [g.cpu() for g in grads], time.perf_counter() - t0)
    names = [n for n, _ in card.named_parameters()]
    (l_card, g_card, t_card), (l_cpu, g_cpu, t_cpu) = out["card"], out["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    if cfg.moe or cfg.mtp:
        aux_rel = {k: abs(aux["card"][k] - v) / abs(v) for k, v in aux["cpu"].items()}
        print(f"train card-vs-cpu {label}: loss terms card {aux['card']} cpu {aux['cpu']}, "
              f"rel {aux_rel} (tol {loss_tol:g})")
        if not (all(aux["cpu"].values()) and max(aux_rel.values()) < loss_tol):
            raise AssertionError(f"train: {label} aux losses zero or out of tolerance")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, g_card, g_cpu)}
    zero = [n for n, g in zip(names, g_cpu) if not g.any()]
    worst = max(errs, key=errs.get)
    print(f"train card-vs-cpu {label}, B{b} S{s}: loss {l_card:.6f} vs {l_cpu:.6f} rel "
          f"{loss_rel:.3e} (tol {loss_tol:g}); {len(errs)} gradient leaves, worst "
          f"rel {errs[worst]:.3e} at {worst} (tol {REL_TOL_TRAIN_GRAD:g}); leaves with an "
          f"all-zero gradient: {zero or 'none'}; card {t_card:.2f} s, cpu {t_cpu:.2f} s")
    if not loss_rel < loss_tol or not errs[worst] < REL_TOL_TRAIN_GRAD:
        raise AssertionError(f"train: {label} card vs cpu loss or gradients out of tolerance")
    return names


def train_loop_drill():
    """Part 4: the loop on `cfg.reduced()` on the card: 30 steps,
    checkpoints every 5, injected failures at steps 12 and 21 restored
    from disk, then a resume from disk to step 34; then a fresh run that
    a SIGTERM at step 3 stops after saving that step."""
    import dataclasses
    import shutil
    import signal

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    cfg = dataclasses.replace(get_arch("gemma3-1b").reduced(), dtype="float32")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3), warmup_steps=5, total_steps=30)
    stream = TokenStream(DataConfig(cfg.vocab_size, 64, 8, seed=0))
    logs, loss_at = [], {}

    def run(total):
        state = init_train_state(cfg, tcfg, seed=0, device=DEV)
        return train_loop(
            state=state, train_step=make_train_step(cfg, tcfg), next_batch=stream.batch_at,
            cfg=LoopConfig(total_steps=total, ckpt_dir=TRAIN_CKPT, ckpt_every=5,
                           log_every=10),
            injector=injector, log=logs.append,
            on_step=lambda step, m, dt: loss_at.__setitem__(step, float(m["loss"])))

    t0 = time.perf_counter()
    injector = FailureInjector(fail_at_steps=DRILL_FAULTS)
    final = run(30)
    faults = sum(line.startswith("[fault]") for line in logs)
    injector = None
    resumed = run(34)
    resumes = [line for line in logs if line.startswith("[resume]")]
    print(f"train loop drill on {cfg.name} reduced (card): 30 steps, faults at {DRILL_FAULTS}, "
          f"{faults} restored from checkpoints, final step {int(final['step'])}; loss step 0 "
          f"{loss_at[0]:.4f}, step 29 {loss_at[29]:.4f}; resume: {resumes}, final step "
          f"{int(resumed['step'])}; {time.perf_counter() - t0:.2f} s")
    for line in logs:
        if line.startswith(("[fault]", "[resume]")):
            print(f"  {line}")
    ok = (faults == len(DRILL_FAULTS) and int(final["step"]) == 30 and loss_at[29] < loss_at[0]
          and len(resumes) == 1 and "restored step 29" in resumes[0]
          and int(resumed["step"]) == 34)
    if not ok:
        raise AssertionError("train: the loop drill failed")
    # the SIGTERM save: a signal at step 3 of a fresh run ends the loop
    # after that step, with a checkpoint of it
    from repro_torch.checkpoint import io as ckpt_io

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    seen = []

    def on_step(step, m, dt):
        seen.append(step)
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    stopped = train_loop(
        state=init_train_state(cfg, tcfg, seed=0, device=DEV),
        train_step=make_train_step(cfg, tcfg), next_batch=stream.batch_at,
        cfg=LoopConfig(total_steps=30, ckpt_dir=TRAIN_CKPT, ckpt_every=100, log_every=100),
        on_step=on_step, log=logs.append)
    saved = ckpt_io.latest_step(TRAIN_CKPT)
    print(f"train loop SIGTERM at step 3 (card): steps run {seen}, final step "
          f"{int(stopped['step'])}, checkpoint on disk at step {saved}")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    if seen != [0, 1, 2, 3] or int(stopped["step"]) != 4 or saved != 3:
        raise AssertionError("train: the SIGTERM save failed")


def train_profile(state, cfg, keys=(("flash_fwd", ""), ("flash_bwd", "delta")),
                  seq: int = TRAIN_SEQ, src_frames: int = 0) -> dict:
    """One warm full-width step of `state` (after the run's and one more
    untimed) timed on the host, then one under `torch.profiler`: host
    wall time beside device busy time, the idle share and the top
    kernels; for each (key, marker) of `keys`, the device time a step of
    the kernels whose names hold the key, and their calls (launches of
    the one kernel a call whose name holds the marker)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import TrainConfig, make_train_step

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3), warmup_steps=5, total_steps=6)
    step = make_train_step(cfg, tcfg)
    batch = stream_batch(cfg, TRAIN_STEPS, seq, src_frames)
    state, m = step(state, batch)  # the allocator warms again after the parts before
    float(m["loss"])
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        float(m["loss"])
    events = _kernel_events(prof)
    busy = sum(_device_ms(e) for e in events)
    out = dict(wall_ms=wall, busy_ms=busy or None)
    label = f"{cfg.name} ({len(state['params'].specs)} layers) B{TRAIN_BATCH} S{seq}"
    if busy <= 0:
        print(f"profile train step {label}: wall {wall:.3f} ms; device time not measured "
              "(the profiler saw no device events)")
        return out
    out["idle_share"] = max(0.0, 1 - busy / wall)
    print(f"profile train step {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms in "
          f"{sum(e.count for e in events)} device events, idle share {out['idle_share']:.3f}")
    for e in sorted(events, key=_device_ms, reverse=True)[:10]:
        print(f"  {_device_ms(e):9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    for key, marker in keys:
        sel = [e for e in events if key in e.key]
        if sel:
            n = sum(e.count for e in sel if marker in e.key)
            out[key] = sum(_device_ms(e) for e in sel)
            print(f"  {key}: {out[key]:.3f} ms device time in the step "
                  f"({out[key] / max(n, 1):.4f} ms per call over {n} calls)")
    return out


# the training attention layers whose backward is timed: (label, (B, Hq,
# Hkv, Sq, Sk, hd, vd), causal, window); gemma3-1b's two (4 of its 26
# layers are global, 22 local), moonshot-v1-16b-a3b's (MHA, hd 128),
# deepseek-v3-671b's MLA (q/k 192, v 128) and MTP block (hd 56, S 1023),
# and seamless-m4t-medium's cross attention (Sq 512, Sk 1024) and encoder
# (S 1024), both non-causal, and its decoder's causal self-attention (S 512)
TRAIN_ATTN_LAYERS = (
    ("gemma3 train global B4 S1024 hd256 g4", (4, 4, 1, 1024, 1024, 256, 256), True, 0),
    ("gemma3 train local w512 B4 S1024 hd256 g4", (4, 4, 1, 1024, 1024, 256, 256), True, 512),
    (MOON_TRAIN_ATTN, (4, 16, 16, 1024, 1024, 128, 128), True, 0),
    (MLA_TRAIN_ATTN, (4, 128, 128, 1024, 1024, 192, 128), True, 0),
    (MTP_TRAIN_ATTN, (4, 128, 128, 1023, 1023, 56, 56), True, 0),
    (SEAMLESS_CROSS_TRAIN_ATTN, (4, 16, 16, 512, 1024, 64, 64), False, 0),
    (SEAMLESS_ENC_TRAIN_ATTN, (4, 16, 16, 1024, 1024, 64, 64), False, 0),
    (SEAMLESS_DEC_TRAIN_ATTN, (4, 16, 16, 512, 512, 64, 64), True, 0))


def kernel_gap_us(fn, first: str, then: str, reps: int = 5):
    """Median idle time on the card, in µs, between the end of a kernel
    whose name holds `first` and the start of the next one, whose name
    holds `then`, within one call of `fn` (the profiler's device events of
    `reps` calls, synchronised after each); None when never seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):  # a session that records no device event runs again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if ev:
            break
    gaps = [b[0] - a[1] for a, b in zip(ev, ev[1:]) if first in a[2] and then in b[2]]
    return statistics.median(gaps) if gaps else None


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of one call, `perf_counter` around the call with no
    synchronize inside (the card idle before it): the wrapper's own path
    up to its last launch."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def train_times(ptxas: dict) -> dict:
    """The backward kernel at the training attention layers of
    `TRAIN_ATTN_LAYERS` (the model's layout): CUDA
    events, the profiler's device time of each kernel of a call (delta,
    main) with its launches
    a call, the wrapper's host time a call, the card's idle time between
    the delta and the main kernel, beside the plain backward, the
    library's (the backward of `F.scaled_dot_product_attention`, fp32, kv
    heads repeated beforehand, `is_causal` for a causal layer, the band as
    a boolean mask for a windowed one, no mask for a non-causal one, the
    backend torch picked)
    and the bound both ways (`backward.flops`, five products a band pair,
    three at hd and two at vd: three TF32 products per FLOP at the TF32
    peak, and at the fp32 FMA peak; bytes: q, k, v, o, dO, lse read once,
    dq, dk, dv written once).  Where SDPA refuses the shape its time is
    None and the row says why.  Returns gemma3's global layer's row with
    the local one's under "local", moonshot's under "moonshot",
    deepseek's under "mla" and "mtp" and seamless's under
    "seamless_cross", "seamless_encoder" and "seamless_decoder"."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import band_mask

    gen = np.random.default_rng(20)
    print(f"ptxas -v flash_bwd_kernel<float, 256, 256>: {ptxas['registers']} registers, "
          f"{ptxas['stack_frame_bytes']} B stack frame, {ptxas['spill_store_bytes']} B spill "
          f"stores, {ptxas['spill_load_bytes']} B spill loads")
    rows = {}
    for label, (b, hq, hkv, sq, sk, hd, vd), causal, window in TRAIN_ATTN_LAYERS:
        q = _cuda(gen, (b, sq, hq, hd)).transpose(1, 2)
        do = _cuda(gen, (b, sq, hq, vd)).transpose(1, 2)
        k = _cuda(gen, (b, sk, hkv, hd)).transpose(1, 2)
        v = _cuda(gen, (b, sk, hkv, vd)).transpose(1, 2)
        kw = dict(causal=causal, window=window)
        o, lse = flash_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
        # q, k, v, o, dO, lse in; dq, dk, dv out
        bc = bwd_kernel.cost(b, hq, hkv, sq, sk, hd, vd, causal=causal, window=window)
        b_ms, b_by = _bound_of(bc, PEAK_TF32, ops_factor=3)
        fma_ms = _bound_of(bc)[0]
        run = lambda: bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, **kw)
        k_ms = time_ms(run, reps=10)
        kernels = kernel_breakdown(run, "flash_bwd", reps=5)
        d_ms = sum(ms for _, ms, _ in kernels) or None
        h_ms = host_ms(run)
        gap = kernel_gap_us(run, "flash_bwd_delta_kernel", "flash_bwd_kernel")
        p_ms = time_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw), reps=5)
        qc = q.detach().contiguous().requires_grad_(True)
        kr = k.repeat_interleave(hq // hkv, 1).contiguous().requires_grad_(True)
        vr = v.repeat_interleave(hq // hkv, 1).contiguous().requires_grad_(True)
        mask = None if window == 0 else band_mask(sq, sk, device=DEV, **kw)
        l_ms, backend, refused = None, None, []
        for bk in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([bk]):
                    out = F.scaled_dot_product_attention(qc, kr, vr, attn_mask=mask,
                                                         is_causal=causal and mask is None)
                    l_ms = time_ms(lambda: torch.autograd.grad(out, (qc, kr, vr), do,
                                                               retain_graph=True), reps=10)
                backend = bk.name
                break
            except RuntimeError as e:
                refused.append(f"{bk.name}: {str(e).splitlines()[0][:100]}")
                print(f"  SDPA backward with {refused[-1]}")
            finally:
                out = None
                gc_collect()
        print(f"time flash_attention_bwd {label:44s} kernel {k_ms:.4f} ms (profiler device "
              f"time {d_ms if d_ms is None else round(d_ms, 4)} ms, host {h_ms:.4f} ms a call, "
              f"card idle {gap if gap is None else round(gap, 2)} us from delta to main)  "
              f"plain {p_ms:.4f} ms  library (SDPA backward, {backend}"
              f"{', boolean band mask' if mask is not None else ', is_causal' if causal else ''}) "
              f"{l_ms if l_ms is None else round(l_ms, 4)} ms  bound {b_ms:.4f} ms ({b_by}, "
              f"split-TF32 tensor cores), fp32 FMA bound {fma_ms:.4f} ms; device time below "
              f"SDPA's: {d_ms is not None and l_ms is not None and d_ms < l_ms}")
        for name, ms, per_call in kernels:
            print(f"  {ms:9.4f} ms  x{per_call} a call  {name[:90]}")
        rows[label] = dict(
            shape=label, ms=k_ms, device_ms=d_ms, host_ms=h_ms, gap_delta_to_main_us=gap,
            plain_ms=p_ms, library_ms=l_ms,
            library_backend=(f"SDPA backward, {backend}" if backend else
                             "none: SDPA refused the shape (" + "; ".join(refused) + ")"),
            bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fma_ms,
            kernels_per_call={re.search(r"(\w+<[\w, ]+>)", name).group(1): dict(
                device_ms=ms, launches=n) for name, ms, n in kernels})
        del q, k, v, do, o, lse, qc, kr, vr
        gc_collect()
    glob, local, moon, mla, mtp, cross, enc, dec = (layer[0] for layer in TRAIN_ATTN_LAYERS)
    return dict(rows[glob], local=rows[local], moonshot=rows[moon], mla=rows[mla],
                mtp=rows[mtp], seamless_cross=rows[cross], seamless_encoder=rows[enc],
                seamless_decoder=rows[dec], ptxas_hd256=ptxas)


# ---------------------------------------------- phase 13: the SSM stacks

MAMBA_TRAIN_ARGS = ["--arch", "mamba2-1.3b", "--steps", str(TRAIN_STEPS), "--batch",
                    str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
# conv1d launches a mamba layer takes a training step: the forward and its
# recomputation under remat, then one call of the backward kernel
CONV1D_FWD_PER_MAMBA_LAYER_STEP = 2
CONV1D_BWD_PER_MAMBA_LAYER_STEP = 1
MAMBA_TRAIN_CUT = 4  # layers of mamba2-1.3b in its card-vs-CPU part
MAMBA_FP32_LAYERS = 24  # fp32 mamba2 depth (phase 18 trains all 48 in bf16)
ZAMBA_TRAIN_LAYERS = 12  # two super-blocks: the shared block runs twice
# zamba2's card-vs-CPU cut: 4 mamba layers with a shared-attention period
# of 2, so the shared block still runs twice, at full width
ZAMBA_TRAIN_CUT = (4, 2)
TRAIN_CUT_SSM_S = 512  # two 256-step chunks: the carried state shows
REL_TOL_CONV_BWD = 1e-5  # dx, dw, db vs the plain backward, both fp32
# what the conv1d backward replaces: XLA's gradient of this function
CONV1D_BWD_REPLACES = "src/repro/core/conv.py:153"
LORA_B_STD = 0.02


def _conv1d_train_shapes() -> list:
    """(label, B, L, row width, column, D, K) of `conv1d_train_cases`: the
    xBC slice of zxbcdt at mamba2's and zamba2's training shapes, a ragged
    unaligned slice and K 9."""
    from repro_torch.configs import get_arch

    out = []
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        cfg = get_arch(arch)
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        d_xbc = d_inner + 2 * s.n_groups * s.d_state
        width = d_inner + d_xbc + d_inner // s.head_dim
        out.append((f"{arch} train B4 L1024 D{d_xbc} (slice of {width}) K4 silu", 4, 1024,
                    width, d_inner, d_xbc, s.d_conv))
    out.append(("ragged B2 L777 D100 (slice of 300 at column 65) K4 silu", 2, 777, 300, 65,
                100, 4))
    out.append(("K9 B2 L300 D256 silu", 2, 300, 256, 0, 256, 9))
    return out


def conv1d_train_cases(gen):
    """Conv1dFused's forward and backward at the training shapes (the xBC
    column slice of zxbcdt at B 4, L 1024) and at a ragged, unaligned
    slice: (label, wide input, column, D, K, w, b, output gradient)."""
    cases = []
    for label, b, length, row, col, d, k in _conv1d_train_shapes():
        wide = _cuda(gen, (b, length, row)).requires_grad_(True)
        w = _cuda(gen, (k, d), 0.5).requires_grad_(True)
        bias = _cuda(gen, (d,), 0.1).requires_grad_(True)
        cases.append(dict(label=label, wide=wide, col=col, d=d, k=k, w=w, b=bias,
                          g=_cuda(gen, (b, length, d))))
    return cases


def train_conv1d_vs_plain() -> dict:
    """Kernel 2 under autograd (`Conv1dFused`) against `conv1d_ref` and
    `conv1d_bwd_ref` on the same card tensors: y, dx (read where it lands,
    in the slice of the wide gradient), dw, db within REL_TOL_CONV_BWD; one forward launch
    and one backward launch a call; two backward runs bitwise equal.
    Then, at mamba2-1.3b's training shape, the backward kernel's time
    (CUDA events, and the device time of its two kernels), the plain
    backward's, the library's (autograd of grouped `F.conv1d` + bias +
    `F.silu` on the (B, D, L) layout) and the bound (g, x, w, b read
    once, dx, dw, db written once; the operations at the fp32 FMA
    peak)."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv1d_fused import backward as conv_backward
    from repro_torch.kernels.conv1d_fused import conv1d_bwd_ref, conv1d_fused, conv1d_ref
    from repro_torch.kernels.conv1d_fused import kernel as conv_kernel

    gen = np.random.default_rng(21)
    worst = dict(abs=0.0, rel=0.0)
    row = {}
    for c in conv1d_train_cases(gen):
        wide, col, d, w, b, g = c["wide"], c["col"], c["d"], c["w"], c["b"], c["g"]
        f0, b0 = conv_kernel.LAUNCHES, conv_backward.LAUNCHES
        y = conv1d_fused(wide[..., col:col + d], w, b)
        dwide, dw, db = torch.autograd.grad(y, (wide, w, b), g, retain_graph=True)
        again = torch.autograd.grad(y, (wide, w, b), g, retain_graph=True)
        torch.cuda.synchronize()
        fwd, bwd = conv_kernel.LAUNCHES - f0, conv_backward.LAUNCHES - b0
        x = wide.detach()[..., col:col + d]
        got = (y.detach(), dwide[..., col:col + d], dw, db)
        want = (conv1d_ref(x, w.detach(), b.detach()),
                *conv1d_bwd_ref(g, x, w.detach(), b.detach()))
        rels = [rel_err(a, r) for a, r in zip(got, want)]
        # the backward kernel's errors: the gradients only
        abs_err = max(float((a - r).abs().max()) for a, r in zip(got[1:], want[1:]))
        outside = bool(dwide[..., :col].any() or dwide[..., col + d:].any())
        bitwise = all(torch.equal(a, r) for a, r in zip((dwide, dw, db), again))
        worst.update(abs=max(worst["abs"], abs_err), rel=max(worst["rel"], *rels[1:]))
        print(f"train-kernel conv1d_fused_bwd {c['label']:52s} y/dx/dw/db rel "
              f"{'/'.join(f'{r:.3e}' for r in rels)} (tol {REL_TOL_CONV_BWD:g}); launches "
              f"forward {fwd}, backward {bwd / 2:g} a call; gradient outside the slice {outside}; "
              f"backward bitwise {bitwise}")
        if not (max(rels) < REL_TOL_CONV_BWD and fwd == 1 and bwd == 2 and not outside
                and bitwise):
            raise AssertionError(f"{c['label']}: conv1d under autograd vs plain failed")
        if c["label"].startswith("mamba2"):
            w0, b0_, k = w.detach(), b.detach(), c["k"]
            bsz, length = x.shape[0], x.shape[1]
            run = lambda: conv_backward.conv1d_fused_bwd_call(x, w0, b0_, g, activation="silu")
            plain = lambda: conv1d_bwd_ref(g, x, w0, b0_)
            xt = x.transpose(1, 2).contiguous().requires_grad_(True)
            wt = w0.t().contiguous()[:, None, :].requires_grad_(True)
            bt = b0_.clone().requires_grad_(True)
            lib_y = F.silu(F.conv1d(xt, wt, bt, padding=k - 1, groups=d)[..., :length])
            gt = g.transpose(1, 2).contiguous()
            library = lambda: torch.autograd.grad(lib_y, (xt, wt, bt), gt, retain_graph=True)
            k_ms, p_ms, l_ms = time_ms(run), time_ms(plain, reps=10), time_ms(library, reps=10)
            kernels = kernel_breakdown(run, "conv1d_bwd", reps=10)
            d_ms = sum(ms for _, ms, _ in kernels) or None
            b_ms, b_by = _bound_of(conv_backward.cost(bsz, length, d, k))
            row = dict(shape=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                       library_note="autograd of grouped F.conv1d + bias + F.silu, "
                                    "(B, D, L) layout")
            print(f"time conv1d_fused_bwd {c['label']:52s} kernel {k_ms:.4f} ms (profiler "
                  f"device time {d_ms if d_ms is None else round(d_ms, 4)} ms)  plain "
                  f"{p_ms:.4f} ms  library {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
            for name, ms, per_call in kernels:
                print(f"  {ms:9.4f} ms  x{per_call} a call  {name[:90]}")
    return dict(worst=worst, backward=row)


def stream_batch(cfg, step: int, seq: int = TRAIN_SEQ, src_frames: int = 0) -> dict:
    """Batch `step` of the reference's `TokenStream` (seed 0, TRAIN_BATCH
    rows of `seq` tokens); with `src_frames`, an encoder-decoder's source
    frame embeddings beside it, N(0, 1) from seed 1000 + step."""
    from repro_torch.data import DataConfig, TokenStream

    batch = dict(TokenStream(DataConfig(cfg.vocab_size, seq, TRAIN_BATCH, seed=0)).batch_at(step))
    if src_frames:
        batch["src_embeds"] = np.random.default_rng(1000 + step).standard_normal(
            (TRAIN_BATCH, src_frames, cfg.d_model)).astype(np.float32)
    return batch


def _train_cut(cfg, steps: int, seq: int = TRAIN_SEQ, src_frames: int = 0):
    """`launch.train.main`'s run -- its TrainConfig, data, loop and seed --
    on a depth cut, which the launcher's flags (the reference's) cannot
    name, or (with `src_frames`) on an encoder-decoder, whose source
    frames they cannot feed (`stream_batch`)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3), microbatches=1, remat=True,
                       warmup_steps=max(steps // 20, 5), total_steps=steps)
    state = init_train_state(cfg, tcfg, 0, DEV)
    history = []

    def record(step, metrics, dt):
        history.append(dict(step=step, loss=float(metrics["loss"]),
                            grad_norm=float(metrics["grad_norm"]), seconds=dt,
                            **{k: float(metrics[k]) for k in launch_train.RECORDED
                               if k in metrics}))

    state = train_loop(state=state, train_step=make_train_step(cfg, tcfg),
                       next_batch=lambda step: stream_batch(cfg, step, seq, src_frames),
                       cfg=LoopConfig(total_steps=steps, log_every=10), on_step=record)
    return state, history


def train_run(label: str, fn, smi: str, seq: int = TRAIN_SEQ) -> dict:
    """Six full-width steps of 4 x `seq` tokens through `fn` (returns the
    state and the per-step history): losses, grad norms, step ms and
    tokens/s, peak `max_memory_allocated`; every count zeroed before and
    read after, and held exactly to the plan: conv1d = mamba layers x 2
    (remat) x steps and its backward mamba layers x steps, flash forward
    = ((attention invocations -- MLA layers among them -- + cross
    attentions) x 2 (remat) + an MTP head's block and an encoder's
    layers, which run without remat) x steps, backward = (invocations +
    cross attentions + the MTP block + encoder layers) x steps, the rest
    0."""
    mods = kernel_libraries()
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.LAUNCHES = 0  # main path: count only the training run
    t0 = time.perf_counter()
    state, history = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    model = state["params"]
    specs, steps = model.specs, len(history)
    for h in history:
        aux = "".join(f" {k} {h[k]:.6e}" for k in ("nll", "mtp_nll", "moe_aux", "moe_z")
                      if k in h)
        print(f"  train step {h['step']}: loss {h['loss']:.6f} grad_norm {h['grad_norm']:.6f}"
              f"{aux} {h['seconds'] * 1e3:.2f} ms "
              f"{TRAIN_BATCH * seq / h['seconds']:.1f} tokens/s")
    attn = sum(s.mixer in ("attn", "shared_attn", "mla") for s in specs)
    cross = sum(s.cross_attn for s in specs)
    n_mamba = sum(s.mixer == "mamba" for s in specs)
    # without remat: the MTP head's attention block, an encoder's layers
    once = int(bool(model.cfg.mtp)) + len(model.enc_specs)
    want = {"conv1d_fused": n_mamba * CONV1D_FWD_PER_MAMBA_LAYER_STEP * steps,
            "conv1d_fused_bwd": n_mamba * CONV1D_BWD_PER_MAMBA_LAYER_STEP * steps,
            "flash_attention": ((attn + cross) * 2 + once) * steps,
            "flash_attention_bwd": (attn + cross + once) * steps,
            "fused_tile": 0, "decode_mlp": 0}
    n_params = sum(p.numel() for p in model.parameters())
    extra = (", and the MTP head" if model.cfg.mtp else "") + (
        f", {cross} cross attention, and {len(model.enc_specs)} encoder layers"
        if model.enc_specs else "")
    print(f"train {label}: {len(specs)} layers ({sum(s.mixer == 'mamba' for s in specs)} "
          f"mamba, {attn} attention{extra}), d_model "
          f"{model.cfg.d_model}, vocab "
          f"{model.cfg.vocab_size}, {n_params / 1e9:.4f} B params {model.cfg.dtype}, {steps} steps of "
          f"{TRAIN_BATCH}x{seq} in {wall:.2f} s (with init); peak max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; launches {launches} (want {want}); card {smi}")
    if steps != TRAIN_STEPS:
        raise AssertionError(f"train {label}: {steps} steps recorded")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"train {label}: a loss or grad norm is not finite")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"train {label}: {k} launched {launches[k]} times, "
                                 f"expected {n}")
    return dict(state=state, history=history, launches=launches, peak_bytes=peak,
                n_params=n_params)


def gc_collect():
    """Free what the last part dropped, so that a peak reads one part."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_ssm(smi: str, conv_bwd: dict) -> dict:
    """mamba2-1.3b in fp32 at full width on `MAMBA_FP32_LAYERS` layers
    (`train_fp32`), its 4-layer card-vs-CPU cut and a profiled step with
    the conv backward's share of it; zamba2 at full width on 12 layers
    (`_train_cut`), its cut (4 mamba layers, the shared block twice) and
    its peak memory."""
    import dataclasses

    from repro_torch.configs import get_arch

    out = {}
    mamba = train_run(f"mamba2-1.3b ({MAMBA_FP32_LAYERS} layers)",
                      lambda: train_fp32("mamba2-1.3b", MAMBA_FP32_LAYERS), smi)
    cfg = dataclasses.replace(get_arch("mamba2-1.3b"), dtype="float32",
                              n_layers=MAMBA_FP32_LAYERS)
    prof = train_profile(mamba.pop("state"), cfg,
                         keys=(("conv1d_fused_kernel", ""), ("conv1d_bwd", "reduce")))
    n_mamba = cfg.n_layers
    if conv_bwd:
        share = n_mamba * conv_bwd["ms"] / prof["wall_ms"]
        prof["conv1d_backward_ms_a_step"] = n_mamba * conv_bwd["ms"]
        print(f"  conv1d backward a step: {n_mamba} x {conv_bwd['ms']:.4f} ms (CUDA events "
              f"of one call at the training shape) = "
              f"{prof['conv1d_backward_ms_a_step']:.3f} ms, {100 * share:.2f} % of the "
              f"step's wall {prof['wall_ms']:.1f} ms")
    mamba["profile"] = prof
    out["mamba2-1.3b"] = mamba
    gc_collect()
    train_card_vs_cpu(f"mamba2-1.3b cut to {MAMBA_TRAIN_CUT} layers",
                      dataclasses.replace(cfg, n_layers=MAMBA_TRAIN_CUT), 1, TRAIN_CUT_SSM_S)
    gc_collect()
    zcfg = dataclasses.replace(get_arch("zamba2-7b"), dtype="float32",
                               n_layers=ZAMBA_TRAIN_LAYERS)
    published_width(zcfg, (3584, 32, 112, 14336))
    zamba = train_run(f"zamba2-7b ({ZAMBA_TRAIN_LAYERS} layers)",
                      lambda: _train_cut(zcfg, TRAIN_STEPS), smi)
    zamba.pop("state")
    out["zamba2"] = zamba
    gc_collect()
    n, period = ZAMBA_TRAIN_CUT
    names = train_card_vs_cpu(
        f"zamba2-7b cut to {n} mamba layers, shared period {period} (LoRA b drawn, std "
        f"{LORA_B_STD:g})", dataclasses.replace(zcfg, n_layers=n, shared_attn_period=period),
        1, TRAIN_CUT_SSM_S, lora_std=LORA_B_STD)
    if not any(n.startswith("shared.") for n in names):
        raise AssertionError("zamba2 cut: no shared leaf was compared")
    gc_collect()
    return out


# ------------------------------------ phase 13: gemma3's other train paths

MOMENT_LEAVES = {"layers.0.attn.wq": (1152, 1024), "layers.0.mlp.w1": (1152, 6912),
                 "final_norm": (1152,)}  # gemma3-1b's shapes
ADAM_ATOL = 1e-6  # the AdamW tests' tolerance against the reference


def _gemma3_step(tcfg, batch_index: int = 0, steps: int = 1):
    """A fresh gemma3-1b train state at full width (seed 0) taken `steps`
    steps with `tcfg`; returns each step's metrics, the step's ms and the
    state's moments' bytes."""
    import dataclasses

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(get_arch("gemma3-1b"), dtype="float32")
    state = init_train_state(cfg, tcfg, seed=0, device=DEV)
    step = make_train_step(cfg, tcfg)
    stream = TokenStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    out = []
    for t in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, stream.batch_at(batch_index + t))
        m = {k: float(v) for k, v in m.items()}
        out.append((m, (time.perf_counter() - t0) * 1e3))
    moments = sum(t.numel() * t.element_size() for _, t in ckpt_io._leaves(state["opt"]))
    return out, moments


def _adamw_card_vs_cpu(moment_dtype: str) -> dict:
    """AdamW on identical inputs on the card and on the CPU, at gemma3-1b's
    leaf shapes (`MOMENT_LEAVES`), as `tests/test_torch_train.py` holds it
    against the reference: seeded params, gradients of global norm < 1
    (clip exactly 1 on both) and non-zero moments (the same stored bits on
    both) at step count 4, then two updates with fresh gradients.

    After the first update: the params' worst difference (`p1`) and the
    stored moments' (`moments`: absolute for bf16; for int8 |q_card -
    q_cpu| in quantisation steps).  For int8 also the cause of a step
    apart: the f32 moments before storage (recomputed as `adamw_update`
    computes them) differing elements, the blocks whose scale differs, and
    whether every element stored a step apart lies in such a block; and
    how often the card's division by 127.0 differs from the CPU's on the
    same floats.  After the second update: the params' worst difference
    at the elements whose stored m and v the devices wrote alike
    (`p2_alike`) and at the others (`p2_apart`, which a moment one step
    apart moves by up to lr times the update cap), and their counts."""
    from repro_torch.optim import adamw

    cfg = adamw.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    gen = np.random.default_rng(17)
    int8 = moment_dtype == "int8"

    def draw(scale, fn=gen.standard_normal):
        return {n: torch.tensor(fn(s) * scale, dtype=torch.float32)
                for n, s in MOMENT_LEAVES.items()}

    host, grads, m0, v0 = draw(0.02), draw(1e-4), draw(1e-4), draw(1e-8, gen.random)
    grads2 = draw(1e-4)
    if int8:  # encoded once: both devices read the same bits
        m0 = {n: adamw._q8_encode(t) for n, t in m0.items()}
        v0 = {n: adamw._q8_encode(torch.sqrt(t)) for n, t in v0.items()}
    else:
        m0 = {n: t.to(getattr(torch, moment_dtype)) for n, t in m0.items()}
        v0 = {n: t.to(getattr(torch, moment_dtype)) for n, t in v0.items()}

    def to(x, dev):
        return {k: v.to(dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    def host_copy(x):
        if isinstance(x, dict):
            return {k: v.cpu().clone() for k, v in x.items()}
        return x.cpu().clone()

    runs = {}
    for dev in (DEV, "cpu"):
        params = {n: t.to(dev) for n, t in host.items()}
        st = adamw.adamw_init(params, cfg)
        st["m"] = {n: to(m0[n], dev) for n in params}
        st["v"] = {n: to(v0[n], dev) for n in params}
        st["count"].fill_(4)
        # the first moment before storage, as the update computes it
        m_f32 = {n: cfg.b1 * adamw._moment_read(st["m"][n], p, moment_dtype)
                 + (1 - cfg.b1) * grads[n].to(dev) for n, p in params.items()}
        adamw.adamw_update(params, {n: t.to(dev) for n, t in grads.items()}, st, cfg, 0.7)
        p1 = {n: p.cpu().clone() for n, p in params.items()}
        stored = {mom: {n: host_copy(st[mom][n]) for n in params} for mom in ("m", "v")}
        adamw.adamw_update(params, {n: t.to(dev) for n, t in grads2.items()}, st, cfg, 0.7)
        runs[dev] = (p1, stored, {n: p.cpu() for n, p in params.items()},
                     {n: t.cpu() for n, t in m_f32.items()})
    (c1, cs, c2, cm), (h1, hs, h2, hm) = runs[DEV], runs["cpu"]
    out = dict(p1=max(float((c1[n] - h1[n]).abs().max()) for n in c1), moments=0.0,
               p2_alike=0.0, p2_apart=0.0, n_apart=0, n_params_apart=0, n=0)
    if int8:
        out.update(m_f32_differ=sum(int((cm[n] != hm[n]).sum()) for n in cm),
                   blocks=0, scale_blocks=0, apart_outside_scale_blocks=0)
    for n in c1:
        numel = c1[n].numel()
        apart = torch.zeros(numel, dtype=torch.bool)
        for mom in ("m", "v"):
            a, b = cs[mom][n], hs[mom][n]
            if int8:
                dq = (a["q"].int() - b["q"].int()).abs()  # (blocks, 256)
                scale_differs = a["scale"] != b["scale"]
                out["moments"] = max(out["moments"], float(dq.max()))
                out["blocks"] += int(scale_differs.numel())
                out["scale_blocks"] += int(scale_differs.sum())
                out["apart_outside_scale_blocks"] += int(((dq > 0) & ~scale_differs[:, None]).sum())
                apart |= (dq > 0).reshape(-1)[:numel]
            else:
                out["moments"] = max(out["moments"], float((a.float() - b.float()).abs().max()))
                apart |= (a != b).reshape(-1)
        diff = (c2[n] - h2[n]).abs().reshape(-1)
        out["n"] += numel
        out["n_apart"] += int(apart.sum())
        out["n_params_apart"] += int((diff > ADAM_ATOL).sum())
        if (~apart).any():
            out["p2_alike"] = max(out["p2_alike"], float(diff[~apart].max()))
        if apart.any():
            out["p2_apart"] = max(out["p2_apart"], float(diff[apart].max()))
    if int8:  # the card's float division by a Python number against the CPU's
        t = torch.tensor(gen.random(1 << 20), dtype=torch.float32)
        out["div127_differ"] = int(((t.to(DEV) / 127.0).cpu() != t / 127.0).sum())
    return out


def _gemma3_tcfg(microbatches: int = 1, moment_dtype: str = "float32"):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import TrainConfig

    return TrainConfig(optimizer=AdamWConfig(lr=3e-3, moment_dtype=moment_dtype),
                       microbatches=microbatches, warmup_steps=5, total_steps=6)


def train_gemma3_paths(run: dict) -> dict:
    """The training paths the main run bypasses, on gemma3-1b at full width
    (ROADMAP §1, the training paths not run on the card): one step at
    microbatches 2 against microbatches 1 (loss and grad norm rel 1e-4);
    two steps each with bf16 and int8 moments (finite, step 0's loss
    equal to the f32 run's, the moments' bytes) and two AdamW updates
    with those moments on identical inputs, card against CPU
    (`_adamw_card_vs_cpu`); an async checkpoint
    of the main run's state (the host copy's time on the caller's thread,
    the write's on the writer's), restored into a state from another seed
    and compared bitwise."""
    import pathlib
    import shutil

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.train.step import init_train_state

    out = {}
    (m1, ms1), = _gemma3_step(_gemma3_tcfg(microbatches=1))[0]
    gc_collect()
    (m2, ms2), = _gemma3_step(_gemma3_tcfg(microbatches=2))[0]
    gc_collect()
    rel_l = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
    rel_g = abs(m2["grad_norm"] - m1["grad_norm"]) / abs(m1["grad_norm"])
    print(f"train gemma3-1b microbatches 2 vs 1, {TRAIN_BATCH}x{TRAIN_SEQ}: loss {m2['loss']:.6f}"
          f" vs {m1['loss']:.6f} rel {rel_l:.3e}, grad norm {m2['grad_norm']:.6f} vs "
          f"{m1['grad_norm']:.6f} rel {rel_g:.3e} (tol {REL_TOL_TRAIN_LOSS:g}); step "
          f"{ms2:.1f} ms vs {ms1:.1f} ms")
    if not (rel_l < REL_TOL_TRAIN_LOSS and rel_g < REL_TOL_TRAIN_LOSS):
        raise AssertionError("train: microbatches 2 vs 1 out of tolerance")
    out["microbatches"] = dict(loss_rel=rel_l, grad_norm_rel=rel_g, ms_mb1=ms1, ms_mb2=ms2)
    for md in ("bfloat16", "int8"):
        hist, nbytes = _gemma3_step(_gemma3_tcfg(moment_dtype=md), steps=2)
        gc_collect()
        a = _adamw_card_vs_cpu(md)
        m_tol = 1 if md == "int8" else ADAM_ATOL
        finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m, _ in hist)
        rel0 = abs(hist[0][0]["loss"] - m1["loss"]) / abs(m1["loss"])
        print(f"train gemma3-1b {md} moments: losses {[round(m['loss'], 6) for m, _ in hist]}, "
              f"grad norms {[round(m['grad_norm'], 6) for m, _ in hist]}, steps "
              f"{[round(t, 1) for _, t in hist]} ms, moments {nbytes / 2**30:.2f} GiB; step "
              f"0's loss against the f32 run's rel {rel0:.3e} (tol 1e-6: the same forward)")
        print(f"  AdamW card vs cpu at gemma3's leaf shapes, {a['n']} elements: update 1 params "
              f"{a['p1']:.3e} (tol {ADAM_ATOL:g}), stored moments {a['moments']:.3e} (tol "
              f"{m_tol:g}{' quantisation step' if md == 'int8' else ''}) apart at "
              f"{a['n_apart']} elements; update 2 params {a['p2_alike']:.3e} where the stored "
              f"moments agree (tol {ADAM_ATOL:g}), {a['p2_apart']:.3e} where they do not, "
              f"{a['n_params_apart']} params beyond {ADAM_ATOL:g}")
        if md == "int8":
            print(f"  int8 cause: f32 first moments before storage differ at "
                  f"{a['m_f32_differ']} elements; scale differs in {a['scale_blocks']} of "
                  f"{a['blocks']} blocks; elements a step apart outside those blocks "
                  f"{a['apart_outside_scale_blocks']}; the card's x / 127.0 differs from the "
                  f"CPU's at {a['div127_differ']} of {1 << 20} floats")
        if not (finite and rel0 < 1e-6 and a["p1"] <= ADAM_ATOL and a["moments"] <= m_tol
                and a["p2_alike"] <= ADAM_ATOL):
            raise AssertionError(f"train: {md} moments failed")
        out[md] = dict(losses=[m["loss"] for m, _ in hist], ms=[t for _, t in hist],
                       moment_bytes=nbytes, adamw=a)
    state = run["state"]
    ckpt = ckpt_io.AsyncCheckpointer(TRAIN_CKPT, keep=1)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    step = int(state["step"])
    n_bytes = sum(t.numel() * t.element_size() for _, t in ckpt_io._leaves(state))
    t0 = time.perf_counter()
    ckpt.save(step, state)
    t_copy = time.perf_counter() - t0
    ckpt.wait()
    t_write = time.perf_counter() - t0 - t_copy
    like = init_train_state(state["params"].cfg, _gemma3_tcfg(), seed=1, device=DEV)
    t0 = time.perf_counter()
    got, got_step = ckpt_io.restore(TRAIN_CKPT, None, like)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    want = dict(ckpt_io._leaves(state))
    same = [k for k, v in ckpt_io._leaves(got) if torch.equal(v, want[k])]
    size = sum(f.stat().st_size for f in pathlib.Path(TRAIN_CKPT).rglob("*") if f.is_file())
    print(f"train gemma3-1b async checkpoint of step {step}: {len(want)} leaves, "
          f"{n_bytes / 2**30:.2f} GiB in memory, {size / 2**30:.2f} GiB on disk; host copy "
          f"{t_copy:.2f} s on the caller's thread, write {t_write:.2f} s on the writer's "
          f"({size / 2**30 / max(t_write, 1e-9):.2f} GiB/s), restore {t_read:.2f} s; "
          f"restored step {got_step}, {len(same)}/{len(want)} leaves bitwise equal")
    if got_step != step or len(same) != len(want):
        raise AssertionError("train: the checkpoint did not restore bitwise")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    out["checkpoint"] = dict(step=step, bytes=n_bytes, disk_bytes=size, copy_s=t_copy,
                             write_s=t_write, restore_s=t_read)
    del like, got
    return out


def phase_train(smi: str, ptxas: dict) -> dict:
    """Phase 13 (module docstring): the flash and conv1d training kernels
    against their plain versions, gemma3-1b trained at full width, card
    against CPU, the loop drill, a profiled step, the paths the main run
    bypasses and the backward's times; then mamba2-1.3b and zamba2."""
    import dataclasses

    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    worst = train_kernels_vs_plain()
    conv = train_conv1d_vs_plain()
    run = train_full_width(smi)
    cfg = dataclasses.replace(get_arch("gemma3-1b"), dtype="float32")
    train_card_vs_cpu(f"gemma3-1b cut to {TRAIN_CUT} layers",
                      dataclasses.replace(cfg, n_layers=TRAIN_CUT), 1, TRAIN_CUT_S)
    train_loop_drill()
    prof = train_profile(run["state"], cfg)
    paths = train_gemma3_paths(run)
    run.pop("state")
    gc_collect()
    times = train_times(ptxas)
    ssm = train_ssm(smi, conv["backward"])
    print(f"train: phase wall time {time.perf_counter() - t_phase:.2f} s")
    return dict(worst=worst, run=run, profile=prof, times=times, conv=conv, paths=paths,
                ssm=ssm)


# ------------------------------------------------------------ phase 14

MOON = "moonshot-v1-16b-a3b"
MOON_WIDTH = (2048, 16, 128, 1408, 163840)  # d_model, heads, head dim, d_ff an expert, vocab
# served depth: all 48 layers in fp32 (28.06 B params, 104.5 GiB) exceed the
# card; 30 keep the weights at 66.3 GiB
MOON_SERVE_LAYERS = 30
MOON_FREE = 6 * 2**30  # the served run's peak must leave this much of the card free
MOON_CUT = 2  # layers of the card-vs-CPU parts (serving and training)
# trained depth: 4 layers (2.95 B params, 44 GiB of params, grads and two f32
# moments) peaked at 52.92 GiB on the H100, under 60, so 5 (3.52 B)
MOON_TRAIN_LAYERS = 5
RESIDUAL_LIMIT = 2**30  # card memory earlier phases may leave allocated
TIE_GAP = 1e-5  # a top-k set may differ card vs CPU only where p_k - p_k+1 is below it


def _kept(r) -> torch.Tensor:
    """(N, E) bool on the host: token t holds a slot at expert e."""
    ids, keep = r.ids.cpu(), r.keep.cpu()
    return torch.zeros((ids.shape[0], r.probs.shape[1]), dtype=torch.bool).scatter_(1, ids, keep)


def moe_drops(routes) -> list:
    """Per MoE call: (pairs dropped by capacity, tokens that lost every
    choice, capacity)."""
    return [(int((~r.keep).sum()), int((~r.keep.any(dim=1)).sum()), r.cap) for r in routes]


def routing_agreement(card, cpu, n_layers: int, name: str = MOON) -> dict:
    """The card's and the CPU's routing, call by call (the prefill's
    layers, then every decode step's): top-k sets per token and kept
    (token, expert) pairs.  A set may differ only where the CPU's gap
    between its k-th and (k+1)-th probability is below TIE_GAP, and kept
    pairs must be equal wherever every set is; anything else raises."""
    if len(card) != len(cpu):
        raise AssertionError(f"{name}: {len(card)} MoE calls on the card, {len(cpu)} on the cpu")
    out = dict(calls=len(card), sets_differ=0, keep_differ=0, worst_gap=None)
    for i, (a, b) in enumerate(zip(card, cpu)):
        k = b.ids.shape[1]
        differ = (a.ids.cpu().sort(dim=1).values != b.ids.sort(dim=1).values).any(dim=1)
        n_keep = int((_kept(a) != _kept(b)).sum())
        n_sets = int(differ.sum())
        gap = None
        if n_sets:
            top = b.probs[differ].topk(k + 1, dim=1).values
            gap = float((top[:, k - 1] - top[:, k]).max())
            out["worst_gap"] = max(gap, out["worst_gap"] or 0.0)
        out["sets_differ"] += n_sets
        out["keep_differ"] += n_keep
        if i < n_layers:
            print(f"  routing layer {i} prefill ({b.ids.shape[0]} tokens, cap {b.cap}): top-{k} "
                  f"sets equal {n_sets == 0} ({n_sets} differ"
                  f"{'' if gap is None else f', largest p{k} - p{k + 1} gap {gap:.3e}'}); keep "
                  f"equal {n_keep == 0} ({n_keep} (token, expert) pairs differ)")
        if (gap is not None and gap >= TIE_GAP) or (n_sets == 0 and n_keep):
            raise AssertionError(f"{name}: card and cpu route call {i} differently "
                                 f"({n_sets} sets, gap {gap}, {n_keep} kept pairs)")
    print(f"  routing over all {out['calls']} MoE calls (prefill and {LM_NEW} decode steps): "
          f"{out['sets_differ']} top-k sets and {out['keep_differ']} kept pairs differ "
          f"(a set may differ where p_k - p_k+1 < {TIE_GAP:g})")
    return out


def serve_moe(cfg, smi: str, describe) -> dict:
    """An MoE model at full width (`cfg`, a depth cut), fp32, seed 0,
    through `Engine` with phase 6's six requests: prefill ms a wave,
    decode ms a step, peak memory from before the init (at least MOON_FREE
    of the card left), the pairs wave 1's capacity dropped per layer;
    flash launches = layers x waves, the decode MLP, conv1d and tile
    kernels none; layer 0's `moe_forward` with no host sync.
    `describe(n_params)` is the model's line."""
    from repro_torch.models import init_lm, record_routing
    from repro_torch.serve import Engine, ServeConfig

    mods = kernel_libraries()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.name}: {describe(n_params)}, init {time.perf_counter() - t0:.2f} s")
    reqs = lm_requests(cfg, LM_PROMPTS)
    engine = Engine(model, ServeConfig(max_batch=MAX_BATCH, max_len=LM_MAX_LEN))
    for mod in mods.values():
        mod.LAUNCHES = 0  # main path: count only the served run
    t0 = time.perf_counter()
    with record_routing() as routes:
        out = engine.run(reqs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    free = torch.cuda.get_device_properties(0).total_memory - peak
    for r in reqs:
        toks = out[r.rid]
        if len(toks) != LM_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{cfg.name} rid {r.rid}: bad tokens {toks}")
    waves, steps = len(engine.waves), sum(w["decode_steps"] for w in engine.waves)
    n_tok = sum(w["tokens"] for w in engine.waves)
    for i, w in enumerate(engine.waves):
        print(f"  wave {i}: {w['size']} requests, prompt {w['prompt_len']} tokens, "
              f"prefill {w['prefill_s'] * 1e3:.2f} ms, decode "
              f"{w['decode_s'] / max(w['decode_steps'], 1) * 1e3:.3f} ms/step "
              f"over {w['decode_steps']} steps")
    print(f"  {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s, "
          f"host clock after synchronize); peak max_memory_allocated {peak / 2**30:.2f} GiB, "
          f"{free / 2**30:.2f} GiB of the card left (need {MOON_FREE / 2**30:g}); card {smi}")
    moe_sync_free(model, cfg, engine.waves[0])
    drops = moe_drops(routes[:cfg.n_layers])  # wave 1's prefill, layer by layer
    n1 = engine.waves[0]["size"] * engine.waves[0]["prompt_len"]
    print(f"  wave 1 ({n1} tokens x top-{cfg.moe.top_k}, capacity {drops[0][2]} an expert): "
          f"pairs dropped by capacity per layer {[d for d, _, _ in drops]}; tokens that lost "
          f"every choice per layer {[t for _, t, _ in drops]}")
    want = {"flash_attention": cfg.n_layers * waves, "decode_mlp": 0, "conv1d_fused": 0,
            "fused_tile": 0, "flash_attention_bwd": 0, "conv1d_fused_bwd": 0}
    print(f"  launches: {launches} over {waves} waves, {steps} decode steps (want {want})")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{cfg.name}: {k} launched {launches[k]} times, expected {n}")
    if free < MOON_FREE:
        raise AssertionError(f"{cfg.name}: {cfg.n_layers} layers leave {free / 2**30:.2f} "
                             "GiB free")
    return dict(model=model, cfg=cfg, launches=launches, waves=waves, steps=steps,
                n_params=n_params, peak_bytes=peak, wave_stats=engine.waves,
                wave1_dropped_pairs=[d for d, _, _ in drops])


def moonshot_serve(smi: str) -> dict:
    """moonshot at full width on MOON_SERVE_LAYERS of its 48 layers
    (`serve_moe`)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(MOON), dtype="float32", n_layers=MOON_SERVE_LAYERS)
    published_width(cfg, MOON_WIDTH)
    return serve_moe(cfg, smi, lambda n: (
        f"{cfg.n_layers} of 48 layers (the depth cut: fp32 weights of all 48 exceed the "
        f"card), d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; {n / 1e9:.4f} B params fp32"))


def moe_sync_free(model, cfg, wave: dict) -> None:
    """Layer 0's `moe_forward` at `wave`'s prefill shape and at a decode
    step's (B, 1, D), with the card in sync-debug mode "error": a host
    sync in the layer raises."""
    from repro_torch.models import moe_forward

    p = model.layers[0]["moe"]
    gen = np.random.default_rng(14)
    xs = [_cuda(gen, (wave["size"], n, cfg.d_model)) for n in (wave["prompt_len"], 1)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            for x in xs:
                moe_forward(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  layer 0 moe_forward at {[tuple(x.shape) for x in xs]} in sync-debug mode "
          "\"error\": no host sync")


def _cpu_copy(model):
    """A copy of `model` on the CPU, made leaf by leaf (no second copy on
    the card)."""
    import copy

    memo = {id(p): torch.nn.Parameter(p.detach().cpu(), requires_grad=p.requires_grad)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)


def moonshot_vs_cpu(served) -> dict:
    """The served weights cut to MOON_CUT layers, card against CPU
    (`_card_vs_cpu`: prompts 600 and 40, capacity 144 drops pads), and
    both devices' routing call by call (`routing_agreement`)."""
    cut = _cut(served["model"], MOON_CUT)
    launches, routes = _card_vs_cpu(MOON, cut, cut.cfg, MOON_CUT)
    if launches["flash_attention"] != MOON_CUT or launches["decode_mlp"]:
        raise AssertionError(f"{MOON} cut: launches {launches}")
    drops = moe_drops(routes["card"][:MOON_CUT])
    print(f"  card prefill of (600, 40) at capacity {drops[0][2]}: pairs dropped per layer "
          f"{[d for d, _, _ in drops]}")
    return routing_agreement(routes["card"], routes["cpu"], MOON_CUT)


def train_repeat(model, cfg, seq: int = TRAIN_SEQ, src_frames: int = 0) -> dict:
    """`lm_loss` of one batch (the stream's batch after the run's, B 4 x
    S `seq`, `stream_batch`) and its gradients, computed twice from one
    state: the loss,
    its reported terms (aux losses; an MTP head's mtp_nll) and every
    gradient leaf must be bitwise equal (a deterministic forward, so
    remat's recompute routes as the forward did, and no atomic adds in
    the backward)."""
    from repro_torch.models import lm_loss

    host = stream_batch(cfg, TRAIN_STEPS + 1, seq, src_frames)
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in host.items()}
    names, params = zip(*model.named_parameters())
    keys = ["moe_aux", "moe_z"] + (["mtp_nll"] if cfg.mtp else [])
    runs = []
    for _ in range(2):
        loss, metrics = lm_loss(model, batch)
        grads = torch.autograd.grad(loss, params)
        runs.append(([loss.detach()] + [metrics[k].detach() for k in keys], grads))
    (v1, g1), (v2, g2) = runs
    same = all(torch.equal(a, b) for a, b in zip(v1, v2))
    diffs = [float((a - b).abs().max()) for a, b in zip(g1, g2)]
    worst = max(range(len(diffs)), key=diffs.__getitem__)
    n_diff = sum(d > 0 for d in diffs)
    terms = ", ".join(f"{k} {float(a):.9e} / {float(b):.9e}"
                      for k, a, b in zip(["loss"] + keys, v1, v2))
    print(f"train {cfg.name} repeat: {terms}: bitwise equal {same}; {n_diff} of {len(diffs)} "
          f"gradient leaves differ (largest difference {diffs[worst]:.3e} at {names[worst]})")
    if not same or n_diff:
        raise AssertionError(f"train {cfg.name}: one batch's loss or gradients are not "
                             "repeatable")
    return dict(bitwise=same, max_grad_diff=diffs[worst], grad_leaves_differ=n_diff)


def moonshot_train(smi: str) -> dict:
    """moonshot at full width on MOON_TRAIN_LAYERS layers: six steps of
    `launch.train`'s run (`_train_cut`), aux losses finite and non-zero
    every step, flash launches as planned (`train_run`); a profiled step;
    the repeatability of one batch's loss and gradients (`train_repeat`);
    a MOON_CUT-layer cut's loss, aux losses and gradients card against CPU
    at B 1 x S 512."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(MOON), dtype="float32", n_layers=MOON_TRAIN_LAYERS)
    published_width(cfg, MOON_WIDTH)
    run = train_run(f"{MOON} ({MOON_TRAIN_LAYERS} layers)",
                    lambda: _train_cut(cfg, TRAIN_STEPS), smi)
    aux = [(h["moe_aux"], h["moe_z"]) for h in run["history"]]
    if not all(np.isfinite(a) and a != 0 for pair in aux for a in pair):
        raise AssertionError(f"train {MOON}: aux losses {aux}")
    state = run.pop("state")
    run["profile"] = train_profile(state, cfg)
    state.pop("opt")  # the moments: room for two gradients at once
    gc_collect()
    run["repeat"] = train_repeat(state["params"], cfg)
    del state
    gc_collect()
    train_card_vs_cpu(f"{MOON} cut to {MOON_CUT} layers",
                      dataclasses.replace(cfg, n_layers=MOON_CUT), 1, TRAIN_CUT_SSM_S)
    gc_collect()
    return run


def phase_moonshot(smi: str) -> dict:
    """Phase 14 (module docstring): moonshot-v1-16b-a3b served at full
    width (cut in depth), card against CPU with its routing, a profiled
    prefill and decode step, then trained at full width."""
    t_phase = time.perf_counter()
    gc_collect()
    left = torch.cuda.memory_allocated()
    print(f"moonshot: {left / 2**30:.3f} GiB still allocated on the card by earlier phases "
          f"(limit {RESIDUAL_LIMIT / 2**30:g})")
    if left >= RESIDUAL_LIMIT:
        raise AssertionError(f"{left} bytes left allocated before {MOON} loads")
    served = moonshot_serve(smi)
    served["routing"] = moonshot_vs_cpu(served)
    phase_lm_profile({MOON: served})
    served.pop("model")
    gc_collect()
    train = moonshot_train(smi)
    print(f"moonshot: phase wall time {time.perf_counter() - t_phase:.2f} s")
    return dict(serve=served, train=train)


# ------------------------------------------------------------ phase 15

DS = "deepseek-v3-671b"
# d_model, heads, head dim (d_model // heads: the MTP block's attention; MLA's
# q/k and v head dims are 192 and 128), d_ff an expert, vocab
DS_WIDTH = (7168, 128, 56, 2048, 129280)
# served depth: one layer at full width with the embedding, the head and the
# MTP head is 13.74 B params, 51.18 GiB in fp32; two are 94.05 GiB
DS_SERVE_LAYERS = 1
DS_SERVE_PARAMS = 13_738_691_584
# trained: every width, one layer and the MTP head, the expert count cut from
# 256 to 16 (one layer's 256 experts, 11.27 B params, need ~184 GB of param,
# gradient and two f32 moments): 3.17 B params, 47.2 GiB of state
DS_TRAIN_EXPERTS = 16
DS_CUT_EXPERTS = 8  # the training card-vs-CPU cut


def _expert_cut(model, n_experts: int):
    """The same weights (shared, not copied) with each MoE layer cut to its
    first `n_experts` experts (the router's first columns)."""
    import dataclasses

    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(model.cfg.moe,
                                                                 n_experts=n_experts))
    tree = {k: model[k] for k in ("embed", "final_norm", "lm_head", "shared", "mtp")
            if k in model}
    tree["layers"] = []
    for lp in model.layers:
        layer = {name: mod for name, mod in lp.named_children() if name != "moe"}
        layer.update((name, t) for name, t in lp.named_parameters(recurse=False))
        moe = dict(lp["moe"].named_parameters())
        moe["router"] = moe["router"][:, :n_experts]
        for w in ("w1", "w2", "w3"):
            moe[w] = moe[w][:n_experts]
        layer["moe"] = moe
        tree["layers"].append(layer)
    return LM(cfg, tree)


def mla_sync_free(model, cfg, wave: dict) -> None:
    """Layer 0's MLA decode step (`mla_decode`: the step's latents into the
    cache, then `mla_decode_absorbed`) over a cache filled at `wave`'s
    prompt length, with the card in sync-debug mode "error": a host sync
    in it raises."""
    from repro_torch.models import attention as attn_mod

    p = model.layers[0]["attn"]
    gen = np.random.default_rng(15)
    b, n = wave["size"], wave["prompt_len"]
    pos = torch.arange(n, dtype=torch.int32, device=DEV).expand(b, n)
    cache = attn_mod.init_mla_cache(cfg, b, LM_MAX_LEN, torch.float32, DEV)
    x = _cuda(gen, (b, 1, cfg.d_model))
    with torch.inference_mode():
        c_kv, k_rope = attn_mod._mla_kv_latent(p, _cuda(gen, (b, n, cfg.d_model)), pos, cfg)
        attn_mod.fill_mla_cache(cache, c_kv, k_rope, pos)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            y, _ = attn_mod.mla_decode(p, x, n, cache, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if tuple(y.shape) != (b, 1, cfg.d_model) or not torch.isfinite(y).all():
        raise AssertionError(f"{DS}: bad absorbed decode output {tuple(y.shape)}")
    print(f"  layer 0 mla_decode (absorbed) at B{b} over a {n}-token latent cache in "
          "sync-debug mode \"error\": no host sync")


def deepseek_serve(smi: str) -> dict:
    """deepseek-v3-671b at full width on DS_SERVE_LAYERS of its 61 layers
    (`serve_moe`: flash at q/k hd 192, v hd 128; the absorbed MLA decode),
    the param count held exactly, and layer 0's MLA decode step with no
    host sync."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(DS), dtype="float32", n_layers=DS_SERVE_LAYERS)
    published_width(cfg, DS_WIDTH)
    m = cfg.mla
    served = serve_moe(cfg, smi, lambda n: (
        f"{cfg.n_layers} of 61 layers (the depth cut: two layers in fp32 are 94.05 GiB), "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of MLA (q_lora {m.q_lora_rank}, kv_lora "
        f"{m.kv_lora_rank}, q/k hd {m.qk_nope_dim + m.qk_rope_dim}, v hd {m.v_head_dim}), "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} and {cfg.moe.n_shared} shared of "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, the MTP head (hd {cfg.resolved_head_dim}; "
        f"never served); {n / 1e9:.4f} B params fp32 ({n * 4 / 2**30:.2f} GiB)"))
    if served["n_params"] != DS_SERVE_PARAMS:
        raise AssertionError(f"{DS}: {served['n_params']} params, expected {DS_SERVE_PARAMS}")
    mla_sync_free(served["model"], cfg, served["wave_stats"][0])
    return served


def deepseek_vs_cpu(served) -> dict:
    """The served layer with its experts cut to DS_TRAIN_EXPERTS, card
    against CPU (`_card_vs_cpu`: prompts 600 and 40, prefill and
    teacher-forced absorbed-decode logits, greedy tokens), and both
    devices' routing call by call (`routing_agreement`)."""
    cut = _expert_cut(served["model"], DS_TRAIN_EXPERTS)
    name = f"{DS} ({DS_TRAIN_EXPERTS} experts)"
    launches, routes = _card_vs_cpu(name, cut, cut.cfg, DS_SERVE_LAYERS)
    if launches["flash_attention"] != DS_SERVE_LAYERS or launches["decode_mlp"]:
        raise AssertionError(f"{name}: launches {launches}")
    drops = moe_drops(routes["card"][:DS_SERVE_LAYERS])
    print(f"  card prefill of (600, 40) at capacity {drops[0][2]}: pairs dropped per layer "
          f"{[d for d, _, _ in drops]}")
    return routing_agreement(routes["card"], routes["cpu"], DS_SERVE_LAYERS, name=name)


def deepseek_train(smi: str) -> dict:
    """deepseek-v3-671b at full width on one layer and the MTP head, the
    expert count cut to DS_TRAIN_EXPERTS: six steps of `launch.train`'s
    run (`_train_cut`), nll, mtp_nll and the aux losses finite and
    mtp_nll non-zero every step, flash launches as planned (MLA x 2 for
    remat + the MTP block a step; the backward MLA + MTP) (`train_run`);
    a profiled step; one batch's loss and gradients twice from one state
    (`train_repeat`); a DS_CUT_EXPERTS-expert cut's loss, mtp_nll and
    gradients card against CPU at B 1 x S 512."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch(DS)
    cfg = dataclasses.replace(full, dtype="float32", n_layers=DS_SERVE_LAYERS,
                              moe=dataclasses.replace(full.moe, n_experts=DS_TRAIN_EXPERTS))
    published_width(cfg, DS_WIDTH)
    label = f"{DS} (1 layer + MTP, {DS_TRAIN_EXPERTS} experts)"
    run = train_run(label, lambda: _train_cut(cfg, TRAIN_STEPS), smi)
    keys = ("nll", "mtp_nll", "moe_aux", "moe_z")
    terms = [[h[k] for k in keys] for h in run["history"]]
    if not all(np.isfinite(t).all() and h["mtp_nll"] != 0 for t, h in zip(terms, run["history"])):
        raise AssertionError(f"train {DS}: {keys} {terms}")
    free = torch.cuda.get_device_properties(0).total_memory - run["peak_bytes"]
    print(f"train {label}: peak leaves {free / 2**30:.2f} GiB of the card at B{TRAIN_BATCH}")
    state = run.pop("state")
    run["profile"] = train_profile(state, cfg)
    state.pop("opt")  # the moments: room for two gradients at once
    gc_collect()
    run["repeat"] = train_repeat(state["params"], cfg)
    del state
    gc_collect()
    cut = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=DS_CUT_EXPERTS))
    train_card_vs_cpu(f"{DS} cut to {DS_CUT_EXPERTS} experts (1 layer + MTP)", cut, 1,
                      TRAIN_CUT_SSM_S)
    gc_collect()
    return run


def phase_deepseek(smi: str) -> dict:
    """Phase 15 (module docstring): deepseek-v3-671b served at full width
    (one layer), card against CPU with its routing, a profiled prefill
    and decode step, then trained at full width (16 experts) with the MTP
    head."""
    t_phase = time.perf_counter()
    gc_collect()
    left = torch.cuda.memory_allocated()
    print(f"deepseek: {left / 2**30:.3f} GiB still allocated on the card by earlier phases "
          f"(limit {RESIDUAL_LIMIT / 2**30:g})")
    if left >= RESIDUAL_LIMIT:
        raise AssertionError(f"{left} bytes left allocated before {DS} loads")
    served = deepseek_serve(smi)
    served["routing"] = deepseek_vs_cpu(served)
    phase_lm_profile({DS: served})
    served.pop("model")
    gc_collect()
    train = deepseek_train(smi)
    print(f"deepseek: phase wall time {time.perf_counter() - t_phase:.2f} s")
    return dict(serve=served, train=train)


# ------------------------------------------------------------ phase 16

SEAMLESS = "seamless-m4t-medium"
SEAMLESS_WIDTH = (1024, 16, 64, 4096, 256206)  # d_model, heads, head dim, d_ff, vocab
SEAMLESS_PARAMS = 981_530_624  # 12 + 12 layers, the untied head; 201,352,192 in the encoder
SEAMLESS_SRC = 1024  # source frames: the reference's SRC_FRAMES (launch/specs.py)
SEAMLESS_PROMPT = 128  # the decoder prompt of the reference's prefill_specs
SEAMLESS_TRAIN_SEQ = 512  # target tokens a training row, beside SEAMLESS_SRC frames
SEAMLESS_CUT = 2  # encoder and decoder layers of the card-vs-CPU cuts
SEAMLESS_CPU_WAVE = (2, 600, 40, 8)  # the serving cut's B, frames, prompt, decode steps
REL_TOL_SEAMLESS_LOSS = 1e-5  # the training cut's loss, card vs CPU


def _seamless_frames(b: int, frames: int, d: int, seed: int) -> np.ndarray:
    """Source frame embeddings (the reference's speech frontend is a stub
    that provides them), N(0, 1) as the reference's tests draw them."""
    return np.random.default_rng(seed).standard_normal((b, frames, d)).astype(np.float32)


def _seamless_cut(model, n: int):
    """The same weights (shared, not copied) cut to the first `n` encoder
    and `n` decoder layers."""
    import dataclasses

    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(model.cfg, n_layers=n, encoder_layers=n)
    tree = {k: model[k] for k in ("embed", "final_norm", "lm_head")}
    tree["layers"] = list(model.layers[:n])
    tree["encoder"] = {"final_norm": model.encoder.final_norm,
                       "layers": list(model.encoder.layers[:n])}
    return LM(cfg, tree)


def seamless_serve(smi: str) -> dict:
    """seamless-m4t-medium at full size, fp32, seed 0 (the param count held
    exactly): one wave of B 4 over SEAMLESS_SRC frames with a
    SEAMLESS_PROMPT-token prompt, 16 new tokens greedy (the prefill's and
    15 decode steps') through `lm_prefill` and `lm_decode_step`, every
    count zeroed before and held exactly after: flash 3 x 12 a wave
    (encoder self at S 1024, decoder self causal, cross at Sq 128 / Sk
    1024) and 12 a decode step (cross at Sq 1), the decode MLP 12 a step,
    the rest none.  Then the encoder's, the prefill's and a decode step's
    warm times (CUDA events)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm, lm_decode_step, lm_prefill
    from repro_torch.models.lm import _encode

    cfg = dataclasses.replace(get_arch(SEAMLESS), dtype="float32")
    published_width(cfg, SEAMLESS_WIDTH)
    mods = kernel_libraries()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_enc = sum(p.numel() for p in model.encoder.parameters())
    print(f"model {SEAMLESS}: {cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim} (MHA), d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, untied head; {n_params:,} params fp32 "
          f"({n_params * 4 / 2**30:.2f} GiB; encoder {n_enc:,}), init "
          f"{time.perf_counter() - t0:.2f} s")
    if n_params != SEAMLESS_PARAMS:
        raise AssertionError(f"{SEAMLESS}: {n_params} params, expected {SEAMLESS_PARAMS}")
    b, steps = MAX_BATCH, LM_NEW - 1
    src = torch.from_numpy(_seamless_frames(b, SEAMLESS_SRC, cfg.d_model, 16)).to(DEV)
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (b, SEAMLESS_PROMPT))).to(DEV)
    max_len = SEAMLESS_PROMPT + LM_NEW

    def wave():
        logits, state = lm_prefill(model, toks, max_len, src_embeds=src)
        out = [logits.argmax(-1)]
        for t in range(steps):
            logits, state = lm_decode_step(model, out[-1], SEAMLESS_PROMPT + t, state)
            out.append(logits.argmax(-1))
        return torch.stack(out, 1), state

    for mod in mods.values():
        mod.LAUNCHES = 0  # main path: count only the served wave
    t0 = time.perf_counter()
    new, state = wave()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    new = new.cpu()
    if tuple(new.shape) != (b, LM_NEW) or not ((new >= 0) & (new < cfg.vocab_size)).all():
        raise AssertionError(f"{SEAMLESS}: bad tokens {new.tolist()}")
    cross_x = state["cross_x"]
    if tuple(cross_x.shape) != (b, SEAMLESS_SRC, cfg.d_model) or not torch.isfinite(
            cross_x).all():
        raise AssertionError(f"{SEAMLESS}: bad encoder output {tuple(cross_x.shape)}")
    n_layers = cfg.n_layers  # a wave: encoder self, decoder self and cross; a step: cross
    want = {"flash_attention": cfg.encoder_layers + 2 * n_layers + n_layers * steps,
            "decode_mlp": n_layers * steps,
            "conv1d_fused": 0, "fused_tile": 0, "flash_attention_bwd": 0,
            "conv1d_fused_bwd": 0}
    print(f"  wave: B{b}, {SEAMLESS_SRC} frames, prompt {SEAMLESS_PROMPT}, {LM_NEW} new tokens "
          f"(prefill + {steps} decode steps) in {wall:.3f} s with the first calls' "
          f"allocations; peak max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches} "
          f"(want {want})")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{SEAMLESS}: {k} launched {launches[k]} times, expected {n}")
    with torch.inference_mode():
        _, st = lm_prefill(model, toks, max_len, src_embeds=src)
        enc_ms = time_ms(lambda: _encode(model, src), reps=5)
        prefill_ms = time_ms(lambda: lm_prefill(model, toks, max_len, src_embeds=src), reps=5)
        tok = toks[:, -1]
        step_ms = time_ms(lambda: lm_decode_step(model, tok, SEAMLESS_PROMPT, st), reps=10)
    tok_s = b * LM_NEW / ((prefill_ms + steps * step_ms) / 1e3)
    print(f"  warm (CUDA events, median): encoder {enc_ms:.3f} ms, prefill {prefill_ms:.3f} ms "
          f"(encoder included), decode {step_ms:.3f} ms a step; a wave of {b} x {LM_NEW} "
          f"tokens at these times {tok_s:.1f} tokens/s; card {smi}")
    return dict(model=model, cfg=cfg, src=src, toks=toks, max_len=max_len, launches=launches,
                steps=steps, n_params=n_params, peak_bytes=peak, encoder_ms=enc_ms,
                prefill_ms=prefill_ms, decode_step_ms=step_ms, tokens_per_s=tok_s)


def seamless_vs_cpu(served) -> None:
    """The served weights cut to SEAMLESS_CUT encoder and decoder layers,
    card against CPU (a copy made leaf by leaf): one wave of B 2 over 600
    frames with a 40-token prompt, the prefill logits and 8 decode steps
    teacher-forced on the card's greedy tokens within REL_TOL_LM_CPU, and
    the same greedy tokens; flash launches 3 a layer at prefill and 1 a
    layer a step, the decode MLP 1 a layer a step."""
    cut = _seamless_cut(served["model"], SEAMLESS_CUT)
    cpu = _cpu_copy(cut)
    b, frames, prompt, steps = SEAMLESS_CPU_WAVE
    src = _seamless_frames(b, frames, cut.cfg.d_model, 17)
    toks = np.random.default_rng(17).integers(0, cut.cfg.vocab_size, (b, prompt))
    mods = kernel_libraries()
    for mod in mods.values():
        mod.LAUNCHES = 0  # count only the card run
    t0 = time.perf_counter()
    card, fed = _logits_run(cut, toks, steps, src=src)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    t0 = time.perf_counter()
    host, _ = _logits_run(cpu, toks, steps, forced=fed, src=src)
    t_cpu = time.perf_counter() - t0
    if not (torch.isfinite(card).all() and torch.isfinite(host).all()):
        raise AssertionError(f"{SEAMLESS}: non-finite logits")
    scale = float(host.abs().max())
    errs = [float((card[i] - host[i]).abs().max()) / scale for i in range(len(card))]
    same = bool((card.argmax(-1) == host.argmax(-1)).all())
    top2 = card.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    n = SEAMLESS_CUT
    want_flash, want_mlp = 3 * n + n * steps, n * steps
    print(f"card-vs-cpu {SEAMLESS} cut to {n} + {n} layers, B{b}, {frames} frames, prompt "
          f"{prompt}: prefill rel err {errs[0]:.3e}, decode max rel err {max(errs[1:]):.3e} "
          f"over {steps} teacher-forced steps (tol {REL_TOL_LM_CPU:g}); greedy tokens equal: "
          f"{same} (smallest top-2 logit margin {margin:.3e}); card {t_card:.2f} s, cpu "
          f"{t_cpu:.2f} s; card launches {launches}")
    if not max(errs) < REL_TOL_LM_CPU:
        raise AssertionError(f"{SEAMLESS}: card vs cpu rel err {max(errs):.3e}")
    if not same:
        raise AssertionError(f"{SEAMLESS}: greedy tokens differ between card and cpu")
    if launches["flash_attention"] != want_flash or launches["decode_mlp"] != want_mlp:
        raise AssertionError(f"{SEAMLESS} cut: launches {launches}")


def seamless_profile(served) -> dict:
    """One warm prefill (encoder included) and one warm decode step of the
    served wave under the profiler (`profile_call`), and what recomputing
    the cross K/V from `cross_x` costs a decode step: the 24 projections
    (k and v of 12 layers, B 4 x 1024 frames) alone, by CUDA events and by
    the profiler's device time a call (`device_ms`), whose share of the
    profiled step's busy time is `cross_kv_share_of_busy` (both device
    times); `cross_kv_share` is the events' share of the step's time by
    events."""
    from repro_torch.models import lm_decode_step, lm_prefill

    model, src, toks, max_len = (served[k] for k in ("model", "src", "toks", "max_len"))
    with torch.inference_mode():
        _, state = lm_prefill(model, toks, max_len, src_embeds=src)
        tok = toks[:, -1]
        out = {}
        for label, fn in ((f"prefill B{len(toks)} S{SEAMLESS_PROMPT} frames {SEAMLESS_SRC}",
                           lambda: lm_prefill(model, toks, max_len, src_embeds=src)),
                          (f"decode step B{len(toks)}",
                           lambda: lm_decode_step(model, tok, SEAMLESS_PROMPT, state))):
            r = profile_call(SEAMLESS, label, fn)
            r.pop("events")
            out["prefill" if label.startswith("prefill") else "decode"] = r
        cross_x = state["cross_x"]

        def cross_kv():
            return [(cross_x @ lp["cross"].wk, cross_x @ lp["cross"].wv) for lp in model.layers]

        kv_ms = time_ms(cross_kv, reps=10)
        kv_busy = device_ms(cross_kv, "", reps=10)  # every kernel the projections launch
    share = kv_ms / served["decode_step_ms"]
    step_busy = out["decode"]["busy_ms"]
    busy_share = kv_busy / step_busy if kv_busy and step_busy else None
    print(f"  cross K/V recomputed a decode step: {2 * len(model.layers)} projections of "
          f"{tuple(cross_x.shape)}: {kv_ms:.3f} ms by CUDA events, {share:.3f} of the step's "
          f"{served['decode_step_ms']:.3f} ms by events; {kv_busy} ms of device time a call, "
          f"{busy_share} of the profiled step's {step_busy} ms busy")
    out.update(cross_kv_ms=kv_ms, cross_kv_share=share, cross_kv_busy_ms=kv_busy,
               cross_kv_share_of_busy=busy_share)
    return out


def seamless_train(smi: str) -> dict:
    """seamless-m4t-medium trained at full size: `launch.train`'s run
    (`_train_cut`: its TrainConfig, loop and seed) for 6 steps of B 4 x
    SEAMLESS_TRAIN_SEQ target tokens of the reference's `TokenStream`
    beside SEAMLESS_SRC frames (`stream_batch`); flash 60 and its backward
    36 launches a step (`train_run`: encoder 12 without remat, decoder
    self and cross 2 x 12 each with it); nll finite every step; a profiled
    step; one batch's loss and gradients twice from one state, bitwise;
    a SEAMLESS_CUT + SEAMLESS_CUT-layer cut's loss (rel 1e-5) and every
    gradient leaf card against CPU at B 1 x S 512 over 1024 frames."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(SEAMLESS), dtype="float32")
    run = train_run(f"{SEAMLESS} ({cfg.encoder_layers} + {cfg.n_layers} layers)",
                    lambda: _train_cut(cfg, TRAIN_STEPS, SEAMLESS_TRAIN_SEQ, SEAMLESS_SRC), smi,
                    seq=SEAMLESS_TRAIN_SEQ)
    if run["n_params"] != SEAMLESS_PARAMS:
        raise AssertionError(f"train {SEAMLESS}: {run['n_params']} params")
    if not all(np.isfinite(h["nll"]) for h in run["history"]):
        raise AssertionError(f"train {SEAMLESS}: nll {[h['nll'] for h in run['history']]}")
    state = run.pop("state")
    run["profile"] = train_profile(state, cfg, seq=SEAMLESS_TRAIN_SEQ, src_frames=SEAMLESS_SRC)
    state.pop("opt")
    gc_collect()
    run["repeat"] = train_repeat(state["params"], cfg, SEAMLESS_TRAIN_SEQ, SEAMLESS_SRC)
    del state
    gc_collect()
    cut = dataclasses.replace(cfg, n_layers=SEAMLESS_CUT, encoder_layers=SEAMLESS_CUT)
    train_card_vs_cpu(f"{SEAMLESS} cut to {SEAMLESS_CUT} + {SEAMLESS_CUT} layers", cut, 1,
                      SEAMLESS_TRAIN_SEQ, src_frames=SEAMLESS_SRC,
                      loss_tol=REL_TOL_SEAMLESS_LOSS)
    gc_collect()
    return run


def phase_seamless(smi: str) -> dict:
    """Phase 16 (module docstring): seamless-m4t-medium served at full
    size, card against CPU on a cut, a profiled prefill and decode step,
    then trained at full size."""
    t_phase = time.perf_counter()
    gc_collect()
    left = torch.cuda.memory_allocated()
    print(f"seamless: {left / 2**30:.3f} GiB still allocated on the card by earlier phases "
          f"(limit {RESIDUAL_LIMIT / 2**30:g})")
    if left >= RESIDUAL_LIMIT:
        raise AssertionError(f"{left} bytes left allocated before {SEAMLESS} loads")
    served = seamless_serve(smi)
    seamless_vs_cpu(served)
    served["profile"] = seamless_profile(served)
    for k in ("model", "src", "toks"):
        served.pop(k)
    gc_collect()
    train = seamless_train(smi)
    print(f"seamless: phase wall time {time.perf_counter() - t_phase:.2f} s")
    return dict(serve=served, train=train)

# ------------------------------------------------------------ phase 17

BF16_ARCHS = ("gemma3-1b", "mamba2-1.3b", "zamba2-7b", MOON)
BF16_CUT = 2  # layers of each config, as registered, in the card-vs-CPU part
BF16_CPU_STEPS = 8  # teacher-forced decode steps of the card-vs-CPU part
# bf16 logits, card against CPU: two devices sum in other orders, and a
# value that rounds the other way in bf16 moves by 2^-8 of itself, layer
# after layer: rel 2e-2 of max |logits| (of max |x| for zamba2's shared
# block).  zamba2-7b's first two layers are mamba layers; its shared block
# is held at its own output (`_bf16_shared_vs_cpu`), not at logits past a
# mamba layer: there bf16 summation order alone moves the logits by up to
# 3.5e-2 on one device (PERF.md §7, `python -m repro_torch.serve.bf16_drift`).
REL_TOL_BF16_CPU = 2e-2


def _bf16(gen: np.random.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    return _cuda(gen, shape, scale).to(torch.bfloat16)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp (8 bits of mantissa) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _attention_f64(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """Masked softmax attention in float64 from the (bf16) inputs."""
    g = q.shape[1] // k.shape[1]
    k, v = k.double().repeat_interleave(g, 1), v.double().repeat_interleave(g, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k) * q.shape[-1] ** -0.5
    sq, sk = q.shape[2], k.shape[2]
    qp = torch.arange(sq, device=DEV)[:, None]
    kp = torch.arange(sk, device=DEV)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=DEV)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= qp - kp < window
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~ok, float("-inf")), -1), nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


# the bf16 conv1d forward's TMA stream and its kernel's profiler key
CONV1D_FWD_BF16_SOURCE = "src/repro_torch/kernels/conv1d_fused/csrc/conv1d_fused_fwd_bf16.cu"
CONV1D_FWD_BF16_KEY = "conv1d_fwd_bf16"


def bf16_kernel_cases(gen) -> list:
    """The bf16 instantiations at the shapes the bf16 path gives them: each
    a dict of the kernel, a label, the kernel's and the plain version's
    call, the float64 result from the same bf16 inputs, the library
    yardstick (None where no single call computes the function) and the
    bound (bytes at 2 a value, operations at the bf16 tensor-core peak)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import conv1d_fused as conv1d_pkg
    from repro_torch.kernels import decode_mlp as decode_mlp_pkg
    from repro_torch.kernels import flash_attention as flash_pkg
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref
    from repro_torch.kernels.decode_mlp import decode_mlp, decode_mlp_ref
    from repro_torch.kernels.flash_attention import attention_ref, flash_forward

    cases = []
    # the served layers, then the forward at the bf16 backward's other
    # training layers (TRAIN_ATTN_LAYERS): MLA's (192, 128), the MTP
    # block's 56 and seamless's causal decoder self-attention
    for label, b, hq, hkv, sq, sk, hd, vd, causal, served in (
        ("gemma3 global B4 H4/1 S700 hd256 causal", 4, 4, 1, 700, 700, 256, 256, True, True),
        ("zamba2 B4 H32 S700 hd112 causal", 4, 32, 32, 700, 700, 112, 112, True, False),
        ("moonshot B4 H16 S700 hd128 causal", 4, 16, 16, 700, 700, 128, 128, True, False),
        ("seamless encoder B4 H16 S1024 hd64", 4, 16, 16, 1024, 1024, 64, 64, False, False),
        ("seamless cross B4 H16 Sq1 Sk1024 hd64", 4, 16, 16, 1, 1024, 64, 64, False, False),
        ("deepseek MLA B4 H128 S1024 hd192/128 causal", 4, 128, 128, 1024, 1024, 192, 128, True,
         False),
        ("deepseek MTP B4 H128 S1023 hd56 causal", 4, 128, 128, 1023, 1023, 56, 56, True, False),
        ("seamless decoder self B4 H16 S512 hd64 causal", 4, 16, 16, 512, 512, 64, 64, True,
         False),
    ):
        # the model's (B, S, H, hd), viewed as (B, H, S, hd)
        q = _bf16(gen, (b, sq, hq, hd)).transpose(1, 2)
        k = _bf16(gen, (b, sk, hkv, hd)).transpose(1, 2)
        v = _bf16(gen, (b, sk, hkv, vd)).transpose(1, 2)
        qc = q.contiguous()
        kr = k.repeat_interleave(hq // hkv, 1).contiguous()
        vr = v.repeat_interleave(hq // hkv, 1).contiguous()
        fc = flash_pkg.cost(b, hq, hkv, sq, sk, hd, vd, causal=causal, window=0, itemsize=2)
        cases.append(dict(
            kernel="flash_attention", label=label, served=served,
            run=lambda q=q, k=k, v=v, c=causal: flash_forward(q, k, v, causal=c),
            plain=lambda q=q, k=k, v=v, c=causal: attention_ref(q, k, v, causal=c),
            f64=lambda q=q, k=k, v=v, c=causal: _attention_f64(q, k, v, c, 0),
            library=lambda qc=qc, kr=kr, vr=vr, c=causal: F.scaled_dot_product_attention(
                qc, kr, vr, is_causal=c),
            library_note="SDPA bf16" + (", is_causal" if causal else ", no mask"),
            bound=_bound_of(fc, PEAK_BF16),
            device_key="flash_fwd",
        ))
    z = get_arch("zamba2-7b")
    for label, b, d, f, served in (
        ("gemma3 decode B4 d1152 f6912", 4, 1152, 6912, True),
        (f"zamba2 decode B2 d{z.d_model} f{z.d_ff}", 2, z.d_model, z.d_ff, False),
        ("seamless decode B1 d1024 f4096", 1, 1024, 4096, False),
    ):
        x = _bf16(gen, (b, d))
        w1, w3 = _bf16(gen, (d, f), d ** -0.5), _bf16(gen, (d, f), d ** -0.5)
        w2 = _bf16(gen, (f, d), f ** -0.5)

        def mlp64(x=x, w1=w1, w3=w3, w2=w2):
            x64 = x.double()
            return (F.silu(x64 @ w1.double()) * (x64 @ w3.double())) @ w2.double()

        rotated = None
        if served:  # the weights from HBM, as a served step over 26 layers reads them
            ws = [(w1, w3, w2)] + [
                (_bf16(gen, (d, f), d ** -0.5), _bf16(gen, (d, f), d ** -0.5),
                 _bf16(gen, (f, d), f ** -0.5)) for _ in range(DECODE_MLP_ROTATE - 1)]
            turn = itertools.count()

            def rotated(x=x, ws=ws, turn=turn):
                return decode_mlp(x, *ws[next(turn) % len(ws)])

        cases.append(dict(
            kernel="decode_mlp", label=label, served=served,
            run=lambda x=x, w1=w1, w3=w3, w2=w2: decode_mlp(x, w1, w3, w2),
            plain=lambda x=x, w1=w1, w3=w3, w2=w2: decode_mlp_ref(x, w1, w3, w2),
            f64=mlp64, library=None, library_note="no single call",
            bound=_bound_of(decode_mlp_pkg.cost(b, d, f, itemsize=2), PEAK_BF16),
            device_key="decode_mlp", rotated=rotated,
        ))
    # the served prefill waves, then mamba2's training forward (and remat)
    for arch, what, b, length, served in (("mamba2-1.3b", "wave1", 4, 768, True),
                                          ("zamba2-7b", "wave1", 4, 768, False),
                                          ("mamba2-1.3b", "wave2", 2, 129, False),
                                          ("mamba2-1.3b", "train", 4, 1024, False)):
        cfg = get_arch(arch)
        s_ = cfg.ssm
        d_inner = s_.expand * cfg.d_model
        d_xbc = d_inner + 2 * s_.n_groups * s_.d_state
        width = d_inner + d_xbc + d_inner // s_.head_dim
        k = s_.d_conv
        x = _bf16(gen, (b, length, width))[..., d_inner:d_inner + d_xbc]
        w, bias = _bf16(gen, (k, d_xbc), 0.5), _bf16(gen, (d_xbc,), 0.1)
        xt = x.transpose(1, 2).contiguous()
        wt = w.t().contiguous()[:, None, :]

        def conv64(x=x, w=w, bias=bias, k=k, length=length):
            xp = F.pad(x.double(), (0, 0, k - 1, 0))
            acc = sum(xp[:, i:i + length] * w[i].double() for i in range(k))
            return F.silu(acc + bias.double())

        cases.append(dict(
            kernel="conv1d_fused",
            label=f"{arch.split('-')[0]} {what} B{b} L{length} D{d_xbc} (slice of {width}) silu",
            served=served,
            run=lambda x=x, w=w, bias=bias: conv1d_fused(x, w, bias, activation="silu"),
            plain=lambda x=x, w=w, bias=bias: conv1d_ref(x, w, bias, activation="silu"),
            f64=conv64,
            library=lambda xt=xt, wt=wt, bias=bias, k=k, length=length: F.silu(F.conv1d(
                xt, wt, bias, padding=k - 1, groups=wt.shape[0])[..., :length]),
            library_note="grouped F.conv1d with bias, + F.silu, bf16",
            bound=_bound_of(conv1d_pkg.cost(b, length, d_xbc, k, itemsize=2), PEAK_BF16),
            device_key=CONV1D_FWD_BF16_KEY,
        ))
    return cases


def bf16_conv1d_every_k(smi: str) -> dict:
    """The bf16 conv1d forward at every K the stream takes (1..8), SiLU on
    and off, at a ragged length of a column slice (B 2, L 301, D 512 of
    1024 at column 256), and at L 1 and L 2 < K-1 (every row reads the
    causal pad): one launch a call, by `bf16_kernels`' rule against the
    plain version and float64, bitwise the same twice.  Returns the worst
    error against the plain version and the number of cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref
    from repro_torch.kernels.conv1d_fused import kernel as conv_kernel

    gen = np.random.default_rng(31)
    cases = [(k, act, 2, 301, 1024, 256, 512) for k in range(1, 9) for act in ("silu", "none")]
    cases += [(4, "silu", 1, 1, 64, 8, 48), (8, "none", 2, 2, 1024, 256, 512)]
    worst = 0.0
    for k, act, b, length, row, col, d in cases:
        x = _bf16(gen, (b, length, row))[..., col:col + d]
        w, bias = _bf16(gen, (k, d), 0.5), _bf16(gen, (d,), 0.1)
        n0 = conv_kernel.LAUNCHES
        y1 = conv1d_fused(x, w, bias, activation=act)
        n = conv_kernel.LAUNCHES - n0
        y2, ref = conv1d_fused(x, w, bias, activation=act), conv1d_ref(x, w, bias, activation=act)
        acc = sum(F.pad(x.double(), (0, 0, k - 1, 0))[:, i:i + length] * w[i].double()
                  for i in range(k)) + bias.double()
        f64 = F.silu(acc) if act == "silu" else acc
        torch.cuda.synchronize()
        err_k = float((y1.double() - f64).abs().max())
        err_p = float((ref.double() - f64).abs().max())
        ulp = bf16_ulp(max(float(f64.abs().max()), 2.0 ** -126))
        abs_kp = float((y1.double() - ref.double()).abs().max())
        worst = max(worst, abs_kp)
        if not (n == 1 and err_k <= 2 * err_p + ulp and torch.equal(y1, y2)):
            raise AssertionError(f"bf16 conv1d K {k} {act} B{b} L{length} D{d}: launches {n}, "
                                 f"err {err_k:.3e} vs plain {err_p:.3e} + ulp {ulp:.3e}, "
                                 f"bitwise twice {torch.equal(y1, y2)}")
    print(f"bf16 conv1d_fused every K 1..8 x SiLU on / off at B2 L301 D512 (slice of 1024 at "
          f"256), L 1 and L 2: {len(cases)} cases, one launch each, within 2x plain + 1 ulp of "
          f"float64, bitwise twice; worst kernel vs plain {worst:.3e}; card {smi}")
    return dict(cases=len(cases), max_abs_err=worst)


def bf16_kernels(smi: str) -> dict:
    """Each bf16 instantiation against its plain version on the same bf16
    inputs and both against float64 from those inputs: the kernel's max
    error at most twice the plain version's plus one bf16 ulp of max |out|,
    the output bitwise the same twice; then its time (CUDA events; device
    time by the profiler at the served shape), the plain version's, the
    library's and the bound.  Returns, per kernel, the served row and the
    worst errors."""
    gen = np.random.default_rng(17)
    rows = {}
    for c in bf16_kernel_cases(gen):
        y1, y2, ref = c["run"](), c["run"](), c["plain"]()
        f64 = c["f64"]()
        torch.cuda.synchronize()
        if (y1.dtype != torch.bfloat16 or y1.shape != ref.shape or y1.shape != f64.shape
                or not torch.isfinite(y1).all()):
            raise AssertionError(f"bf16 {c['label']}: bad output {y1.dtype} {tuple(y1.shape)}")
        err_k = float((y1.double() - f64).abs().max())
        err_p = float((ref.double() - f64).abs().max())
        ulp = bf16_ulp(float(f64.abs().max()))
        twice = bool(torch.equal(y1, y2))
        abs_kp = float((y1.double() - ref.double()).abs().max())
        del y1, y2, ref, f64
        k_ms, p_ms = time_ms(c["run"]), time_ms(c["plain"], reps=5)
        l_ms, l_note = None, c["library_note"]
        if c["library"] is not None:
            try:
                l_ms = time_ms(c["library"])
            except RuntimeError as e:  # a shape the library refuses: the row says so
                l_note += f" (refused: {str(e).splitlines()[0][:100]})"
        d_ms = device_ms(c["run"], c["device_key"])
        r_ms = r_dev = None
        if c.get("rotated") is not None:
            r_ms = time_ms(c["rotated"])
            r_dev = device_ms(c["rotated"], c["device_key"])
        b_ms, b_by = c["bound"]
        lib = f"{l_ms:.4f} ms" if l_ms is not None else "-"
        dev = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
        rot = "" if r_ms is None else (
            f"; weights rotated over {DECODE_MLP_ROTATE} copies {r_ms:.4f} ms (device "
            f"{'not measured' if r_dev is None else f'{r_dev:.4f} ms'})")
        print(f"bf16 {c['kernel']:15s} {c['label']:42s} err vs f64 kernel {err_k:.3e} plain "
              f"{err_p:.3e} (limit {2 * err_p + ulp:.3e}: 2x plain + 1 ulp {ulp:.3e}); "
              f"kernel vs plain {abs_kp:.3e}; bitwise twice {twice}; kernel {k_ms:.4f} ms "
              f"(device {dev}){rot}  plain {p_ms:.4f} ms  library {lib} ({l_note})  "
              f"bound {b_ms:.4f} ms ({b_by}); card {smi}")
        if not (err_k <= 2 * err_p + ulp and twice):
            raise AssertionError(f"bf16 {c['label']}: kernel err {err_k:.3e} vs plain "
                                 f"{err_p:.3e} + ulp {ulp:.3e}, bitwise twice {twice}")
        row = dict(shape=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
                   library_note=l_note, bound_ms=b_ms, bound_by=b_by,
                   max_abs_err_vs_f64=err_k, plain_max_abs_err_vs_f64=err_p,
                   max_abs_err=abs_kp)
        if r_ms is not None:
            row.update(rotated_ms=r_ms, rotated_device_ms=r_dev,
                       rotated_copies=DECODE_MLP_ROTATE)
        r = rows.setdefault(c["kernel"], dict(shapes=[], max_abs_err=0.0))
        r["shapes"].append(row)
        r["max_abs_err"] = max(r["max_abs_err"], abs_kp)
        if c["served"]:
            r["served"] = row
    print(f"bf16 kernels: card {smi}")
    return rows


def _bf16_want(specs, waves: int, steps: int) -> dict:
    """Each kernel's launches on a served run: flash a wave per attention
    layer (shared invocations included), the decode MLP a step per dense
    MLP, conv1d a wave per mamba layer, the rest none."""
    return {
        "flash_attention": sum(s.mixer in ("attn", "shared_attn") for s in specs) * waves,
        "decode_mlp": sum(s.has_mlp and not s.moe for s in specs) * steps,
        "conv1d_fused": sum(s.mixer == "mamba" for s in specs) * waves,
        "fused_tile": 0, "flash_attention_bwd": 0, "conv1d_fused_bwd": 0,
    }


def bf16_serve(name: str, fp32: dict, smi: str) -> dict:
    """`name` at full size in bf16 as registered (`init_lm(get_arch(name),
    seed=0)`, no dtype override) through `Engine`: phase 6's six requests,
    max_batch 4, 16 new tokens; every count zeroed before the run and held
    after (`_bf16_want`); peak memory from before the init; then wave 1's
    warm prefill by CUDA events and profiled, and a decode step profiled
    (wall and device busy), each beside the fp32 phase's figure (`fp32`:
    its peak and its waves' host times)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm, lm_decode_step, lm_prefill
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_arch(name)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{name} is registered in {cfg.dtype}, not bf16")
    mods = kernel_libraries()
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    dtypes = sorted({str(p.dtype).removeprefix("torch.") for p in model.parameters()})
    print(f"bf16 model {name}: {cfg.n_layers} layers (all), d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B params ({dtypes}), init {time.perf_counter() - t0:.2f} s")
    reqs = lm_requests(cfg, LM_PROMPTS)
    engine = Engine(model, ServeConfig(max_batch=MAX_BATCH, max_len=LM_MAX_LEN))
    for mod in mods.values():
        mod.LAUNCHES = 0  # main path: count only the served run
    t0 = time.perf_counter()
    out = engine.run(reqs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        toks = out[r.rid]
        if len(toks) != LM_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"bf16 {name} rid {r.rid}: bad tokens {toks}")
    waves, steps = len(engine.waves), sum(w["decode_steps"] for w in engine.waves)
    want = _bf16_want(model.specs, waves, steps)
    n_tok = sum(w["tokens"] for w in engine.waves)
    for i, (w, w32) in enumerate(zip(engine.waves, fp32["wave_stats"])):
        print(f"  wave {i}: {w['size']} requests, prompt {w['prompt_len']} tokens, prefill "
              f"{w['prefill_s'] * 1e3:.2f} ms (fp32 {w32['prefill_s'] * 1e3:.2f}), decode "
              f"{w['decode_s'] / max(w['decode_steps'], 1) * 1e3:.3f} ms/step (fp32 "
              f"{w32['decode_s'] / max(w32['decode_steps'], 1) * 1e3:.3f}) over "
              f"{w['decode_steps']} steps (host clock, the first calls' allocations included)")
    print(f"  {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s); "
          f"peak max_memory_allocated {peak / 2**30:.2f} GiB (fp32 {fp32['peak_bytes'] / 2**30:.2f}"
          f" GiB{fp32.get('note', '')}); launches {launches} (want {want})")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"bf16 {name}: {k} launched {launches[k]} times, expected {n}")
    wave1 = lm_requests(cfg, LM_PROMPTS[:MAX_BATCH])
    plen = max(len(r.prompt) for r in wave1)
    toks = np.zeros((len(wave1), plen), np.int64)
    for i, r in enumerate(wave1):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).to(DEV)
    with torch.inference_mode():
        prefill_ms = time_ms(lambda: lm_prefill(model, toks, LM_MAX_LEN), reps=3)
        _, state = lm_prefill(model, toks, LM_MAX_LEN)
        tok = toks[:, -1]
        prof_p = profile_call(f"bf16 {name}", f"prefill B{len(wave1)} S{plen}",
                              lambda: lm_prefill(model, toks, LM_MAX_LEN))
        prof_d = profile_call(f"bf16 {name}", f"decode step B{len(wave1)}",
                              lambda: lm_decode_step(model, tok, plen, state))
    del state
    print(f"  warm wave-1 prefill {prefill_ms:.3f} ms (CUDA events, median of 3); decode step "
          f"wall {prof_d['wall_ms']:.3f} ms, device busy "
          f"{'not measured' if prof_d['busy_ms'] is None else '%.3f ms' % prof_d['busy_ms']}; "
          f"card {smi}")
    return dict(model=model, cfg=cfg, launches=launches, waves=waves, steps=steps,
                n_params=n_params, peak_bytes=peak, prefill_ms=prefill_ms,
                prefill_busy_ms=prof_p["busy_ms"], decode_wall_ms=prof_d["wall_ms"],
                decode_busy_ms=prof_d["busy_ms"], wave_stats=engine.waves)


def _bf16_wave(cfg):
    """One wave of prompts 600 and 40 (seed 1), left-padded to 600."""
    reqs = lm_requests(cfg, (600, 40), seed=1)
    toks = np.zeros((2, 600), np.int64)
    for i, r in enumerate(reqs):
        toks[i, 600 - len(r.prompt):] = r.prompt
    return toks


def _rel_steps(card: torch.Tensor, host: torch.Tensor) -> list:
    """Per call (prefill, then each step): max |card - host| over max |host|
    of that call."""
    return [float((c - h).abs().max() / h.abs().max()) for c, h in zip(card, host)]


def bf16_vs_cpu(name: str, model) -> dict:
    """The served bf16 weights cut to the config's first BF16_CUT layers,
    on the card against the port's bf16 CPU run: one wave of prompts 600
    and 40, the prefill and BF16_CPU_STEPS teacher-forced decode steps,
    logits within REL_TOL_BF16_CPU of max |logits|.  The greedy tokens'
    agreement is printed (a near-tie may round either way in bf16).  A
    model with a shared block (zamba2) also holds that block's output
    (`_bf16_shared_vs_cpu`)."""
    cut = _cut(model, BF16_CUT)
    cpu = _cpu_copy(cut)
    toks = _bf16_wave(cut.cfg)
    t0 = time.perf_counter()
    card, fed = _logits_run(cut, toks, BF16_CPU_STEPS)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, _ = _logits_run(cpu, toks, BF16_CPU_STEPS, forced=fed)
    t_cpu = time.perf_counter() - t0
    if not (torch.isfinite(card).all() and torch.isfinite(host).all()):
        raise AssertionError(f"bf16 {name}: non-finite logits")
    scale = float(host.abs().max())
    errs = [float((card[i] - host[i]).abs().max()) / scale for i in range(len(card))]
    same = float((card.argmax(-1) == host.argmax(-1)).float().mean())
    print(f"bf16 card-vs-cpu {name} cut to {len(cut.specs)} layers "
          f"({'/'.join(s.mixer for s in cut.specs)}), prompts (600, 40) + {BF16_CPU_STEPS} "
          f"teacher-forced steps: prefill rel err {errs[0]:.3e}, decode max {max(errs[1:]):.3e} "
          f"(tol {REL_TOL_BF16_CPU:g}); greedy tokens equal {same:.3f}; card {t_card:.2f} s, "
          f"cpu {t_cpu:.2f} s")
    if not max(errs) <= REL_TOL_BF16_CPU:
        raise AssertionError(f"bf16 {name}: card vs cpu rel err {max(errs):.3e}")
    out = dict(prefill_rel=errs[0], decode_rel=max(errs[1:]), greedy_equal=same,
               rule=f"rel {REL_TOL_BF16_CPU:g}")
    if model.cfg.shared_attn_period:
        out["shared_block"] = _bf16_shared_vs_cpu(name, model)
    return out


def _bf16_shared_vs_cpu(name: str, model) -> dict:
    """zamba2's shared block in bf16, card against CPU: the served weights
    cut to one mamba layer with the shared block before it (shared period
    1), the same wave and steps.  The block's output -- the cut's first
    layer, before any mamba layer: flash at hd 112 in the prefill, the
    cache pass and the decode MLP in each step, the LoRA deltas -- within
    REL_TOL_BF16_CPU of its max |x| on the CPU, at the prefill and every
    step.  The cut's logits, past the mamba layer, are printed, not held
    (REL_TOL_BF16_CPU's note)."""
    from repro_torch.serve.bf16_drift import recording

    cut = _cut(model, 1, shared_attn_period=1)
    if cut.specs[0].mixer != "shared_attn":
        raise AssertionError(f"bf16 {name}: the cut starts with {cut.specs[0].mixer}")
    cpu = _cpu_copy(cut)
    toks = _bf16_wave(cut.cfg)
    rec_card, rec_cpu = [], []
    with recording(rec_card):
        card, fed = _logits_run(cut, toks, BF16_CPU_STEPS)
    with recording(rec_cpu):
        host, _ = _logits_run(cpu, toks, BF16_CPU_STEPS, forced=fed)
    n = len(cut.specs)
    errs = _rel_steps(rec_card[0::n], rec_cpu[0::n])
    logits = _rel_steps(card, host)
    print(f"bf16 card-vs-cpu {name} shared block (cut "
          f"{'/'.join(s.mixer for s in cut.specs)}): its output's rel err at the prefill "
          f"{errs[0]:.3e}, decode max {max(errs[1:]):.3e} (tol {REL_TOL_BF16_CPU:g} of max |x|); "
          f"the cut's logits past the mamba layer, not held: prefill {logits[0]:.3e}, decode "
          f"max {max(logits[1:]):.3e}")
    if not max(errs) <= REL_TOL_BF16_CPU:
        raise AssertionError(f"bf16 {name}: shared block card vs cpu rel err {max(errs):.3e}")
    return dict(prefill_rel=errs[0], decode_rel=max(errs[1:]), logits_prefill_rel=logits[0],
                logits_decode_rel=max(logits[1:]))


def phase_bf16(smi: str, fp32: dict) -> dict:
    """Phase 17 (module docstring): serve the registered configs in bf16.
    `fp32` maps each model to its fp32 phase's peak and waves."""
    t_phase = time.perf_counter()
    # the caller's cuBLAS setting is left as a user's would be (PyTorch's
    # default allows bf16 reduced-precision reductions): the served entry
    # points sum bf16 products in f32 themselves (`f32_accumulation`)
    print(f"bf16: torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction} (the caller's)")
    gc_collect()
    left = torch.cuda.memory_allocated()
    print(f"bf16: {left / 2**30:.3f} GiB still allocated on the card by earlier phases "
          f"(limit {RESIDUAL_LIMIT / 2**30:g})")
    if left >= RESIDUAL_LIMIT:
        raise AssertionError(f"{left} bytes left allocated before the bf16 phase")
    t0 = time.perf_counter()
    kernels = bf16_kernels(smi)
    kernels["conv1d_fused"]["every_k"] = bf16_conv1d_every_k(smi)
    print(f"bf16: kernels {time.perf_counter() - t0:.2f} s")
    served, cpu = {}, {}
    for name in BF16_ARCHS:
        t0 = time.perf_counter()
        s = bf16_serve(name, fp32[name], smi)
        t1 = time.perf_counter()
        cpu[name] = bf16_vs_cpu(name, s.pop("model"))
        served[name] = s
        gc_collect()
        print(f"bf16: {name} served in {t1 - t0:.2f} s, cut against the CPU in "
              f"{time.perf_counter() - t1:.2f} s")
    print(f"bf16: phase wall time {time.perf_counter() - t_phase:.2f} s")
    return dict(kernels=kernels, serve=served, cpu=cpu)


# ------------------------------------------------------------ phase 18

BF16_TRAIN = (("gemma3-1b", TRAIN_ARGS), ("mamba2-1.3b", MAMBA_TRAIN_ARGS))
BF16_TRAIN_CUT = 2  # each config's first layers in the card-vs-CPU part
# the CPU tests' tolerances (tests/test_torch_train_bf16_archs.py)
REL_TOL_BF16_TRAIN_LOSS = 1e-2
REL_TOL_BF16_TRAIN_GRAD = 2e-2
# the fp32 steps of record, wall ms of a warm step (PERF.md §5), printed
# beside this run's
FP32_STEP_OF_RECORD = {"gemma3-1b": "806-820", "mamba2-1.3b": "1,861.5"}


def _bwd_f64(q, k, v, do, causal: bool, window: int):
    """dq, dk, dv of masked softmax attention in float64 from the (bf16)
    inputs: P exact, no rounding anywhere."""
    from repro_torch.kernels.flash_attention.ref import band_mask

    q, k, v, do = (t.double() for t in (q, k, v, do))
    b, hq, sq, hd = q.shape
    hkv, sk, vd = k.shape[1], k.shape[2], v.shape[3]
    g, scale = hq // hkv, hd ** -0.5
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    ok = band_mask(sq, sk, causal=causal, window=window, device=q.device)
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~ok, float("-inf")), -1), nan=0.0)
    del s
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do).reshape(b, hkv, g, sk, vd).sum(2)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vv) - (do * o).sum(-1, keepdim=True))
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = (torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale).reshape(b, hkv, g, sk, hd).sum(2)
    return dq, dk, dv


def bf16_bwd_cases(gen) -> list:
    """The bf16 backward instantiations at the shapes bf16 training gives
    them and at edge cases: each a dict of the kernel, a label, whether it
    is timed, the kernel's and the plain version's call (both return a
    tuple of gradients), the float64 gradients, the library yardstick and
    the bound (bytes at 2 a value)."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv1d_fused import backward as conv_backward
    from repro_torch.kernels.conv1d_fused import conv1d_bwd_ref
    from repro_torch.kernels.flash_attention import backward as bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    from repro_torch.kernels.flash_attention.ref import band_mask

    layers = [(label, shape, causal, window, True)
              for label, shape, causal, window in TRAIN_ATTN_LAYERS]
    for hd, vd in HEAD_DIMS:
        for hkv in (4, 1):
            layers.append((f"hd{hd}/{vd} g{4 // hkv} B2 S300 causal w100",
                           (2, 4, hkv, 300, 300, hd, vd), True, 100, False))
    layers += [("non-causal Sq77 Sk256 hd128 g2", (1, 2, 1, 77, 256, 128, 128), False, 0, False),
               ("rows that see no key Sq200 Sk50 w40 hd64 g2", (1, 2, 1, 200, 50, 64, 64), True,
                40, False)]
    cases = []
    for label, (b, hq, hkv, sq, sk, hd, vd), causal, window, timed in layers:
        # the model's (B, S, H, hd), viewed as (B, H, S, hd)
        q = _bf16(gen, (b, sq, hq, hd)).transpose(1, 2)
        k = _bf16(gen, (b, sk, hkv, hd)).transpose(1, 2)
        v = _bf16(gen, (b, sk, hkv, vd)).transpose(1, 2)
        do = _bf16(gen, (b, sq, hq, vd)).transpose(1, 2)
        kw = dict(causal=causal, window=window)
        o, lse = flash_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
        bc = bwd_kernel.cost(b, hq, hkv, sq, sk, hd, vd, causal=causal, window=window,
                             itemsize=2)

        def library(q=q, k=k, v=v, do=do, kw=kw, g=hq // hkv):
            qc = q.detach().contiguous().requires_grad_(True)
            kr = k.repeat_interleave(g, 1).contiguous().requires_grad_(True)
            vr = v.repeat_interleave(g, 1).contiguous().requires_grad_(True)
            mask = (None if kw["window"] == 0 else
                    band_mask(qc.shape[2], kr.shape[2], device=DEV, **kw))
            out = F.scaled_dot_product_attention(
                qc, kr, vr, attn_mask=mask, is_causal=kw["causal"] and mask is None)
            return lambda: torch.autograd.grad(out, (qc, kr, vr), do, retain_graph=True)

        cases.append(dict(
            kernel="flash_attention_bwd", label=label, timed=timed, names=("dq", "dk", "dv"),
            run=lambda q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw:
                bwd_kernel.flash_attention_bwd_call(q, k, v, o, lse, do, **kw),
            plain=lambda q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw:
                flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
            f64=lambda q=q, k=k, v=v, do=do, kw=kw: _bwd_f64(q, k, v, do, **kw),
            library=library, library_note="SDPA bf16 backward" + (
                ", boolean band mask" if window else ", is_causal" if causal else ", no mask")
            + (", kv heads repeated" if hq != hkv else ""),
            bound=_bound_of(bc, PEAK_BF16), device_key="flash_bwd"))
    for label, b, length, row, col, d, k in _conv1d_train_shapes():
        wide = _bf16(gen, (b, length, row))
        x = wide[..., col:col + d]
        w, bias = _bf16(gen, (k, d), 0.5), _bf16(gen, (d,), 0.1)
        g = _bf16(gen, (b, length, d))

        def conv_f64(x=x, w=w, bias=bias, g=g, k=k, length=length):
            x64, w64, b64 = (t.double().requires_grad_(True) for t in (x, w, bias))
            xp = F.pad(x64, (0, 0, k - 1, 0))
            y = F.silu(sum(xp[:, i:i + length] * w64[i] for i in range(k)) + b64)
            return torch.autograd.grad(y, (x64, w64, b64), g.double())

        def library(x=x, w=w, bias=bias, g=g, k=k, d=d, length=length):
            xt = x.transpose(1, 2).contiguous().requires_grad_(True)
            wt = w.t().contiguous()[:, None, :].requires_grad_(True)
            bt = bias.clone().requires_grad_(True)
            y = F.silu(F.conv1d(xt, wt, bt, padding=k - 1, groups=d)[..., :length])
            gt = g.transpose(1, 2).contiguous()
            return lambda: torch.autograd.grad(y, (xt, wt, bt), gt, retain_graph=True)

        cases.append(dict(
            kernel="conv1d_fused_bwd", label=label, timed=label.startswith(("mamba2", "zamba2")),
            names=("dx", "dw", "db"),
            run=lambda x=x, w=w, bias=bias, g=g: conv_backward.conv1d_fused_bwd_call(
                x, w, bias, g, activation="silu"),
            plain=lambda x=x, w=w, bias=bias, g=g: conv1d_bwd_ref(g, x, w, bias),
            f64=conv_f64, library=library,
            library_note="autograd of grouped F.conv1d + bias + F.silu, bf16, (B, D, L) layout",
            bound=_bound_of(conv_backward.cost(b, length, d, k, itemsize=2)),
            device_key="conv1d_bwd"))
    return cases


def bf16_backward_kernels(smi: str) -> dict:
    """Part (a): each bf16 backward against its plain version on the same
    bf16 inputs and both against float64: every gradient's max error at
    most twice the plain version's plus one bf16 ulp of its max |grad|,
    and bitwise the same twice; then, at the training shapes, the times
    (events; device time), the plain version's, the library's and the
    bound.  Returns, per kernel, the timed rows (the first is the served
    row) and the worst kernel-vs-plain error."""
    gen = np.random.default_rng(26)
    rows = {}
    for c in bf16_bwd_cases(gen):
        g1, g2, ref, f64 = c["run"](), c["run"](), c["plain"](), c["f64"]()
        torch.cuda.synchronize()
        errs, ok = [], True
        for name, a, p, e in zip(c["names"], g1, ref, f64):
            if a.dtype != torch.bfloat16 or a.shape != e.shape or not torch.isfinite(a).all():
                raise AssertionError(f"bf16 {c['label']}: bad {name} {a.dtype} {tuple(a.shape)}")
            err_k = float((a.double() - e).abs().max())
            err_p = float((p.double() - e).abs().max())
            ulp = bf16_ulp(float(e.abs().max()))
            ok &= err_k <= 2 * err_p + ulp
            errs.append((name, err_k, err_p, ulp, float((a.double() - p.double()).abs().max())))
        twice = all(torch.equal(a, b) for a, b in zip(g1, g2))
        del g1, g2, ref, f64
        print(f"bf16 {c['kernel']:19s} {c['label']:52s} err vs f64 kernel / plain (limit 2x "
              f"plain + 1 ulp): " + "; ".join(
                  f"{n} {k:.3e} / {p:.3e} ({2 * p + u:.3e})" for n, k, p, u, _ in errs)
              + f"; bitwise twice {twice}")
        if not (ok and twice):
            raise AssertionError(f"bf16 {c['label']}: backward kernel vs plain failed")
        r = rows.setdefault(c["kernel"], dict(shapes=[], max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], *(e[4] for e in errs))
        if not c["timed"]:
            continue
        k_ms, p_ms = time_ms(c["run"], reps=10), time_ms(c["plain"], reps=3)
        d_ms = device_ms(c["run"], c["device_key"], reps=10)
        l_ms, l_note = None, c["library_note"]
        try:
            l_ms = time_ms(c["library"](), reps=10)
        except RuntimeError as e:  # a shape the library refuses: the row says so
            l_note += f" (refused: {str(e).splitlines()[0][:100]})"
        gc_collect()
        b_ms, b_by = c["bound"]
        dev = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
        lib = "-" if l_ms is None else f"{l_ms:.4f} ms"
        print(f"time bf16 {c['kernel']:19s} {c['label']:52s} kernel {k_ms:.4f} ms (device "
              f"{dev})  plain {p_ms:.4f} ms  library {lib} ({l_note})  bound {b_ms:.4f} ms "
              f"({b_by}); card {smi}")
        r["shapes"].append(dict(shape=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                                library_ms=l_ms, library_note=l_note, bound_ms=b_ms,
                                bound_by=b_by, max_abs_err_vs_f64=max(e[1] for e in errs),
                                plain_max_abs_err_vs_f64=max(e[2] for e in errs)))
    return rows


def bf16_train_card_vs_cpu(name: str, cfg, s: int) -> dict:
    """Part (c): `cfg` (a depth cut at full width, bf16), seed 0, B 1, S
    `s`: `lm_loss` and every gradient on the card and on the CPU, each
    under `f32_accumulation` as the train step runs them.  The loss within
    REL_TOL_BF16_TRAIN_LOSS, every leaf within REL_TOL_BF16_TRAIN_GRAD of
    its max |grad|, or, for a leaf past it, within the CPU's own distance
    from the f32 gradient of the same weights plus REL_TOL_BF16_TRAIN_GRAD
    (summation order: the CPU tests' rule)."""
    import copy
    import dataclasses

    from repro_torch.models import init_lm, lm_loss
    from repro_torch.models.common import f32_accumulation

    card = init_lm(cfg, seed=0, device=DEV)
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s + 1)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def grads(model):
        model.requires_grad_(True)
        t0 = time.perf_counter()
        dev = model.device
        with f32_accumulation():
            loss, _ = lm_loss(model, {k: t.to(dev) for k, t in batch.items()})
            gs = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        return float(loss.detach()), [g.cpu() for g in gs], time.perf_counter() - t0

    (l_card, g_card, t_card), (l_cpu, g_cpu, t_cpu) = grads(card), grads(cpu)
    names = [n for n, _ in card.named_parameters()]
    del card
    gc_collect()
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    errs = {n: rel_err(a.float(), b.float()) for n, a, b in zip(names, g_card, g_cpu)}
    past = [n for n, e in errs.items() if not e < REL_TOL_BF16_TRAIN_GRAD]
    own = {}
    if past:  # the CPU's bf16 gradient against its f32 one of the same weights
        f32 = init_lm(dataclasses.replace(cfg, dtype="float32"), seed=0, device="cpu")
        f32.load_state_dict({k: v.float() for k, v in cpu.state_dict().items()})
        _, g32, _ = grads(f32)
        g32 = dict(zip(names, g32))
        own = {n: rel_err(g_cpu[names.index(n)].float(), g32[n]) for n in past}
        del f32, g32
    worst = max(errs, key=errs.get)
    print(f"bf16 train card-vs-cpu {name} cut to {cfg.n_layers} layers, B1 S{s}: loss "
          f"{l_card:.6f} vs {l_cpu:.6f} rel {loss_rel:.3e} (tol {REL_TOL_BF16_TRAIN_LOSS:g}); "
          f"{len(errs)} gradient leaves, worst rel {errs[worst]:.3e} at {worst} (tol "
          f"{REL_TOL_BF16_TRAIN_GRAD:g}); past it: "
          + (", ".join(f"{n} {errs[n]:.3e} (the CPU's bf16 vs f32 {own[n]:.3e}, limit "
                       f"{own[n] + REL_TOL_BF16_TRAIN_GRAD:.3e})" for n in past) or "none")
          + f"; card {t_card:.2f} s, cpu {t_cpu:.2f} s")
    if not (loss_rel < REL_TOL_BF16_TRAIN_LOSS
            and all(errs[n] <= own[n] + REL_TOL_BF16_TRAIN_GRAD for n in past)):
        raise AssertionError(f"bf16 train: {name} card vs cpu out of tolerance")
    return dict(loss_rel=loss_rel, worst=(worst, errs[worst]),
                past={n: (errs[n], own[n]) for n in past})


def phase_bf16_train(smi: str, fp32: dict) -> dict:
    """Phase 18 (module docstring): the bf16 backward kernels against their
    plain versions, gemma3-1b and mamba2-1.3b trained in bf16 through
    `launch.train.main`, and their 2-layer cuts card against CPU.  `fp32`
    maps each model to this run's fp32 history (phase 13)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.models.common import f32_accumulation

    def batch_losses(model, batches) -> list:
        with torch.no_grad(), f32_accumulation():
            return [float(lm_loss(model, bt)[0]) for bt in batches]

    t_phase = time.perf_counter()
    gc_collect()
    left = torch.cuda.memory_allocated()
    print(f"bf16 train: {left / 2**30:.3f} GiB still allocated on the card by earlier phases "
          f"(limit {RESIDUAL_LIMIT / 2**30:g})")
    if left >= RESIDUAL_LIMIT:
        raise AssertionError(f"{left} bytes left allocated before the bf16 training phase")
    t0 = time.perf_counter()
    kernels = bf16_backward_kernels(smi)
    gc_collect()
    print(f"bf16 train: backward kernels {time.perf_counter() - t0:.2f} s")
    runs = {}
    for name, args in BF16_TRAIN:
        t0 = time.perf_counter()
        cfg = get_arch(name)
        if cfg.dtype != "bfloat16":
            raise AssertionError(f"{name} is registered in {cfg.dtype}, not bf16")
        # the steps' six batches, scored at init (the run's weights: seed 0)
        # and after the steps
        batches = [{k: torch.as_tensor(v).to(DEV, dtype=torch.long if k in ("tokens", "targets")
                                              else None)
                    for k, v in stream_batch(cfg, i).items()} for i in range(TRAIN_STEPS)]
        init = init_lm(cfg, seed=0, device=DEV)
        at_init = batch_losses(init, batches)
        del init
        gc_collect()
        run = train_run(f"{name} bf16", lambda args=args: launch_train.main(args), smi)
        hist = run["history"]
        model = run["state"]["params"]
        # the loss falls: the six batches' mean loss after the steps
        # against at init.  Batch 0's alone is printed, not held: it flips
        # on rounding (mamba2's moved 9.10-11.37 over dw sums one rounding
        # apart, `kernels/conv1d_fused/bwd_choices.py`), where the mean fell
        # in every such run
        after = batch_losses(model, batches)
        mean_init, mean_after = statistics.fmean(at_init), statistics.fmean(after)
        print(f"bf16 train {name}: the {len(batches)} batches' mean loss {mean_init:.6f} at "
              f"init, {mean_after:.6f} after {len(hist)} steps; batch 0's {hist[0]['loss']:.6f} "
              f"at step 0, {after[0]:.6f} after")
        if not (all(map(math.isfinite, after)) and mean_after < mean_init):
            raise AssertionError(f"bf16 train {name}: the loss did not fall over the steps")
        run.update(loss_batch0_after=after[0], loss_mean_at_init=mean_init,
                   loss_mean_after=mean_after)
        if {p.dtype for p in model.parameters()} - {torch.bfloat16, torch.float32} or not any(
                p.dtype == torch.bfloat16 for p in model.parameters()):
            raise AssertionError(f"bf16 train {name}: the parameters are not bf16")
        warm = statistics.median(h["seconds"] * 1e3 for h in hist[1:])
        ref = fp32.get(name)
        this = ("" if ref is None else
                f"this run's fp32 {ref['label']} {statistics.median(h['seconds'] * 1e3 for h in ref['history'][1:]):.1f} ms, ")
        print(f"bf16 train {name}: warm step median {warm:.1f} ms over steps 1-5 ({this}fp32 "
              f"step of record {FP32_STEP_OF_RECORD[name]} ms, PERF.md); peak "
              f"{run['peak_bytes'] / 2**30:.2f} GiB; loss {hist[0]['loss']:.6f} -> "
              f"{hist[-1]['loss']:.6f}")
        keys = ((("flash_fwd", ""), ("flash_bwd", "delta")) if name == "gemma3-1b" else
                ((CONV1D_FWD_BF16_KEY, ""), ("conv1d_bwd", "reduce")))
        run["profile"] = train_profile(run.pop("state"), cfg, keys=keys)
        run["warm_ms"] = warm
        del model
        gc_collect()
        s = TRAIN_CUT_S if name == "gemma3-1b" else TRAIN_CUT_SSM_S
        run["cpu"] = bf16_train_card_vs_cpu(
            name, dataclasses.replace(cfg, n_layers=BF16_TRAIN_CUT), s)
        gc_collect()
        runs[name] = run
        print(f"bf16 train: {name} in {time.perf_counter() - t0:.2f} s")
    print(f"bf16 train: phase wall time {time.perf_counter() - t_phase:.2f} s")
    return dict(kernels=kernels, runs=runs)


# ----------------------------------------------------------------- phase 19

PHASE19_LIMIT_S = 60.0
PHASE19_TRACE = os.path.join(ROOT, "build", "chip_smoke_serve.trace.json")
PHASE19_ONLINE_TRACE = os.path.join(ROOT, "build", "chip_smoke_example_online.trace.json")
PHASE19_CKPT = os.path.join(ROOT, "build", "chip_smoke_train_lm")
# the dry run's kernel names against the card's counters
DRYRUN_KERNELS = ("flash_attention", "flash_attention_bwd", "conv1d_fused", "conv1d_fused_bwd")


def _bf16_within(card: np.ndarray, host: np.ndarray) -> tuple:
    """(every element within one bf16 ulp of `host`, overall rel)."""
    card, host = card.astype(np.float64), host.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(host), 2.0 ** -126))) - 7)
    diff = np.abs(card - host)
    return bool((diff <= ulp).all()), float(diff.max() / (np.abs(host).max() + 1e-30))


def bf16_convnet_wave(smi: str) -> dict:
    """Phase 19 (a): vgg_mixed_channel's first wave in fp32 and bf16 on the
    card and in bf16 on the CPU, on the H100 model's plan."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import ConvServeConfig, ConvServer, Engine, ImageRequest, init_weights
    from repro_torch.core import analysis
    from repro_torch.kernels.fused_tile import kernel as tile_kernel

    spec = vgg_mixed_channel(3)
    ws = init_weights(spec, seed=0)
    gen = np.random.default_rng(19)
    imgs = [(gen.standard_normal((s, s, 3)) * 0.5).astype(np.float32) for s in (64, 64, 32, 64)]
    runs = {}
    for label, dtype, device in (("fp32 card", torch.float32, "cuda"),
                                 ("bf16 card", torch.bfloat16, "cuda"),
                                 ("bf16 cpu", torch.bfloat16, "cpu")):
        net = Engine(hw=analysis.H100_SXM, dtype=dtype, device=device).compile(
            spec, ws, input_hw=(64, 64))
        srv = ConvServer(net, ConvServeConfig(max_batch=4, buckets=(32, 64)))
        tile_kernel.LAUNCHES = 0
        out = srv.run([ImageRequest(i, im) for i, im in enumerate(imgs)])
        torch.cuda.synchronize()
        runs[label] = dict(out=out, launches=tile_kernel.LAUNCHES, algos=net.plan.algos(),
                           waves=srv.stats()["waves"])
    card, host = runs["bf16 card"], runs["bf16 cpu"]
    in_ulp, rel = True, 0.0
    for i in range(len(imgs)):
        a, b = card["out"][i], host["out"][i]
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"bf16 convnet rid {i}: bad output {a.shape}")
        u, r = _bf16_within(a, b)
        in_ulp, rel = in_ulp and u, max(rel, r)
    fp32 = runs["fp32 card"]
    print(f"phase 19 bf16 convnet: plan {list(card['algos'])} (fp32 {list(fp32['algos'])}); "
          f"tile launches bf16 {card['launches']} fp32 {fp32['launches']} over {card['waves']} "
          f"waves; card vs CPU bf16: every element within one ulp {in_ulp}, rel {rel:.3e} "
          f"(tol 1e-2); card {smi}")
    if card["launches"] != fp32["launches"] or card["launches"] < 1:
        raise AssertionError("bf16 convnet: tile launches differ from fp32's (or none)")
    if card["algos"] != fp32["algos"]:
        raise AssertionError("bf16 convnet: the bf16 plan differs from the fp32 plan")
    if not (in_ulp or rel < 1e-2):
        raise AssertionError(f"bf16 convnet: card vs CPU rel {rel:.3e}")
    return dict(launches=card["launches"], in_ulp=in_ulp, rel=rel)


def serve_with_trace() -> dict:
    """Phase 19 (b): `launch.serve --trace` on the card."""
    from repro_torch.convserve.obs import validate_chrome_trace
    from repro_torch.launch import serve

    mods = kernel_libraries()
    for mod in mods.values():
        mod.LAUNCHES = 0
    if os.path.exists(PHASE19_TRACE):
        os.unlink(PHASE19_TRACE)
    results = serve.main(["--arch", "gemma3-1b", "--trace", PHASE19_TRACE])
    torch.cuda.synchronize()
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    with open(PHASE19_TRACE) as f:
        data = json.load(f)
    problems = validate_chrome_trace(data)
    events = data["traceEvents"] if isinstance(data, dict) else data
    instants = sorted(e["name"] for e in events if e["name"].startswith("request:"))
    spans = [e["name"] for e in events if e["name"] == "serve:gemma3-1b"]
    print(f"phase 19 serve --trace: {len(results)} requests, {len(events)} trace events "
          f"({len(spans)} serve span, {len(instants)} request instants), problems "
          f"{problems[:3]}; launches {launches}")
    if problems or len(spans) != 1 or instants != sorted(f"request:{r}" for r in results):
        raise AssertionError("serve --trace: the trace is invalid or misses a request")
    if launches["flash_attention"] < 1 or launches["decode_mlp"] < 1:
        raise AssertionError("serve --trace: flash or decode-MLP never launched")
    return dict(requests=len(results), events=len(events), launches=launches)


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples() -> dict:
    """Phase 19 (c): the five examples on the card, each with its own
    checks (an example that fails raises)."""
    import shutil

    mods = kernel_libraries()
    shutil.rmtree(PHASE19_CKPT, ignore_errors=True)
    out = {}
    for name, argv in (
        ("torch_quickstart", ["--size", "56"]),
        ("torch_convnet_l3fusion", ["--reps", "3"]),
        ("torch_serve_batch", []),
        ("torch_serve_online", ["--requests", "60", "--trace", PHASE19_ONLINE_TRACE]),
        ("torch_train_lm", ["--steps", "20", "--ckpt-every", "10", "--ckpt-dir", PHASE19_CKPT]),
    ):
        for mod in mods.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        _example(name).main(["--device", "cuda", *argv])
        torch.cuda.synchronize()
        launches = {k: mod.LAUNCHES for k, mod in mods.items() if mod.LAUNCHES}
        out[name] = dict(seconds=time.perf_counter() - t0, launches=launches)
        print(f"phase 19 example {name}: ok in {out[name]['seconds']:.2f} s; launches {launches}")
    want = {"torch_quickstart": ("fused_tile",), "torch_convnet_l3fusion": ("fused_tile",),
            "torch_serve_batch": ("flash_attention", "decode_mlp"),
            "torch_serve_online": ("fused_tile",),
            "torch_train_lm": ("flash_attention", "flash_attention_bwd")}
    for name, kernels in want.items():
        if not all(out[name]["launches"].get(k, 0) > 0 for k in kernels):
            raise AssertionError(f"example {name}: {kernels} did not all launch")
    return out


def dryrun_vs_card(run: dict, smi: str) -> dict:
    """Phase 19 (d): the dry run of phase 18's gemma3-1b bf16 step against
    that run's counts, peak and step time."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import impl_flags, lower_cell

    t0 = time.perf_counter()
    with impl_flags("optimized"):  # the dry run's `--impl optimized`
        rec = lower_cell("gemma3-1b", ShapeConfig("phase18_train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    count_s = time.perf_counter() - t0
    steps = len(run["history"])
    card = {k: run["launches"][k] / steps for k in DRYRUN_KERNELS}
    dry = {k: rec["kernel_calls"].get(k, 0) for k in DRYRUN_KERNELS}
    by = rec["bytes_per_card"]
    state = by["params"] + by["grads"] + by["opt"]
    step_s = run["warm_ms"] / 1e3
    rf = rec["roofline"]
    achieved = rec["model_flops"] / step_s
    print(f"phase 19 dry run of gemma3-1b bf16 train {TRAIN_BATCH}x{TRAIN_SEQ} (meta, counted in "
          f"{count_s:.2f} s): kernel calls a step {dry}, card's LAUNCHES a step {card}; state "
          f"(params {by['params']} + grads {by['grads']} + moments {by['opt']} bytes) "
          f"{state / 2**30:.3f} GiB vs phase 18's peak {run['peak_bytes'] / 2**30:.3f} GiB; "
          f"counted {rf['hlo_flops']:.6e} FLOPs {rf['hlo_bytes']:.6e} bytes; model FLOPs "
          f"{rec['model_flops']:.6e} / warm step {run['warm_ms']:.1f} ms = {achieved:.6e} FLOP/s "
          f"({achieved / rf['peak_flops']:.4f} of the bf16 peak {rf['peak_flops']:.3e}); t_bound "
          f"{rf['t_bound_s'] * 1e3:.1f} ms ({rf['bottleneck']}: compute "
          f"{rf['t_compute_s'] * 1e3:.1f} ms, memory {rf['t_memory_s'] * 1e3:.1f} ms) beside the "
          f"step's {run['warm_ms']:.1f} ms; card {smi}")
    if dry != card:
        raise AssertionError(f"dry run: kernel calls {dry} != the card's {card} a step")
    if state > run["peak_bytes"]:
        raise AssertionError("dry run: the state's bytes exceed the measured peak")
    return dict(calls=dry, state_bytes=state, peak_bytes=run["peak_bytes"],
                model_flops=rec["model_flops"], step_ms=run["warm_ms"],
                model_flops_per_s=achieved, t_bound_ms=rf["t_bound_s"] * 1e3,
                bottleneck=rf["bottleneck"], counted_flops=rf["hlo_flops"],
                counted_bytes=rf["hlo_bytes"], count_s=count_s)


def phase_tools(smi: str, gemma3_bf16: dict) -> dict:
    """Phase 19 (module docstring): `gemma3_bf16` is phase 18's gemma3-1b
    run (launches, peak, history, warm step ms)."""
    t_phase = time.perf_counter()
    gc_collect()
    out = {}
    for part, fn in (("convnet_bf16", lambda: bf16_convnet_wave(smi)),
                     ("serve_trace", serve_with_trace), ("examples", run_examples),
                     ("dryrun", lambda: dryrun_vs_card(gemma3_bf16, smi))):
        t0 = time.perf_counter()
        out[part] = fn()
        print(f"phase 19: {part} in {time.perf_counter() - t0:.2f} s")
        gc_collect()
    wall = time.perf_counter() - t_phase
    print(f"phase 19: phase wall time {wall:.2f} s (limit {PHASE19_LIMIT_S:g} s)")
    if wall > PHASE19_LIMIT_S:
        raise AssertionError(f"phase 19 took {wall:.1f} s > {PHASE19_LIMIT_S:g} s")
    out["seconds"] = wall
    return out


# ----------------------------------------------------------------- phase 20

PHASE20_LIMIT_S = 90.0  # the aim is 60 s
PHASE20_DIR = os.path.join(ROOT, "build", "chip_smoke_phase20")
REL_TOL_FLAGS = {"float32": 1e-4, "bfloat16": 2e-2}  # baseline vs default logits (phase 17's bf16)
REL_TOL_MLA_EXPAND = 1e-4  # expanded vs absorbed MLA decode, fp32
REL_TOL_CHUNK_REMAT = 1e-6  # per-chunk remat on vs off: loss and every gradient
# mamba2's logits at chunk 128 vs the config's 256, fp32, 24 layers, every
# position: two summation orders of one function, whose gap grows with
# depth to 1.089e-4 on the card and 1.130e-4 on the CPU (card vs CPU at one
# chunk: 1.505e-4); a planted off-by-one in the carried state's decay reads
# 0.93 (`--ssm-chunk-gap`). Held at the net tolerance of card vs CPU logits
# (phase 7), between the two.
REL_TOL_SSM_CHUNK = REL_TOL_LM_CPU
FLAGS_STEPS = 16  # decode steps a wave under each flag set
MAMBA_REMAT_ROUNDS = 2  # phase 20's rounds of mamba2's train step, chunk remat off then on
REMAT_COST_ROUNDS = 6  # `--chunk-remat-cost`'s rounds
MLA_DECODE_STEPS = 4
COLL_STEPS = 3  # error-feedback steps of the compressed all-reduce
COLL_WORLD = 4  # gloo ranks, one process each, all on cuda:0
# with more than one card, NCCL ranks too: one process a card, rank i on cuda:i
COLL_SCALE = 1e-3  # the seeded gradients' std


def _wave_tokens(wave) -> np.ndarray:
    """A wave's prompts right-aligned over token 0, as `Engine` pads them."""
    n = max(len(r.prompt) for r in wave)
    toks = np.zeros((len(wave), n), np.int64)
    for i, r in enumerate(wave):
        toks[i, n - len(r.prompt):] = r.prompt
    return toks


def _serve_logits(model, waves, forced=None) -> dict:
    """Each wave prefilled (to LM_MAX_LEN), then FLAGS_STEPS decode steps
    fed greedily from this run's logits or teacher-forced on `forced`;
    the logits on the host, the tokens fed, wall ms (after synchronize)
    of the prefills and of a decode step, and the launches."""
    from repro_torch.models import lm_decode_step, lm_prefill

    mods = kernel_libraries()
    for mod in mods.values():
        mod.LAUNCHES = 0
    logits, fed, prefill_ms, step_ms = [], [], [], []
    for w, toks in enumerate(waves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, state = lm_prefill(model, torch.from_numpy(toks).to(DEV), LM_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        out, tok = [y.float().cpu()], []
        t0 = time.perf_counter()
        for t in range(FLAGS_STEPS):
            cur = forced[w][t] if forced is not None else out[-1].argmax(-1).numpy()
            tok.append(cur)
            y, state = lm_decode_step(model, torch.from_numpy(np.asarray(cur, np.int64)).to(DEV),
                                      toks.shape[1] + t, state)
            out.append(y.float().cpu())
        step_ms.append((time.perf_counter() - t0) * 1e3 / FLAGS_STEPS)
        logits.append(torch.stack(out))
        fed.append(tok)
    torch.cuda.synchronize()
    return dict(logits=logits, fed=fed, prefill_ms=prefill_ms, step_ms=step_ms,
                launches={k: mod.LAUNCHES for k, mod in mods.items()})


def flags_gemma3(smi: str) -> dict:
    """Phase 20 (a): gemma3-1b at full size in fp32 and bf16, phase 6's
    six requests in two waves, prefill and FLAGS_STEPS decode steps under
    `set_baseline()` (the chunked loop at S 700, the decode loop over
    512-slot chunks) against the same run under `Flags()` (the flash
    kernel, the one-shot decode), teacher-forced on the default run's
    greedy tokens."""
    import dataclasses

    from repro_torch.launch.dryrun import impl_flags
    from repro_torch.models import runtime_flags as rf
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_arch("gemma3-1b"), dtype=dtype)
        gc_collect()
        model = init_lm(cfg, seed=0, device=DEV)
        reqs = lm_requests(cfg, LM_PROMPTS)
        waves = [_wave_tokens(reqs[i:i + MAX_BATCH]) for i in range(0, len(reqs), MAX_BATCH)]
        for _ in range(2):  # a warm-up round of both, not read, then the run read
            with rf.restored():
                default = _serve_logits(model, waves)
            with impl_flags("baseline"):
                base = _serve_logits(model, waves, forced=default["fed"])
        rel = max(rel_err(b, d) for b, d in zip(base["logits"], default["logits"]))
        finite = all(bool(torch.isfinite(x).all()) for x in base["logits"] + default["logits"])
        n_attn = cfg.n_layers
        steps = FLAGS_STEPS * len(waves)
        want = {"default": {"flash_attention": n_attn * len(waves), "decode_mlp": n_attn * steps},
                "baseline": {"flash_attention": 0, "decode_mlp": n_attn * steps}}
        for label, run in (("default", default), ("baseline", base)):
            print(f"phase 20 gemma3-1b {dtype} {label:8s}: prefill ms by wave "
                  f"{[round(x, 3) for x in run['prefill_ms']]} (prompt {[w.shape for w in waves]}), "
                  f"decode ms/step by wave {[round(x, 3) for x in run['step_ms']]}; launches "
                  f"{ {k: v for k, v in run['launches'].items() if v} }; card {smi}")
            for k, n in want[label].items():
                if run["launches"][k] != n:
                    raise AssertionError(f"phase 20 gemma3 {dtype} {label}: {k} launched "
                                         f"{run['launches'][k]}, expected {n}")
        print(f"phase 20 gemma3-1b {dtype}: baseline vs default logits (prefill and "
              f"{FLAGS_STEPS} teacher-forced steps, both waves) rel {rel:.3e} "
              f"(tol {REL_TOL_FLAGS[dtype]:g}), finite {finite}")
        if not finite or rel > REL_TOL_FLAGS[dtype]:
            raise AssertionError(f"phase 20 gemma3 {dtype}: baseline vs default rel {rel:.3e}")
        out[dtype] = dict(rel=rel, default=dict(prefill_ms=default["prefill_ms"],
                                                step_ms=default["step_ms"]),
                          baseline=dict(prefill_ms=base["prefill_ms"], step_ms=base["step_ms"]))
        del model
    return out


def flags_mla(smi: str) -> dict:
    """Phase 20 (b): deepseek-v3-671b's MLA at full width (layer 0's
    attention weights), fp32, B 4 over a latent cache filled at 700
    positions: MLA_DECODE_STEPS decode steps with `mla_absorb` (the
    absorbed form) against `mla_absorb=False` (the latents expanded every
    step), the expanded one under "flash" (one masked pass) and under
    "chunked" (the baseline's 512-slot loop)."""
    import dataclasses

    from repro_torch.launch.dryrun import impl_flags
    from repro_torch.models import runtime_flags as rf
    from repro_torch.configs import get_arch
    from repro_torch.models import attention as attn_mod

    cfg = dataclasses.replace(get_arch(DS), dtype="float32", n_layers=1)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20)
    p = attn_mod.init_mla(gen, cfg, torch.float32, DEV)
    b, n = MAX_BATCH, LM_PROMPTS[0]
    rng = np.random.default_rng(20)
    pos = torch.arange(n, dtype=torch.int32, device=DEV).expand(b, n)
    cache0 = attn_mod.init_mla_cache(cfg, b, LM_MAX_LEN, torch.float32, DEV)
    xs = [_cuda(rng, (b, 1, cfg.d_model)) for _ in range(MLA_DECODE_STEPS)]
    with torch.inference_mode():
        c_kv, k_rope = attn_mod._mla_kv_latent(p, _cuda(rng, (b, n, cfg.d_model)), pos, cfg)
        attn_mod.fill_mla_cache(cache0, c_kv, k_rope, pos)
    runs = {}
    for label, under in (("absorbed", rf.overrides()),
                         ("expanded", rf.overrides(mla_absorb=False)),
                         ("expanded chunked", impl_flags("baseline"))):
        cache = {k: v.clone() for k, v in cache0.items()}
        ys = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with under, torch.inference_mode():
            for t, x in enumerate(xs):
                y, cache = attn_mod.mla_decode(p, x, n + t, cache, cfg)
                ys.append(y)
        torch.cuda.synchronize()
        runs[label] = dict(y=torch.stack(ys), ms=(time.perf_counter() - t0) * 1e3 / len(xs))
    ref = runs["absorbed"]["y"]
    rels = {k: rel_err(r["y"], ref) for k, r in runs.items() if k != "absorbed"}
    print(f"phase 20 {DS} MLA decode (B{b}, cache {n}..{n + len(xs) - 1} of {LM_MAX_LEN}, fp32): "
          f"ms/step {', '.join(f'{k} {r['ms']:.3f}' for k, r in runs.items())} (host wall, the "
          f"first step included); vs absorbed rel "
          f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())} (tol {REL_TOL_MLA_EXPAND:g}); "
          f"card {smi}")
    if not torch.isfinite(ref).all() or max(rels.values()) > REL_TOL_MLA_EXPAND:
        raise AssertionError(f"phase 20 MLA: expanded vs absorbed {rels}")
    return dict(rel=rels, ms={k: r["ms"] for k, r in runs.items()})


def _remat_steps(cfg, smi: str, rounds: int, tag: str = "phase 20") -> tuple:
    """One warm-up train step of `cfg` at full width (4 x 1024, `lm_loss`
    under per-super-block remat, cuBLAS summing in f32), then `rounds`
    rounds of a step with `ssm_chunk_remat` off and one with it on (the
    default: a checkpoint per SSD chunk inside each super-block's): every
    step's host wall ms and peak above what it started from, the first
    round's loss and gradients held on against off; lines printed under
    `tag`.  Returns (model, readings)."""
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.models import runtime_flags as rf
    from repro_torch.models.common import f32_accumulation

    gc_collect()
    model = init_lm(cfg, seed=0, device=DEV)
    model.requires_grad_(True)
    params = list(model.parameters())
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in stream_batch(cfg, 0).items()}
    mods = kernel_libraries()
    steps = [("warm-up", True)] + [(label, remat) for _ in range(rounds)
                                   for label, remat in (("off", False), ("on", True))]
    read = {"on": dict(ms=[], peak=[]), "off": dict(ms=[], peak=[])}
    for label, remat in steps:
        gc_collect()
        for mod in mods.values():
            mod.LAUNCHES = 0
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with rf.overrides(ssm_chunk_remat=remat), f32_accumulation():
            loss, _ = lm_loss(model, batch)
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        if label == "warm-up":
            continue
        r = read[label]
        r["ms"].append((time.perf_counter() - t0) * 1e3)
        r["peak"].append(torch.cuda.max_memory_allocated() - base)
        if "loss" not in r:
            r.update(loss=loss.detach(), grads=grads,
                     launches={k: m.LAUNCHES for k, m in mods.items() if m.LAUNCHES})
        del loss, grads
    on, off = read["on"], read["off"]
    rel = max([rel_err(on["loss"].float(), off["loss"].float())]
              + [rel_err(a.float(), b.float()) for a, b in zip(on["grads"], off["grads"])])
    finite = all(bool(torch.isfinite(g).all()) for g in on["grads"])
    what = f"mamba2-1.3b {cfg.dtype} ({cfg.n_layers} layers) train step"
    for label in ("on", "off"):
        r = read[label]
        print(f"{tag} {what}, chunk remat {label}: loss {float(r['loss']):.6f}; ms by round "
              f"{[round(x, 1) for x in r['ms']]}, median {statistics.median(r['ms']):.1f}; peak "
              f"above the start {max(r['peak']) / 2**30:.3f} GiB (max_memory_allocated); "
              f"launches {r['launches']}; card {smi}")
    print(f"{tag} {what}, chunk remat on vs off: loss and {len(params)} gradients max rel "
          f"{rel:.3e} (tol {REL_TOL_CHUNK_REMAT:g}), finite {finite}")
    if not finite or rel > REL_TOL_CHUNK_REMAT or on["launches"] != off["launches"]:
        raise AssertionError(f"{tag} {what} chunk remat: rel {rel:.3e}, launches "
                             f"{on['launches']} vs {off['launches']}")
    model.requires_grad_(False)
    return model, {k: dict(ms=r["ms"], peak=max(r["peak"])) for k, r in read.items()}


def _chunk_runs(model, toks, chunks=(0, 128)) -> dict:
    """`lm_prefill` (host wall ms, last-token logits) and `lm_logits`
    (every position) of `toks` at each SSD chunk length of `chunks` (0:
    the config's)."""
    from repro_torch.models import lm_logits, lm_prefill
    from repro_torch.models import runtime_flags as rf

    out = {}
    for chunk in chunks:
        with rf.overrides(ssm_chunk_override=chunk), torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, _ = lm_prefill(model, toks, LM_MAX_LEN)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out[chunk] = dict(last=y, ms=ms, every=lm_logits(model, toks))
    return out


def flags_mamba(smi: str) -> dict:
    """Phase 20 (c): mamba2-1.3b at full width on MAMBA_FP32_LAYERS fp32
    layers, `_remat_steps` over MAMBA_REMAT_ROUNDS rounds; then wave 1's
    prefill and every position's logits at `ssm_chunk_override=128`
    against the config's chunk (the last token alone sits hundreds of
    steps past a chunk boundary, where the carried state has decayed
    away at these weights: `--ssm-chunk-gap`)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("mamba2-1.3b"), dtype="float32",
                              n_layers=MAMBA_FP32_LAYERS)
    model, fp32 = _remat_steps(cfg, smi, MAMBA_REMAT_ROUNDS)
    gc_collect()
    toks = torch.from_numpy(_wave_tokens(lm_requests(cfg, LM_PROMPTS)[:MAX_BATCH])).to(DEV)
    pre = _chunk_runs(model, toks)
    rel_last = rel_err(pre[128]["last"], pre[0]["last"])
    rel_every = rel_err(pre[128]["every"], pre[0]["every"])
    print(f"phase 20 mamba2 prefill B{toks.shape[0]} S{toks.shape[1]}: chunk {cfg.ssm.chunk} "
          f"{pre[0]['ms']:.1f} ms, ssm_chunk_override 128 {pre[128]['ms']:.1f} ms (host wall); "
          f"chunk 128 vs {cfg.ssm.chunk}: last-token logits rel {rel_last:.3e}, every "
          f"position's rel {rel_every:.3e} (tol {REL_TOL_SSM_CHUNK:g})")
    finite = all(bool(torch.isfinite(pre[128][k]).all()) for k in ("last", "every"))
    if not finite or max(rel_last, rel_every) > REL_TOL_SSM_CHUNK:
        raise AssertionError(f"phase 20 mamba2 chunk override: rel {rel_last:.3e} (last), "
                             f"{rel_every:.3e} (every position)")
    return dict(step=fp32, rel_last=rel_last,
                rel_every=rel_every, prefill_ms={chunk: r["ms"] for chunk, r in pre.items()})


def chunk_remat_cost(smi: str) -> int:
    """`python3 chip_smoke.py --chunk-remat-cost`: what `ssm_chunk_remat`
    (on in `Flags()`) costs mamba2-1.3b's train step at full width,
    `_remat_steps` over REMAT_COST_ROUNDS rounds in bf16 on all 48 layers
    (phase 18's configuration) and in fp32 on MAMBA_FP32_LAYERS."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch = get_arch("mamba2-1.3b")
    for cfg in (dataclasses.replace(arch, dtype="bfloat16"),
                dataclasses.replace(arch, dtype="float32", n_layers=MAMBA_FP32_LAYERS)):
        read = _remat_steps(cfg, smi, REMAT_COST_ROUNDS, "chunk remat cost:")[1]
        on, off = (statistics.median(read[k]["ms"]) for k in ("on", "off"))
        print(f"chunk remat cost: mamba2-1.3b {cfg.dtype} ({cfg.n_layers} layers): median on "
              f"{on:.1f} ms, off {off:.1f} ms, on / off {on / off:.3f}; peak on "
              f"{read['on']['peak'] / 2**30:.3f} GiB, off {read['off']['peak'] / 2**30:.3f} GiB")
        gc_collect()
    return 0


# Off-by-one faults planted, in memory only, in `models/mamba.py`'s chunk
# step for `--ssm-chunk-gap`: (what, the line as it is, the line broken).
SSM_CHUNK_FAULTS = (
    ("the carried state misses its chunk's last decay step",
     "return state * torch.exp(last)[:, :, None, None] + sc, y",
     "return state * torch.exp(lac[:, -2, :])[:, :, None, None] + sc, y"),
    ("the carried state's contribution skips the chunk's first decay step",
     'torch.einsum("bthn,bhpn->bthp", ch, state) * torch.exp(lac)[..., None]',
     'torch.einsum("bthn,bhpn->bthp", ch, state) * torch.exp(lac - lac[:, :1, :])[..., None]'),
)
SSM_GAP_DEPTHS = (1, 2, 4, 8, 12, 16, 20, 24)  # layers whose hidden state the study reports


@contextlib.contextmanager
def _planted(old: str, new: str):
    """`models.mamba.mamba_forward` compiled from its module's source with
    `old` replaced by `new`, for the block; nothing is written to disk."""
    import inspect

    from repro_torch.models import mamba as mm

    src = inspect.getsource(mm)
    if src.count(old) != 1:
        raise AssertionError(f"the line to break is not in models/mamba.py once: {old}")
    ns = {"__name__": "mamba_with_a_planted_fault"}
    exec(compile(src.replace(old, new), "<mamba.py with a planted fault>", "exec"), ns)
    kept = mm.mamba_forward
    mm.mamba_forward = ns["mamba_forward"]
    try:
        yield
    finally:
        mm.mamba_forward = kept


def _hidden_states(model, toks, chunk: int) -> tuple:
    """The hidden state after every layer of `model` on `toks` (B, S) and
    every position's logits, at SSD chunk length `chunk` (0: the
    config's), on the model's device."""
    from repro_torch.models import blocks, lm
    from repro_torch.models import runtime_flags as rf

    with rf.overrides(ssm_chunk_override=chunk), torch.inference_mode():
        x = model.embed[toks]
        pos = lm._positions(toks.shape[0], toks.shape[1], toks.device)
        hs = []
        for spec, lp in zip(model.specs, model.layers):
            x, _, _ = blocks.apply_layer(lp, spec, model.cfg, x, pos, model.shared_block)
            hs.append(x)
        return hs, lm._head(model, x)


def _mamba_f64(mp, h: torch.Tensor, cfg) -> torch.Tensor:
    """A mamba2 block's output in float64 by the SSD's step-by-step
    recurrence (no chunks): state_t = exp(dt_t A) state_{t-1} + dt_t x_t
    B_t^T, y_t = C_t state_t + D x_t, then the gate, the norm and the out
    projection; `mp` the block's parameters, `h` its (normed) input."""
    import torch.nn.functional as F

    from repro_torch.models import mamba as mm

    s, d_inner, nh, _ = mm._dims(cfg)
    w = {k: mp[k].double() for k in ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
                                      "norm", "out_proj")}
    bsz, seq, _ = h.shape
    z, xbc, dt_raw = mm._split(cfg, h.double() @ w["in_proj"])
    xp = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    conv = sum(xp[:, i:i + seq] * w["conv_w"][i] for i in range(s.d_conv)) + w["conv_b"]
    xs, bm, cm = mm._split_xbc(cfg, F.silu(conv))
    rep = nh // s.n_groups
    xs = xs.reshape(bsz, seq, nh, s.head_dim)
    bh = bm.reshape(bsz, seq, s.n_groups, s.d_state).repeat_interleave(rep, dim=2)
    ch = cm.reshape(bsz, seq, s.n_groups, s.d_state).repeat_interleave(rep, dim=2)
    dt = F.softplus(dt_raw + w["dt_bias"])
    a = -torch.exp(w["A_log"])
    state = torch.zeros((bsz, nh, s.head_dim, s.d_state), dtype=torch.float64, device=h.device)
    ys = []
    for t in range(seq):
        state = (state * torch.exp(dt[:, t] * a)[:, :, None, None]
                 + dt[:, t, :, None, None] * xs[:, t, :, :, None] * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], state))
    y = (torch.stack(ys, dim=1) + xs * w["D"][:, None]).reshape(bsz, seq, d_inner) * F.silu(z)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps) * (1.0 + w["norm"])
    return y @ w["out_proj"]


def ssm_chunk_gap(smi: str) -> int:
    """`python3 chip_smoke.py --ssm-chunk-gap`: where phase 20's gap between
    mamba2's chunk 128 and the config's 256 comes from.  mamba2-1.3b at
    full width on MAMBA_FP32_LAYERS fp32 layers (phase 20's model, seed 0)
    over wave 1 (B 4, S 700): every position's hidden state after each
    of SSM_GAP_DEPTHS layers and the logits, chunk 128 against 256 on the
    card and on the CPU, and the card against the CPU at 256; layer 0's
    block at each chunk against its float64 step-by-step recurrence on
    the card; each of SSM_CHUNK_FAULTS planted, chunk 128 against 256 on
    the card.  Prints a table; holds nothing."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.models import mamba as mm
    from repro_torch.models import runtime_flags as rf
    from repro_torch.models.common import rms_norm

    cfg = dataclasses.replace(get_arch("mamba2-1.3b"), dtype="float32",
                              n_layers=MAMBA_FP32_LAYERS)
    model = init_lm(cfg, seed=0, device=DEV)
    toks = torch.from_numpy(_wave_tokens(lm_requests(cfg, LM_PROMPTS)[:MAX_BATCH])).to(DEV)
    print(f"ssm chunk gap: mamba2-1.3b fp32, {cfg.n_layers} layers, chunk {cfg.ssm.chunk} vs 128, "
          f"B{toks.shape[0]} S{toks.shape[1]}; rel = max |a - b| / max |b| over every position; "
          f"card {smi}")

    def gaps(a, b) -> dict:
        out = {f"layer {d}": rel_err(a[0][d - 1], b[0][d - 1].to(a[0][d - 1].device))
               for d in SSM_GAP_DEPTHS}
        out["logits, every position"] = rel_err(a[1], b[1].to(a[1].device))
        out["logits, last token"] = rel_err(a[1][:, -1], b[1][:, -1].to(a[1].device))
        return out

    t0 = time.perf_counter()
    card = {c: _hidden_states(model, toks, c) for c in (0, 128)}
    table = {"card, 128 vs 256": gaps(card[128], card[0])}
    for what, old, new in SSM_CHUNK_FAULTS:
        with _planted(old, new):
            broken = {c: _hidden_states(model, toks, c) for c in (0, 128)}
        table[f"card, 128 vs 256, fault: {what}"] = gaps(broken[128], broken[0])
        table[f"card, fault at 256 vs none: {what}"] = gaps(broken[0], card[0])
        del broken
    with torch.inference_mode():
        lp = model.layers[0]
        h = rms_norm(model.embed[toks], lp["ln1"], cfg.norm_eps)
        exact = _mamba_f64(lp["mamba"], h, cfg)
        one = {}
        for c in (0, 128):
            with rf.overrides(ssm_chunk_override=c):
                one[c] = mm.mamba_forward(lp["mamba"], h, cfg)
    print(f"ssm chunk gap: layer 0's block, fp32 on the card against its float64 recurrence: "
          f"chunk 256 rel {rel_err(one[0], exact):.3e}, chunk 128 rel {rel_err(one[128], exact):.3e}; "
          f"128 vs 256 rel {rel_err(one[128], one[0]):.3e}")
    print(f"ssm chunk gap: card runs in {time.perf_counter() - t0:.1f} s")
    del one, exact, h
    t0 = time.perf_counter()
    model = model.to("cpu")
    cpu = {c: _hidden_states(model, toks.cpu(), c) for c in (0, 128)}
    table["cpu, 128 vs 256"] = gaps(cpu[128], cpu[0])
    table["card vs cpu, at 256"] = gaps(card[0], cpu[0])
    table["card vs cpu, at 128"] = gaps(card[128], cpu[128])
    print(f"ssm chunk gap: cpu runs ({torch.get_num_threads()} threads) in "
          f"{time.perf_counter() - t0:.1f} s")
    cols = list(next(iter(table.values())))
    print("ssm chunk gap: | pair | " + " | ".join(cols) + " |")
    for name, row in table.items():
        print(f"ssm chunk gap: | {name} | " + " | ".join(f"{row[c]:.3e}" for c in cols) + " |")
    return 0


def flags_dryrun() -> dict:
    """Phase 20 (d): `launch.dryrun --impl baseline` on gemma3-1b train_4k
    (meta device): status ok, no flash call counted."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rc = dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--out", PHASE20_DIR])
    secs = time.perf_counter() - t0
    with open(os.path.join(PHASE20_DIR, "gemma3-1b__train_4k__1.json")) as f:
        rec = json.load(f)
    rf = rec.get("roofline", {})
    print(f"phase 20 dryrun --impl baseline gemma3-1b train_4k: rc {rc}, status "
          f"{rec['status']} in {secs:.2f} s; kernel calls {rec.get('kernel_calls')}; counted "
          f"{rf.get('hlo_flops', 0):.6e} FLOPs {rf.get('hlo_bytes', 0):.6e} bytes; t_bound "
          f"{rf.get('t_bound_s', 0):.4f} s ({rf.get('bottleneck')})")
    if rc != 0 or rec["status"] != "ok" or any(k.startswith("flash") for k in rec["kernel_calls"]):
        raise AssertionError("phase 20 dry run --impl baseline failed or counted a flash call")
    return dict(seconds=secs, kernel_calls=rec["kernel_calls"], t_bound_s=rf["t_bound_s"])


def _coll_shapes() -> dict:
    """gemma3-1b's first layer's parameter shapes, by name (meta)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm

    model = init_lm(get_arch("gemma3-1b"), device="meta")
    return {name: tuple(t.shape) for name, t in model.layers[0].named_parameters()}


def _coll_tree(shapes: dict, rank: int, step: int) -> dict:
    """Rank `rank`'s seeded f32 gradient tree of step `step`, on the card."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1000 * step + rank)
    return {name: torch.randn(shape, generator=gen, device=DEV) * COLL_SCALE
            for name, shape in shapes.items()}


def _coll_blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened, zero-padded to whole 256-element blocks."""
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % 256)).reshape(-1, 256)


def _coll_oracle(grads, residuals) -> list:
    """Every rank's (mean, new residual) of one compressed all-reduce step
    in this process, rank i's input being (grads[i], residuals[i]): one
    scale per 256-block from the ranks' joint |max| / 127, each rank's
    int8 payload, their int32 sum over the world size times the scale;
    the residual is the rank's own quantisation error."""
    gs = [g.float() + r for g, r in zip(grads, residuals)]
    size, shape = gs[0].numel(), gs[0].shape
    blocks = [_coll_blocks(g) for g in gs]
    amax = torch.stack([b.abs().amax(dim=1) for b in blocks]).amax(dim=0)
    scale = torch.clamp(amax / 127.0, min=1e-20)[:, None]
    qs = [torch.round(b / scale).to(torch.int8) for b in blocks]
    qsum = torch.stack([q.to(torch.int32) for q in qs]).sum(dim=0, dtype=torch.int32)
    mean = ((qsum.float() / float(len(gs))) * scale).reshape(-1)[:size].reshape(shape)
    return [(mean, g - (q.float() * scale).reshape(-1)[:size].reshape(shape))
            for g, q in zip(gs, qs)]


def _within_one_step(card, cpu, inputs) -> float:
    """max over blocks of |card - cpu| / the block's quantisation step
    (the group's |max| / 127 from the CPU's inputs, all ranks')."""
    amax = torch.stack([_coll_blocks(g).abs().amax(dim=1) for g in inputs]).amax(dim=0)
    step = torch.clamp(amax / 127.0, min=1e-20)
    return float((_coll_blocks(card.cpu() - cpu).abs().amax(dim=1) / step).max())


def coll_run(rank: int, world: int, cpu_check: bool = True) -> dict:
    """COLL_STEPS steps of `make_compressed_allreduce()` over the default
    process group on gemma3-1b's first layer's gradient tree (rank r's
    seeded by r and the step), each step's mean and new residuals held
    bitwise against `_coll_oracle` of every rank's inputs in this process
    on the card, and (rank 0, with `cpu_check`) within one quantisation
    step of the same reduction on the CPU from the same inputs."""
    from repro_torch.distributed import collectives as coll

    import hashlib

    shapes = _coll_shapes()
    allreduce = coll.make_compressed_allreduce()
    res = [coll.init_residuals(_coll_tree(shapes, r, 0)) for r in range(world)]
    bitwise, steps_off, ms = True, 0.0, []
    digest = hashlib.sha1()  # every step's mean and own residual, by leaf
    for step in range(COLL_STEPS):
        trees = [_coll_tree(shapes, r, step) for r in range(world)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, mine = allreduce(trees[rank], res[rank])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        new = [dict() for _ in range(world)]
        for name in shapes:
            for x in (mean[name], mine[name]):
                digest.update(x.detach().cpu().numpy().tobytes())
            sim = _coll_oracle([t[name] for t in trees], [r[name] for r in res])
            bitwise &= torch.equal(mean[name], sim[rank][0]) and torch.equal(mine[name],
                                                                                sim[rank][1])
            if rank == 0 and cpu_check:
                inputs = [t[name].cpu() for t in trees]
                cpu = _coll_oracle(inputs, [r[name].cpu() for r in res])
                carried = [g + r[name].cpu() for g, r in zip(inputs, res)]
                steps_off = max(steps_off, _within_one_step(mean[name], cpu[0][0], carried),
                                _within_one_step(mine[name], cpu[0][1], carried))
            for r in range(world):
                new[r][name] = sim[r][1]
        new[rank] = mine
        res = new
    n = sum(math.prod(s) for s in shapes.values())
    return dict(rank=rank, world=world, leaves=len(shapes), elements=n, bitwise=bitwise,
                steps_off=steps_off, ms=ms, digest=digest.hexdigest())


def coll_child(rank: int, world: int, store: str, backend: str = "gloo") -> int:
    """A rank of phase 20 (e): `coll_run` over a FileStore group; a gloo
    rank on cuda:0, an NCCL rank on cuda:<rank>, which then times the
    compressed all-reduce of its tree and a plain f32 all-reduce of it
    (CUDA events, median of 10, every rank in step).  An NCCL world of
    gloo's size leaves the CPU check to gloo's: its payload is held
    bitwise gloo's instead."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.distributed import collectives as coll

    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device(DEV, rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, **kw)
    try:
        out = coll_run(rank, world, cpu_check=backend == "gloo" or world != COLL_WORLD)
        if backend == "nccl":
            tree = _coll_tree(_coll_shapes(), rank, 0)
            res, allreduce = coll.init_residuals(tree), coll.make_compressed_allreduce()
            flat = [t.clone() for t in tree.values()]
            out.update(compressed_ms=time_ms(lambda: allreduce(tree, res), reps=10),
                       plain_ms=time_ms(lambda: [dist.all_reduce(t) for t in flat], reps=10))
        print("COLL " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _coll_ranks(backend: str, world: int, store: str) -> list:
    """Start `world` subprocesses of `chip_smoke.py --coll-rank r` on one
    FileStore (the caller waits on them)."""
    if os.path.exists(store):
        os.unlink(store)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--coll-rank", str(r),
                              "--coll-world", str(world), "--coll-store", store,
                              "--coll-backend", backend],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _coll_results(label: str, procs: list) -> list:
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for rank, (rc, out, err) in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("COLL ")]
        if rc != 0 or not lines:
            raise AssertionError(f"phase 20 {label} rank {rank} failed (rc {rc}): {err[-2000:]}")
        got.append(json.loads(lines[-1][5:]))
    return got


def flags_collectives(smi: str) -> dict:
    """Phase 20 (e): the int8 compressed all-reduce with error feedback at
    world 1 over NCCL in this process, then at world COLL_WORLD over gloo
    in COLL_WORLD subprocesses (each a rank on cuda:0) sharing a
    FileStore and, with n > 1 cards, at world n over NCCL in n more
    subprocesses started once those have ended (rank i on cuda:i); each held by
    `coll_run`, and NCCL's payload at world n bitwise gloo's where the two
    worlds are one size.  The in-process NCCL call's time (CUDA events)
    beside a plain f32 all-reduce of the same tree."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll

    os.makedirs(PHASE20_DIR, exist_ok=True)
    store = os.path.join(PHASE20_DIR, "nccl_store")
    if os.path.exists(store):
        os.unlink(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1,
                            device_id=torch.device(DEV, 0))
    try:
        nccl = coll_run(0, 1)
        tree = _coll_tree(_coll_shapes(), 0, 0)
        res = coll.init_residuals(tree)
        allreduce = coll.make_compressed_allreduce()
        flat = [t.clone() for t in tree.values()]
        compressed_ms = time_ms(lambda: allreduce(tree, res), reps=10)
        plain_ms = time_ms(lambda: [dist.all_reduce(t) for t in flat], reps=10)
    finally:
        dist.destroy_process_group()
    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    gloo = _coll_results("gloo", _coll_ranks("gloo", COLL_WORLD,
                                             os.path.join(PHASE20_DIR, "gloo_store")))
    gloo_s = time.perf_counter() - t0
    # NCCL's world n only once gloo's ranks have ended, so the two never
    # contend for the host; its seconds stand outside the phase's limit
    t0 = time.perf_counter()
    wide = (_coll_results("nccl", _coll_ranks("nccl", n_cards,
                                              os.path.join(PHASE20_DIR, "nccl_world_store")))
            if n_cards > 1 else [])
    wide_s = time.perf_counter() - t0
    if wide:
        same = (len(wide) == len(gloo)
                and [w["digest"] for w in wide] == [g["digest"] for g in gloo])
        print(f"phase 20 compressed all-reduce over NCCL at world {n_cards} (rank i on cuda:i, "
              f"subprocesses after gloo's, {wide_s:.1f} s): bitwise vs one process {[w['bitwise'] for w in wide]}"
              + (f", rank 0 vs CPU within {wide[0]['steps_off']:.3f} steps" if len(wide) != len(gloo)
                 else "") + f"; payload bitwise gloo world {COLL_WORLD}'s "
              + (f"{same}" if len(wide) == len(gloo) else "not comparable (another world size)")
              + f"; ms/step by rank {[[round(x, 3) for x in w['ms']] for w in wide]} (host "
              f"wall, each rank waiting on rank 0's checks); the compressed all-reduce of the "
              f"tree by rank {[round(w['compressed_ms'], 4) for w in wide]} ms, a plain f32 "
              f"all_reduce {[round(w['plain_ms'], 4) for w in wide]} ms (CUDA events, median "
              f"of 10); cards {card_table()}")
        if not all(w["bitwise"] for w in wide) or (len(wide) == len(gloo) and not same):
            raise AssertionError("phase 20 compressed all-reduce over NCCL at world "
                                 f"{n_cards}: not bitwise")
    print(f"phase 20 compressed all-reduce, gemma3-1b layer 0's gradient tree ({nccl['leaves']} "
          f"leaves, {nccl['elements']} f32 elements), {COLL_STEPS} error-feedback steps: NCCL "
          f"world 1 bitwise vs one process {nccl['bitwise']}, vs CPU within "
          f"{nccl['steps_off']:.3f} quantisation steps; gloo world {COLL_WORLD} on cuda:0 "
          f"(subprocesses, {gloo_s:.1f} s) bitwise {[g['bitwise'] for g in gloo]}, rank 0 vs CPU "
          f"within {gloo[0]['steps_off']:.3f} steps, ms/step by rank "
          f"{[[round(x, 1) for x in g['ms']] for g in gloo]} (host wall)")
    print(f"phase 20 NCCL world 1: compressed all-reduce of the tree {compressed_ms:.4f} ms, "
          f"plain f32 all_reduce {plain_ms:.4f} ms (CUDA events, median); card {smi}")
    ok = nccl["bitwise"] and all(g["bitwise"] for g in gloo)
    worst = max([nccl["steps_off"], gloo[0]["steps_off"]] + [w["steps_off"] for w in wide[:1]])
    if not ok or worst > 1.0 + 1e-4 or sorted(g["rank"] for g in gloo) != list(range(COLL_WORLD)):
        raise AssertionError(f"phase 20 compressed all-reduce: bitwise {ok}, {worst} steps off")
    return dict(elements=nccl["elements"], compressed_ms=compressed_ms, plain_ms=plain_ms,
                steps_off=worst, gloo_seconds=gloo_s, nccl_world_seconds=wide_s,
                nccl_world=dict(world=n_cards, compressed_ms=[w["compressed_ms"] for w in wide],
                                plain_ms=[w["plain_ms"] for w in wide]) if wide else None)


def phase_flags(smi: str) -> dict:
    """Phase 20 (module docstring): the runtime flags and the compressed
    all-reduce."""
    t_phase = time.perf_counter()
    gc_collect()
    out = {}
    for part, fn in (("gemma3", lambda: flags_gemma3(smi)), ("mla", lambda: flags_mla(smi)),
                     ("mamba2", lambda: flags_mamba(smi)), ("dryrun", flags_dryrun),
                     ("collectives", lambda: flags_collectives(smi))):
        t0 = time.perf_counter()
        out[part] = fn()
        print(f"phase 20: {part} in {time.perf_counter() - t0:.2f} s")
        gc_collect()
    # NCCL's world n (more than one card only) is timed outside the limit
    wide_s = out["collectives"]["nccl_world_seconds"]
    wall = time.perf_counter() - t_phase - wide_s
    print(f"phase 20: phase wall time {wall:.2f} s (limit {PHASE20_LIMIT_S:g} s), NCCL world n "
          f"{wide_s:.2f} s beside it")
    if wall > PHASE20_LIMIT_S:
        raise AssertionError(f"phase 20 took {wall:.1f} s > {PHASE20_LIMIT_S:g} s")
    out["seconds"] = wall
    return out


# ----------------------------------------------------------------- phase 21

PHASE21_LIMIT_S = 90.0  # the aim is 60 s on one card
MESH_ENTRIES = 4  # the data (or model) axis: cuda:{i % n} over the n visible cards
MESH_WAVES = (4, 16, 64)  # rows of the timed vgg waves
MESH_NS = (1, 2, 4)  # mesh entries of the timed waves
MESH_REPS = 20  # CUDA-event-timed waves a (rows, N) pair; the median is read
CP_LAYERS, CP_BATCH, CP_SEQ = 2, 4, 700  # gemma3-1b's cut for (e)
REL_TOL_CP = 1e-5  # q stripes vs the whole chunked attention, fp32
REL_TOL_MESH_BF16 = 2e-2  # a bf16 kernel vs its plain version on each card (phase 17's)


def mesh_cards(entries: int = MESH_ENTRIES) -> list:
    """`entries` mesh positions over the visible cards, entry i on cuda:{i % n}."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(entries)]


def card_table() -> list:
    """nvidia-smi's name and power limit of every card, one line each."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()


def _card_launches(stem: str) -> dict:
    from repro_torch.kernels import _build

    with _build.COUNT_LOCK:
        return {i: n for (s, i), n in _build.CARD_LAUNCHES.items() if s == stem}


def _launch_delta(stem: str, before: dict) -> dict:
    return {f"cuda:{i}": n - before.get(i, 0) for i, n in sorted(_card_launches(stem).items())
            if n - before.get(i, 0)}


def mesh_kernel_cases(card) -> list:
    """(a)'s cases on `card`: every kernel source at the largest shape its
    phase gives it (phase 3's widest vgg layer; phase 4's and 17's zamba2
    conv1d wave and decode MLP and deepseek-v3's MLA attention; phase 13's
    and 18's gemma3-1b global training layer and mamba2's training
    slice), operands drawn on the card from one seed, so every card gets
    the same inputs.  Each: (name, stem, run, plain, tolerance)."""
    from repro_torch.kernels.conv1d_fused import backward as conv_bwd
    from repro_torch.kernels.conv1d_fused import conv1d_bwd_ref, conv1d_fused, conv1d_ref
    from repro_torch.kernels.decode_mlp import decode_mlp, decode_mlp_ref
    from repro_torch.kernels.flash_attention import attention_ref, flash_forward
    from repro_torch.kernels.flash_attention import backward as flash_bwd
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    gen = torch.Generator(device=card)
    gen.manual_seed(21)

    def draw(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card) * scale).to(dtype)

    tile = max(kernel_cases(), key=lambda c: c[2] * c[3] * c[4] * c[5] * c[6] // c[7])
    with torch.cuda.device(card):
        tc = make_case(tile, np.random.default_rng(21))
    cases = [(f"fused_tile {tile[0]}", "fused_tile", lambda: run_kernel(tc),
              lambda: run_plain(tc), REL_TOL_KERNEL)]
    bf = torch.bfloat16
    for dtype, tol in ((torch.float32, REL_TOL_LM_KERNEL), (bf, REL_TOL_MESH_BF16)):
        tag = "bf16" if dtype == bf else "fp32"
        # zamba2-7b's xBC slice at its first prefill wave (phases 4 and 17)
        x = draw((4, 768, 14576), dtype)[..., 7168:7168 + 7296]
        w, b = draw((4, 7296), dtype, 0.5), draw((7296,), dtype, 0.1)
        cases.append((f"conv1d_fused {tag} zamba2 wave 1 B4 L768 D7296",
                      "conv1d_fused" if dtype != bf else "conv1d_fused_fwd_bf16",
                      lambda x=x, w=w, b=b: conv1d_fused(x, w, b),
                      lambda x=x, w=w, b=b: conv1d_ref(x, w, b), tol))
        # mamba2-1.3b's training slice, the backward (phases 13 and 18)
        x = draw((4, 1024, 8512), dtype)[..., 4096:4096 + 4352]
        w, b, g = draw((4, 4352), dtype, 0.5), draw((4352,), dtype, 0.1), draw(
            (4, 1024, 4352), dtype)
        cases.append((f"conv1d_fused_bwd {tag} mamba2 train B4 L1024 D4352",
                      "conv1d_fused" if dtype != bf else "conv1d_fused_bwd_bf16",
                      lambda x=x, w=w, b=b, g=g: conv_bwd.conv1d_fused_bwd_call(
                          x, w, b, g, activation="silu"),
                      lambda x=x, w=w, b=b, g=g: conv1d_bwd_ref(g, x, w, b),
                      REL_TOL_KERNEL if dtype != bf else REL_TOL_MESH_BF16))
        # deepseek-v3's MLA prefill (q/k hd 192, v hd 128) in the model's layout
        q = draw((4, 700, 128, 192), dtype).transpose(1, 2)
        k = draw((4, 700, 128, 192), dtype).transpose(1, 2)
        v = draw((4, 700, 128, 128), dtype).transpose(1, 2)
        cases.append((f"flash_attention {tag} MLA B4 H128 S700 hd192/128",
                      "flash_attention" if dtype != bf else "flash_attention_bf16",
                      lambda q=q, k=k, v=v: flash_forward(q, k, v),
                      lambda q=q, k=k, v=v: attention_ref(q, k, v), tol))
        # gemma3-1b's global training layer, the backward
        q, k, v, do = (draw(s, dtype) for s in ((4, 4, 1024, 256), (4, 1, 1024, 256),
                                                 (4, 1, 1024, 256), (4, 4, 1024, 256)))
        o, lse = flash_kernel.flash_attention_call(q, k, v, causal=True, window=0,
                                                   return_lse=True)
        cases.append((f"flash_attention_bwd {tag} gemma3 train B4 S1024 hd256",
                      "flash_attention_bwd" if dtype != bf else "flash_attention_bwd_bf16",
                      lambda q=q, k=k, v=v, o=o, lse=lse, do=do: flash_bwd.flash_attention_bwd_call(
                          q, k, v, o, lse, do, causal=True, window=0),
                      lambda q=q, k=k, v=v, o=o, lse=lse, do=do: flash_attention_bwd_ref(
                          q, k, v, o, lse, do, causal=True, window=0),
                      REL_TOL_BWD if dtype != bf else REL_TOL_MESH_BF16))
        # zamba2-7b's decode MLP at B 4 (phases 4 and 17)
        xm = draw((4, 3584), dtype)
        w1, w3 = (draw((3584, 14336), dtype, 3584 ** -0.5) for _ in range(2))
        w2 = draw((14336, 3584), dtype, 14336 ** -0.5)
        cases.append((f"decode_mlp {tag} zamba2 B4 d3584 f14336", "decode_mlp",
                      lambda x=xm, a=w1, c=w3, d=w2: decode_mlp(x, a, c, d),
                      lambda x=xm, a=w1, c=w3, d=w2: decode_mlp_ref(x, a, c, d), tol))
    return cases


def mesh_kernels(cards: list, smi_lines: list) -> dict:
    """Phase 21 (a): every kernel on every distinct card of the mesh,
    against its plain version on that card, and bitwise the first card's
    output; the launches each card counted (comparison launches, not a
    path's)."""
    rows, first = [], {}
    for card in dict.fromkeys(cards):
        cases = mesh_kernel_cases(card)
        for name, stem, run, plain, tol in cases:
            before = _card_launches(stem)
            with torch.cuda.device(card):
                got, want = run(), plain()
            torch.cuda.synchronize(card)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(rel_err(g.float(), w.float()) for g, w in zip(got, want))
            on_card = all(g.device == card for g in got)
            host = [g.cpu() for g in got]
            same = all(torch.equal(a, b) for a, b in zip(host, first.setdefault(name, host)))
            launched = _launch_delta(stem, before)
            print(f"phase 21 (a) {card}: {name:52s} rel err vs plain {err:.3e} (tol {tol:g}); "
                  f"bitwise the first card's {same}; launches {launched}")
            if not (err < tol and on_card and same and launched.get(str(card), 0) >= 1):
                raise AssertionError(f"phase 21 (a) {name} on {card}: rel {err:.3e}, on card "
                                     f"{on_card}, bitwise {same}, launches {launched}")
            rows.append(dict(card=str(card), kernel=name, rel=err, bitwise=same))
        del cases
        gc_collect()
    print(f"phase 21 (a): {len(rows)} kernel runs on {len(set(cards))} distinct card(s): "
          f"{smi_lines}")
    return dict(rows=rows, worst=max(r["rel"] for r in rows))


def _vgg_wave(rows: int, seed: int, ragged: bool = False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 64, 64, 3)) * 0.1).astype(np.float32)
    if not ragged:
        return x, None
    sizes = np.array([[64, 64], [48, 48], [32, 32], [64, 48]] * (rows // 4), np.int32)
    sizes[-1] = 0
    return x, sizes


def _wave_ms(fn, reps: int = MESH_REPS) -> tuple:
    """(median CUDA-event ms on cuda:0, median host wall ms, median host
    issue ms: until `fn` returned, before the synchronize) of `reps`
    waves after two warm ones; the host input and the output's place on
    the wave's card both inside."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev, wall, issue = [], [], []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        t0.record()
        fn()
        issue.append((time.perf_counter() - w0) * 1e3)
        t1.record()
        t1.synchronize()
        wall.append((time.perf_counter() - w0) * 1e3)
        ev.append(t0.elapsed_time(t1))
    return statistics.median(ev), statistics.median(wall), statistics.median(issue)


def mesh_waves(cards: list, smi: str) -> dict:
    """Phase 21 (b) and (c): vgg_mixed_channel(3)'s waves on the mesh path
    against the unsharded wave, their latency at N = 1, 2, 4 entries and
    the tile launches each card made; then both weight placements."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights
    from repro_torch.convserve.fleet import (
        REPLICATE, SHARD, ShardedWaveExecutor, apply_placement, plan_weight_placement)
    from repro_torch.core import analysis
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels.fused_tile import kernel as tile_kernel

    spec = vgg_mixed_channel(3)
    ws = init_weights(spec, seed=0)
    engine = Engine(hw=analysis.H100_SXM, device=cards[0])
    net = engine.compile(spec, ws, input_hw=(64, 64))
    sharded = {n: ShardedWaveExecutor(engine.compile(spec, ws, plan=net.plan, input_hw=(64, 64)),
                                      shards=n, mesh=Mesh({"data": n}, devices=cards[:n]))
               for n in MESH_NS}
    waves = {rows: _vgg_wave(16 if rows == "ragged 16" else rows, seed=21,
                             ragged=rows == "ragged 16") for rows in MESH_WAVES + ("ragged 16",)}
    refs = {rows: net(x, sizes) for rows, (x, sizes) in waves.items()}
    ys, by_card = {}, {}

    def wave(rows, n):
        x, sizes = waves[rows]
        before = _card_launches("fused_tile")
        ys[rows, n] = sharded[n](x, sizes)
        torch.cuda.synchronize()
        if rows != "ragged 16":
            by_card[f"{rows} rows N={n}"] = _launch_delta("fused_tile", before)

    for rows in waves:  # N = 1: one shard, the replica's own net
        wave(rows, 1)
    tile_kernel.LAUNCHES = 0  # main path: count only the mesh path's waves
    for rows in waves:
        for n in MESH_NS[1:]:
            wave(rows, n)
    launches = tile_kernel.LAUNCHES
    checks, lat, worst, bitwise, total = {}, {}, 0.0, 0, 0
    for (rows, n), y in ys.items():
        err = rel_err(y, refs[rows])
        worst, total = max(worst, err), total + 1
        bitwise += bool(torch.equal(y, refs[rows]))
        checks[f"{rows} rows N={n}"] = err <= REL_TOL_SHARD and y.device == refs[rows].device
    paths = {n: sh.stats()["sharded_waves"] for n, sh in sharded.items()}
    for rows in MESH_WAVES:
        x, _ = _vgg_wave(rows, seed=22)
        for n, sh in sharded.items():
            lat[rows, n] = _wave_ms(lambda sh=sh, x=x: sh(x))
    for rows in MESH_WAVES:
        print(f"phase 21 (b) vgg wave of {rows} rows: " + "; ".join(
            f"N={n} {lat[rows, n][0]:.4f} ms events, {lat[rows, n][1]:.4f} ms host wall, "
            f"{lat[rows, n][2]:.4f} ms host issue, tile launches by card "
            f"{by_card[f'{rows} rows N={n}']}" for n in MESH_NS))
    print(f"phase 21 (b): {total} waves (4/16/64 rows and ragged 16 at N = 1, 2, 4) vs the "
          f"unsharded wave: worst rel {worst:.3e} (tol {REL_TOL_SHARD:g}), bitwise {bitwise} of "
          f"{total}; tile launches of the mesh path's checked waves (N = 2, 4) {launches}; "
          f"waves by path {paths}; median of {MESH_REPS} (CUDA events on cuda:0, host input "
          f"to output on cuda:0); card {smi}")
    checks["mesh waves counted"] = all(p["mesh"] >= 1 for n, p in paths.items() if n > 1)
    checks["N=1 never took the mesh path"] = paths[1]["mesh"] == 0

    # (c) placement on the 4-entry mesh: none, REPLICATE, SHARD, the decision
    sh4, mesh4 = sharded[4], sharded[4].mesh
    x, _ = _vgg_wave(64, seed=23)
    y0 = sh4(x)
    placements = {}
    for label, threshold in (("unplaced", None), ("replicate", 1 << 40), ("shard", 1),
                             ("decision 1 MiB", 1 << 20)):
        counts = None
        if threshold is not None:
            decision = plan_weight_placement(sh4.net, threshold_bytes=threshold)
            counts = apply_placement(sh4.net, mesh4, decision)
        before = engine.cache.placement_stats()
        y = sh4(x)
        torch.cuda.synchronize()
        after = engine.cache.placement_stats()
        moved = after["moved_bytes"] - before["moved_bytes"]
        ms = _wave_ms(lambda: sh4(x))
        entries = [engine.cache._store[k] for k in sh4.cache_keys()]
        share = [e.bytes_at(i) / e.nbytes for e in entries if hasattr(e, "bytes_at")
                 for i in range(mesh4.size)]
        placements[label] = dict(counts=counts, resident=after["resident_bytes"],
                                 moved_bytes_a_wave=moved, ms=ms, bitwise=torch.equal(y, y0))
        print(f"phase 21 (c) {label:14s}: apply_placement {counts}; resident transform bytes "
              f"by card {after['resident_bytes']}; bytes brought from other cards a 64-row wave "
              f"{moved} (gathers {after['gathers'] - before['gathers']}, copies "
              f"{after['copies'] - before['copies']}); per-position share of each entry "
              f"{sorted(set(round(s, 4) for s in share)) or '-'}; wave {ms[0]:.4f} ms events, "
              f"{ms[1]:.4f} ms host wall, {ms[2]:.4f} ms host issue; output bitwise the "
              f"unplaced one {placements[label]['bitwise']}")
        checks[f"placement {label} leaves the output"] = placements[label]["bitwise"]
        if label == "shard":
            checks["SHARD keeps 1/4 a position"] = share and all(abs(s - 0.25) < 1e-9
                                                                  for s in share)
        if label == "replicate":
            checks["REPLICATE keeps the whole a position"] = share and all(s == 1.0 for s in share)
    dec = plan_weight_placement(sh4.net)
    checks["the decision shards and replicates"] = {d["placement"] for d in dec.values()} == {
        SHARD, REPLICATE}
    return dict(checks=checks, latency={f"{r} rows N={n}": v for (r, n), v in lat.items()},
                worst=worst, bitwise=bitwise, total=total, placements=placements,
                launches=launches, by_card=by_card)


def mesh_pool(cards: list, smi: str) -> dict:
    """Phase 21 (d): an `ElasticPool` of 2 replicas on the 4-entry mesh,
    4 shards each, on phase 12's exactness trace, against 1 replica x 1
    shard; SimClock, as phase 12."""
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights
    from repro_torch.convserve.fleet import ElasticPool, FixedServiceModel, FleetRuntime
    from repro_torch.convserve.runtime import (
        RuntimeConfig, SimClock, make_images, poisson_trace)
    from repro_torch.core import analysis
    from repro_torch.distributed.sharding import Mesh

    spec = vgg_mixed_channel(3)
    ws = init_weights(spec, seed=0)
    trace = poisson_trace(45.0, 60, seed=FLEET_SEED, sizes=(32, 48, 64), deadline_s=0.08)
    images = make_images(trace, spec.conv_layers()[0][1].c_in, seed=1)
    cfg = RuntimeConfig(max_batch=4, buckets=(FLEET_SIDE,), queue_depth=128, slo_s=0.1,
                        service_est_s=0.01)
    out = {}
    for label, n, shards, mesh in (("mesh 2x4", 2, 4, Mesh({"data": 4}, devices=cards)),
                                   ("oracle 1x1", 1, 1, None)):
        clock = SimClock()
        pool = ElasticPool.build(Engine(hw=analysis.H100_SXM, device=cards[0]), spec, ws, n=n,
                                 clock=clock, input_hw=(FLEET_SIDE, FLEET_SIDE), shards=shards,
                                 mesh=mesh, max_replicas=n, startup_s=1.0,
                                 service_model=FixedServiceModel(**FLEET_SERVICE))
        rt = FleetRuntime(pool, cfg, clock=clock)
        rt.warmup([2, 4])
        out[label] = (rt.play(trace, images), rt, pool)
    (got, rt, pool), (want, _, _) = out["mesh 2x4"], out["oracle 1x1"]
    worst, bitwise = 0.0, 0
    for rid, ref in want.items():
        y = got.get(rid)
        if y is None:
            worst = float("inf")
            continue
        bitwise += bool(np.array_equal(y, ref))
        worst = max(worst, float(np.abs(y.astype(np.float64) - ref).max()
                                 / (np.abs(ref).max() + 1e-30)))
    waves = [r.executor.stats()["sharded_waves"] for r in pool.replicas]
    mesh_w, logical_w = sum(w["mesh"] for w in waves), sum(w["logical"] for w in waves)
    print(f"phase 21 (d) ElasticPool of 2 replicas x 4 shards on the mesh, {len(trace)} "
          f"requests (phase 12's exactness trace): vs 1 replica x 1 shard worst rel "
          f"{worst:.3e} (tol {REL_TOL_SHARD:g}), bitwise {bitwise} of {len(want)}; waves mesh "
          f"{mesh_w}, logical {logical_w}; partial waves "
          f"{rt.stats()['scheduler']['partial_waves']}; errors {len(rt.errors)}; card {smi}")
    ok = (got.keys() == want.keys() == {a.rid for a in trace} and worst <= REL_TOL_SHARD
          and mesh_w >= 1 and not rt.errors)
    return dict(ok=ok, worst=worst, bitwise=bitwise, mesh_waves=mesh_w, logical_waves=logical_w)


def mesh_cp(cards: list, smi: str) -> dict:
    """Phase 21 (e): gemma3-1b at full width on CP_LAYERS layers, fp32,
    B 4 x S 700, its logits with q stripes over a 4-entry model axis
    against the whole chunked attention (no mesh in effect)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import Mesh, use_mesh
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import init_lm, lm_logits
    from repro_torch.models import runtime_flags as rf

    cfg = dataclasses.replace(get_arch("gemma3-1b"), n_layers=CP_LAYERS, dtype="float32")
    published_width(cfg, (1152, 4, 256, 6912))
    model = init_lm(cfg, seed=0, device=cards[0])
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (CP_BATCH, CP_SEQ))).to(cards[0])
    calls = []
    real = attn_mod.chunked_attention

    def counted(q, *a, **kw):
        calls.append((str(q.device), int(q.shape[1])))
        return real(q, *a, **kw)

    runs = {}
    attn_mod.chunked_attention = counted
    try:
        with rf.overrides(attention_cp_axis="model"):
            for label, mesh in (("whole", None),
                                ("q stripes", Mesh({"data": 1, "model": MESH_ENTRIES},
                                                   devices=cards))):
                calls.clear()
                flash_kernel.LAUNCHES = 0
                with torch.no_grad(), use_mesh(mesh):
                    lm_logits(model, toks)  # warm
                    torch.cuda.synchronize()
                    w0 = time.perf_counter()
                    y = lm_logits(model, toks)
                    torch.cuda.synchronize()
                runs[label] = dict(y=y, ms=(time.perf_counter() - w0) * 1e3,
                                   calls=list(calls[len(calls) // 2:]),
                                   flash=flash_kernel.LAUNCHES)
    finally:
        attn_mod.chunked_attention = real
    rel = rel_err(runs["q stripes"]["y"], runs["whole"]["y"])
    finite = bool(torch.isfinite(runs["q stripes"]["y"]).all())
    stripes = runs["q stripes"]["calls"]
    print(f"phase 21 (e) gemma3-1b CP, full width, {CP_LAYERS} layers, fp32, B {CP_BATCH} x S "
          f"{CP_SEQ}: q stripes over {MESH_ENTRIES} entries vs whole rel {rel:.3e} (tol "
          f"{REL_TOL_CP:g}), finite {finite}; stripes (card, rows) of layer 0 "
          f"{stripes[:MESH_ENTRIES]}; flash launches {runs['q stripes']['flash']}; host wall "
          f"{runs['q stripes']['ms']:.3f} ms split vs {runs['whole']['ms']:.3f} ms whole; "
          f"card {smi}")
    ok = (rel <= REL_TOL_CP and finite and len(stripes) == MESH_ENTRIES * CP_LAYERS
          and len(runs["whole"]["calls"]) == CP_LAYERS and runs["q stripes"]["flash"] == 0
          and [c for c, _ in stripes[:MESH_ENTRIES]] == [str(c) for c in cards])
    del model, runs
    return dict(ok=ok, rel=rel)


def phase_mesh(smi: str) -> dict:
    """Phase 21 (module docstring): the multi-card mesh."""
    t_phase = time.perf_counter()
    gc_collect()
    n = torch.cuda.device_count()
    cards = mesh_cards()
    smi_lines = card_table()
    shared = len(set(cards)) < len(cards)
    print(f"phase 21: {n} visible card(s); mesh of {MESH_ENTRIES} entries on "
          f"{[str(c) for c in cards]}"
          + (f" -- entries SHARE cards ({len(set(cards))} distinct): placements and waves are "
             "exercised, not spread" if shared else " -- every entry its own card"))
    for line in smi_lines:
        print(f"phase 21 nvidia-smi: {line}")
    out = {}
    for part, fn in (("kernels", lambda: mesh_kernels(cards, smi_lines)),
                     ("waves", lambda: mesh_waves(cards, smi)),
                     ("pool", lambda: mesh_pool(cards, smi)),
                     ("cp", lambda: mesh_cp(cards, smi))):
        t0 = time.perf_counter()
        out[part] = fn()
        print(f"phase 21: {part} in {time.perf_counter() - t0:.2f} s")
        gc_collect()
    checks = dict(out["waves"]["checks"])
    checks["the pool on the mesh within 1e-5 of one replica"] = out["pool"]["ok"]
    checks["CP q stripes within 1e-5 of the whole"] = out["cp"]["ok"]
    failed = [k for k, ok in checks.items() if not ok]
    wall = time.perf_counter() - t_phase
    print(f"phase 21: phase wall time {wall:.2f} s (limit {PHASE21_LIMIT_S:g} s); checks "
          f"{'all pass' if not failed else 'FAILED: ' + ', '.join(failed)}")
    if failed:
        raise AssertionError(f"phase 21 failed: {failed}")
    if wall > PHASE21_LIMIT_S:
        raise AssertionError(f"phase 21 took {wall:.1f} s > {PHASE21_LIMIT_S:g} s")
    out.update(seconds=wall, cards=n, distinct=len(set(cards)))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--coll-rank" in argv:  # a rank of phase 20 (e), started by phase 20
        opt = dict(zip(argv[::2], argv[1::2]))
        return coll_child(int(opt["--coll-rank"]), int(opt["--coll-world"]), opt["--coll-store"],
                          opt.get("--coll-backend", "gloo"))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  -- fail before printing without the repo

    os.environ["REPRO_WISDOM"] = PLAN_WISDOM  # read and written under build/ only
    if os.path.exists(PLAN_WISDOM):
        os.unlink(PLAN_WISDOM)
    t_start = time.perf_counter()

    def stamp(phases: str) -> None:
        print(f"chip_smoke: phases {phases} done at {time.perf_counter() - t_start:.1f} s")

    smi = phase_environment()
    if argv == ["--phase", "3"]:  # the tile kernel's checks again and again: no result lines
        phase3_rounds()
        print(f"chip_smoke: --phase 3 done at {time.perf_counter() - t_start:.1f} s")
        return 0
    bwd_ptxas = phase_build()
    if argv == ["--ssm-chunk-gap"]:  # the study behind phase 20's chunk tolerance
        return ssm_chunk_gap(smi)
    if argv == ["--chunk-remat-cost"]:  # what the default per-chunk remat costs a step
        return chunk_remat_cost(smi)
    if argv == ["--phase", "20"]:  # phase 20 alone, for development: no result lines
        phase_flags(smi)
        print(f"chip_smoke: --phase 20 done at {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv == ["--phase", "21"]:  # phase 21 alone (a four-card call): no result lines
        phase_mesh(smi)
        print(f"chip_smoke: --phase 21 done at {time.perf_counter() - t_start:.1f} s")
        return 0
    phase_check()
    cases, worst_abs, worst_rel = phase_kernel_vs_plain()
    oracle = phase_winograd_and_oracle()
    lm_cases, lm_worst = phase_lm_kernels_vs_plain()
    stamp("1-4")
    served = phase_serve()
    lm_served = phase_serve_lm()
    phase_lm_vs_cpu(lm_served)
    stablelm = phase_stablelm_vs_cpu()
    conv1d_prefill = phase_lm_profile(lm_served)
    rows = phase_times(cases, served)
    lm_rows = phase_lm_times(lm_cases)
    del cases, lm_cases  # their card tensors (~2 GiB): room for phase 14
    stamp("5-9")
    online = phase_online(smi)
    adapt = phase_adapt(online["hw"], smi)
    fleet = phase_fleet(online["hw"], smi)
    stamp("10-12")
    for s in lm_served.values():
        s.pop("model")  # the served weights: room for training
    gc_collect()
    train = phase_train(smi, bwd_ptxas)
    stamp("13")
    moon = phase_moonshot(smi)
    deep = phase_deepseek(smi)
    seam = phase_seamless(smi)
    stamp("14-16")
    fp32 = {arch: lm_served[arch] for arch in LM_ARCHS}
    fp32[MOON] = dict(peak_bytes=moon["serve"]["peak_bytes"],
                      wave_stats=moon["serve"]["wave_stats"],
                      note=f", {MOON_SERVE_LAYERS} of 48 layers")
    bf16 = phase_bf16(smi, fp32)
    stamp("17")
    ssm = train["ssm"]
    btrain = phase_bf16_train(smi, {
        "gemma3-1b": dict(label="(26 layers)", history=train["run"]["history"]),
        "mamba2-1.3b": dict(label=f"({MAMBA_FP32_LAYERS} layers)",
                            history=ssm["mamba2-1.3b"]["history"])})
    stamp("18")
    phase_tools(smi, btrain["runs"]["gemma3-1b"])
    stamp("19")
    phase_flags(smi)
    stamp("20")
    mesh = phase_mesh(smi)
    stamp("21")
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s")

    # headline shape: the widest served vgg layer when vgg reaches the
    # kernel (64->64 at bucket 64), else fft_fewchannel's 8->8
    vgg_fused = served["vgg-mixed"]["fused"]
    head_label = "vgg b64 64->64@64" if vgg_fused else "fft b64 8->8@64 +bias+relu"
    head = next(r for r in rows if r["label"] == head_label)
    kernels = {"kernels": [{
        "name": "fused_tile",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": (sum(s["launches"] for s in served.values()) + online["launches"]
                     + adapt["launches"] + fleet["launches"] + mesh["waves"]["launches"]),
        "launches_by_path": {**{k: s["launches"] for k, s in served.items()},
                             "online vgg-mixed (ServeRuntime)": online["launches"],
                             "adapt fft-fewchannel (AdaptController)": adapt["launches"],
                             "fleet vgg-mixed (ElasticPool)": fleet["launches"],
                             "mesh vgg-mixed (ShardedWaveExecutor)": mesh["waves"]["launches"]},
        "launches_per_wave": {k: s["per_wave"] for k, s in served.items()},
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "max_rel_err_l3_fused_pallas": oracle["l3_fused_pallas"],
        "max_rel_err_vs_f64_scan": {k: v for k, v in oracle.items() if k.startswith("oracle")},
        "shape": head_label,
        "ms": head["ms"],
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]}
    # every LM path's counts, each read over its own run
    paths = {f"serve {arch}": lm_served[arch]["launches"] for arch in LM_ARCHS}
    paths.update({"train gemma3-1b": train["run"]["launches"],
                  f"train mamba2-1.3b ({MAMBA_FP32_LAYERS} layers)": ssm["mamba2-1.3b"]["launches"],
                  f"train zamba2 ({ZAMBA_TRAIN_LAYERS} layers)": ssm["zamba2"]["launches"],
                  f"serve {MOON} ({MOON_SERVE_LAYERS} layers)": moon["serve"]["launches"],
                  f"train {MOON} ({MOON_TRAIN_LAYERS} layers)": moon["train"]["launches"],
                  f"serve {DS} ({DS_SERVE_LAYERS} layer)": deep["serve"]["launches"],
                  f"train {DS} (1 layer + MTP, {DS_TRAIN_EXPERTS} experts)":
                      deep["train"]["launches"],
                  f"serve {SEAMLESS}": seam["serve"]["launches"],
                  f"train {SEAMLESS}": seam["train"]["launches"]})

    def by_path(kernel):
        return {path: n[kernel] for path, n in paths.items() if n[kernel]}

    # the bf16 runs count under each kernel's `bf16` entry (its bf16 source's
    # launches), the fp32 runs under the kernel itself
    bf16_paths = {f"serve {arch} bf16": s["launches"] for arch, s in bf16["serve"].items()}
    bf16_paths.update({f"train {name} bf16": r["launches"] for name, r in btrain["runs"].items()})

    bf16_sources = {"flash_attention": FLASH_BF16_SOURCE,
                    "flash_attention_bwd": FLASH_BWD_BF16_SOURCE,
                    "conv1d_fused": CONV1D_FWD_BF16_SOURCE,
                    "conv1d_fused_bwd": CONV1D_BWD_BF16_SOURCE}

    def bf16_entry(kernel):
        """The kernel's bf16 instantiation: its source, its launches on the
        bf16 serving runs, its served row's numbers and every bf16 shape's."""
        rows = (bf16 if kernel in bf16["kernels"] else btrain)["kernels"][kernel]
        by = {path: n.get(kernel, 0) for path, n in bf16_paths.items() if n.get(kernel, 0)}
        source = bf16_sources[kernel] if kernel in bf16_sources else LM_KERNELS[kernel][0]
        return dict(route="cuda", source=source, launches=sum(by.values()), launches_by_path=by,
                    **{**rows.get("served", rows["shapes"][0]), "max_abs_err": rows["max_abs_err"]},
                    shapes=rows["shapes"])

    for name, (source, replaces) in LM_KERNELS.items():
        arch = "mamba2-1.3b" if name == "conv1d_fused" else "gemma3-1b"
        run = lm_served[arch]
        per = run["steps"] if name == "decode_mlp" else run["waves"]
        kernels["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path(name).values()), launches_by_path=by_path(name),
            launches_per=(f"{run['launches'][name] / per:g} per "
                          f"{'decode step' if name == 'decode_mlp' else 'prefill wave'} "
                          f"of {arch}"),
            max_abs_err=lm_worst[name][0], max_rel_err=lm_worst[name][1],
            **lm_rows[name],
            **(conv1d_prefill.get(arch, {}) if name == "conv1d_fused" else {}),
        ))
        kernels["kernels"][-1]["bf16"] = bf16_entry(name)
        if f"{name}_zamba2" in lm_rows:
            kernels["kernels"][-1]["zamba2"] = lm_rows[f"{name}_zamba2"]
        if name == "flash_attention":
            kernels["kernels"][-1].update(
                launches_stablelm_cut=stablelm["flash_attention"],
                hd80=lm_rows["flash_attention_hd80"],
                moonshot=lm_rows["flash_attention_moonshot"],
                mla=lm_rows["flash_attention_mla"], mtp=lm_rows["flash_attention_mtp"],
                seamless_encoder=lm_rows["flash_attention_seamless_encoder"],
                seamless_decoder=lm_rows["flash_attention_seamless_decoder"],
                seamless_cross=lm_rows["flash_attention_seamless_cross"],
                seamless_decode=lm_rows["flash_attention_seamless_decode"],
                seamless_decoder_train=lm_rows["flash_attention_seamless_decoder_train"],
                seamless_cross_train=lm_rows["flash_attention_seamless_cross_train"],
                launches_per_train_step=train["run"]["launches"][name] / TRAIN_STEPS)
        if name == "decode_mlp":
            kernels["kernels"][-1]["seamless"] = lm_rows["decode_mlp_seamless"]
        if name == "conv1d_fused":
            kernels["kernels"][-1].update(
                launches_per_train_step=ssm["mamba2-1.3b"]["launches"][name] / TRAIN_STEPS,
                train_step_device_ms=ssm["mamba2-1.3b"]["profile"].get("conv1d_fused_kernel"))
    tw = train["worst"]
    kernels["kernels"].append(dict(
        name="flash_attention_bwd", route="cuda", source=FLASH_BWD_SOURCE,
        replaces=FLASH_BWD_REPLACES,
        launches=sum(by_path("flash_attention_bwd").values()),
        launches_by_path=by_path("flash_attention_bwd"),
        launches_per=(f"{train['run']['launches']['flash_attention_bwd'] / TRAIN_STEPS:g} "
                      "per train step of gemma3-1b"),
        max_abs_err=tw["abs"], max_rel_err=tw["rel"], max_rel_err_lse=tw["lse"],
        max_rel_err_vs_f64=tw["f64_kernel"], max_rel_err_plain_vs_f64=tw["f64_plain"],
        **train["times"],
        train_step_device_ms=train["profile"].get("flash_bwd"),
        bf16=bf16_entry("flash_attention_bwd"),
    ))
    cw, mp = train["conv"], ssm["mamba2-1.3b"]["profile"]
    kernels["kernels"].append(dict(
        name="conv1d_fused_bwd", route="cuda", source=LM_KERNELS["conv1d_fused"][0],
        replaces=CONV1D_BWD_REPLACES,
        replaces_note="XLA's gradient of the reference's conv + SiLU; no Pallas kernel "
                      "trains in the reference",
        launches=sum(by_path("conv1d_fused_bwd").values()),
        launches_by_path=by_path("conv1d_fused_bwd"),
        launches_per=(f"{ssm['mamba2-1.3b']['launches']['conv1d_fused_bwd'] / TRAIN_STEPS:g} "
                      f"per train step of mamba2-1.3b on {MAMBA_FP32_LAYERS} layers"),
        max_abs_err=cw["worst"]["abs"], max_rel_err=cw["worst"]["rel"],
        **cw["backward"],
        train_step_device_ms=mp.get("conv1d_bwd"),
        events_ms_a_train_step=mp.get("conv1d_backward_ms_a_step"),
        bf16=bf16_entry("conv1d_fused_bwd"),
    ))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
