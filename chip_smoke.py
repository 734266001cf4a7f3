#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, holds each
against its plain version, transcribes a batch (in full precision, and with
the int8 encoder and the fused conv front-end, and best-of-4), takes encoder
fine-tune steps, runs the four evaluators, runs the inference CLI from a
YAML config, serves requests through the batching HTTP server, exports,
loads and serves the AOT artifacts as CUDA graphs, trains through the
training entry point, over several processes, and runs the offline
workflow, the user scripts, the host tools and the profilers, all at full
model width.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernel is built for sm_90a) and nvcc; imports
only the port (`fddm_asr_tpu_torch`), torch, numpy and the standard library.
Phases, each fatal on failure:

  1. the card's name and power limit (nvidia-smi); build every kernel
     from `fddm_asr_tpu_torch/csrc/` with nvcc (one process per source, in
     parallel), timed; the SASS (`cuobjdump -sass`) of the float32 forward,
     of float32 B4, of float32 B5's two kernels and of float32 B8 (its erf
     and tanh builds) must hold tf32 HGMMA and no other (they run 3xTF32 on
     the tensor cores), and float32 B8's few FFMAs only (its epilogue's: no
     scalar FMA main loop);
  2. kernel vs plain version at B=8, H=16, dh=64 on both sides of the TPU
     kernels' 4096-frame split (L=1024, 4224), float32 and bfloat16, with
     ragged key masks and one all-masked row, and at phase 15 (c)'s
     whole-file shape (B=1, L=5120, 4999 valid keys) and at phase 16's
     served batches (B=16, L=1024: 12 requests of its load and 4 pad rows;
     B=4, L=1536: the four 30 s windows of its 100 s recording); float32
     within 1e-4, bfloat16 within 3e-2 or one bf16 ulp of the plain value
     (the two round one f32 value to bf16, an ulp apart at worst, and an
     ulp is 0.03125 where outputs reach 4); the kernel's time
     beside the plain version's, one `scaled_dot_product_attention` call's (a yardstick
     the port never calls, with the name of the device kernel it ran) and
     the card's least possible time (bound; in float32 also `bound_tc_ms`,
     the products three times over at the dense tf32 rate); then, untimed,
     at the edges of both kernels' 128-query blocks and 64-key steps (each
     +-1) and at L whose bias rows are not 16-byte aligned, with lse, under
     the same bounds;
  3. a small float32 pipeline (64-wide WavLM heads) transcribes the same
     batch and x_T on the card and on the CPU from the same weights: the
     token ids must be identical; the same with the batch as int16 pcm16
     and as uint8 mu-law codes (decoded on the pipeline's device); then
     `transcribe_nbest` with N = 4 at an injected [B*N, L] x_T (the same
     candidates, confidences within 1e-5) and the windows
     `plan_silence_chunks` cuts from a 3.3 s recording, as one
     condition-masked batch (the same ids);
  4. full-width transcription: WavLM-large + the d768x6 decoder, K=8000,
     T=200, bf16, random weights from a seeded generator and a synthetic
     8000-piece tokenizer; 8 x 20 s of synthetic audio through
     `FDDMPipeline.transcribe_with_ids` (T_infer=20, r=5, exact, greedy,
     seq_len=64) with the kernel's launch count checked at 24 per encode;
     the encoder's output with the kernel held against the same encoder
     with the plain attention; one more transcribe under torch.profiler
     for the device time by kernel and the device's idle share; then the
     same transcribe at model.dtype float32 (`transcribe_f32`: B1 in f32
     24 times, wall, busy time, the f32 kernel's device time, its ids
     beside the bf16 run's), and once more under `fused_frontend: true`
     (`transcribe_f32_fused_frontend`: B8 in f32 6 times, B1 24; wall,
     busy time, B8's device time, the encoder's output against the unfused
     float32 transcribe's within ENCODER_F32_FUSED_REL_L2, its ids beside
     `transcribe_f32`'s);
  5. the training kernels (B3 forward + logsumexp, B4 dq/dgate, B5
     dk/dv/dbias) against their plain versions and against autograd of the
     plain forward: first at the shape phase 7 gives them (B=32, H=16,
     dh=64, L=1024 with 999 valid keys in every row, bfloat16), then at
     B=8, L=1024, 384, 203, float32 and bfloat16, ragged key masks and one
     all-masked row, then untimed at the edges of B4's and B5's tiles (L =
     31, 32, 33, 63, 64, 65, 127, 128, 129, 203, 1000, 1024; B=1 and B=3,
     bfloat16 and float32); B4 and B5 are each called twice each time and their
     outputs must agree bit for bit; at L=1024 each kernel's time beside the plain version's, a
     library yardstick (one `scaled_dot_product_attention` call, and
     autograd of it for the backward pair; the port calls neither) and the
     bound; the kernels line takes the B=32 numbers;
  6. a small float32 encoder fine-tune step (64-wide WavLM heads, so
     attention takes the kernels) on the card and on the CPU from the same
     weights and the same injected t, x_t and time mask: loss, pre-clip
     gradient norm, every gradient, the updated parameters and the
     kernels' launch counts;
  7. full-width encoder fine-tune (configs/fddm_zhTW_finetune.yaml over
     fddm_zhTW_base.yaml: WavLM-large trained with remat, SpecAugment time
     masks and a frozen conv front-end, d768x6 decoder, K=8000, T=200,
     bf16, AdamW in two groups, EMA, L_fd every 4 steps), random weights,
     32 x 20 s of synthetic audio with random 128-token targets: two
     warm-up steps (with and without L_fd), then one L_fd period of 4
     timed steps with the kernels' launches checked per step (B3 47, B4
     24, B5 24 with 23 of 24 layers recomputed), peak memory, one more
     step under torch.profiler (each port kernel's time per launch there
     beside phase 5's, B5's two kernels by name, and the device time of the
     plain-torch delta = rowsum(dO O) ops before B4 and B5); the loss
     finite, encoder and decoder weights moved, the conv front-end's not;
  8. the fused int8 matmul (B7) against its plain version at M = 8192 rows
     for WavLM-large's three dense shapes (1024x1024, 1024x4096,
     4096x1024), bfloat16 and float32, with and without bias, at M = 1024
     (one 20 s utterance) in bfloat16 with bias, and at a ragged size (51
     rows, dout 136): the integers are exact in both, so the outputs must
     agree within one ulp of the output type; its time (CUDA events over
     back-to-back calls, as every kernel's) beside its device time
     (profiler), its workspace, the plain version's time, the library path's (row quantization in torch +
     `torch._int_mm` + epilogue, the port's own `int8` mode), one bf16
     `F.linear`'s (the yardstick: the matmul int8 replaces) and the bound;
  9. the fused conv+LayerNorm+GELU (B8) against its plain version at B = 8,
     512 channels, at the six front-end layers' shapes of an 8 x 20 s
     transcribe ((k, s) = (3, 2) at T = 63999, 31999, 15999, 7999 and (2, 2)
     at T = 3999, 1999) in bfloat16 with tanh GELU, as the fused
     configuration runs them, and at layers 1 and 6 also with erf and in
     float32; bfloat16 within 3e-2 abs + one bf16 ulp of the value (outputs
     reach past 4, where an ulp is 0.03125), float32 within 2e-4 abs + 1e-3
     rel; and at inputs that give no and one output row; each time (CUDA
     events over back-to-back calls) beside its device time (profiler), the
     plain version's, `F.conv1d` + `F.layer_norm` + `F.gelu`'s and the
     bound, and the six bfloat16 times summed over one transcribe beside
     phase 12's profiled B8 time;
 10. `wavlm_gated_attention` on [B, L, H, dh] operands (B6's entry point,
     which no model path reaches, as in the JAX package): driven once
     through the dispatcher with its count read, held against its plain
     version at B = 8, L = 1024, H = 16 in both types, and timed;
 11. a small float32 pipeline under `quant_dense: int8_fused`,
     `fused_frontend: true` and `model.quant_dense: int8` (128 conv
     channels, 64-wide heads) on the card and on the CPU from the same
     weights, with the launches of B1, B7 and B8 checked.  A value whose
     scaled size falls within f32 rounding of a half rounds to another
     integer on the card than on the CPU (sums run in another order), and
     one such step is 1/127 of a row's largest value; so the pass rule,
     fixed before the first run, is the encoder's output within 5e-2 max
     abs (unit-scale output; a fault gives O(1)); the token ids are
     compared and printed, with the CPU's top-two probability margin where
     they differ, and do not decide;
 12. full-width transcription as in phase 4 under `encoder.wavlm_config:
     {quant_dense: int8_fused, fused_frontend: true, gelu_approx_tanh:
     true}` with the launches checked (B1 24, B7 144, B8 6), wall median,
     RTFx, peak memory and one profiled run (`transcribe_int8_fused`), and
     the same under `quant_dense: int8` (the library path,
     `transcribe_int8`) and `quant_dense: none` (`transcribe_fused_frontend`:
     the front-end and tanh GELU alone), and phase 4's own configuration
     once more (`transcribe_repeat`: the wall times of this phase compare
     with it, not with phase 4's, because the host's share grows over the
     process); the encoder's output under int8_fused against that
     full-precision encoder: rel-L2 below 0.05 and above 1e-6 (the flag
     must change the output).

 13. `nbest`: phase 4's batch, weights and sampling best-of-4
     (`transcribe_with_ids(num_candidates=4)`), timed as phase 4: B1 24
     launches (the encoder runs once), four decoder calls of 32 rows, the
     rows the most confident of `transcribe_nbest`'s candidates; wall,
     RTFx, peak memory and busy time beside phase 4's and phase 12's
     `transcribe_repeat`;
 14. `eval`: two batches of 8 x 20 s with 64-token targets through
     `evaluate_validation_loss`, `evaluate_validation_kl_sampled`,
     `evaluate_cer_with_full_sampling` and
     `evaluate_cer_with_multi_sample(voting="logprob", num_samples=3)`:
     each value (finite, positive), wall time and launches (B1 48 each);
 15. `cli`: `python3 -m fddm_asr_tpu_torch.inference` in a subprocess
     from configs/fddm_zhTW_base.yaml and configs/diffusion.yaml,
     `--wavlm-ckpt` an HF directory (config.json, pytorch_model.bin) of a seeded random
     WavLM-large, `--ckpt` a random decoder's bare state_dict: (a) a
     16-row CSV of 20 s WAVs with a `text` column, 8 a batch, bucketed,
     best-of-4 with confidence, ending in the CER summary line; (b) a 180 s
     WAV in silence-cut 20 s windows (9-10); (c) a 100 s WAV whole, 4999
     frames padded to 5120 (the TPU's B2 regime, past 4096). Each run's ids
     equal those of the CLI's own `transcribe` of the same arguments in
     this process, on the pipeline `build_pipeline` makes of them; each run's wall,
     RTFx and launches from `--stats-json` beside the in-process wall;
     (c) once more under the profiler (the kernel's time at L = 5120);
 16. `serve`: `fddm_asr_tpu_torch.serve` at full width on phase 15's
     decoder `.pt` and tokenizer (random encoder from the config's seed),
     built in this process by `build_server(parse_args([...]))` with
     `--max-batch 16 --max-wait-ms 20 --pipeline-depth 2 --bucket-seconds 1
     --max-seconds 30 --warmup-seconds 5,20`: (a) the warm-up's ten calls
     (B in 1..16 x 5 s, 20 s; B1 240 launches); (b) uploads of 0.02, 3.2,
     7.5 and 20 s one at a time, each a batch of one whose ids equal
     `transcribe_with_ids` on the same padded batch with the generator seeded
     at the engine's counter, and the JAX server's result keys; (c) every
     (Bp, T) bucket of 2-20 s warmed, then 256 uploads of 2-20 s by 16
     client threads, untraced: requests/s, audio s/s, latency p50/p95/p99,
     `/stats` over the window, B1 launches (24 a batch), peak memory,
     cold-shape batches; then 64 more under torch.profiler: busy time and
     idle share (device events); then one batch's dispatch timed with the
     engine idle and its syncs under sync debug mode; (d) a 100 s
     recording to `?stream=1` (a line per planned 30 s window, at least four,
     then the aggregate) and as chunked pcm16 to `/v1/transcribe/stream` at
     20 s windows (the committed chunks are the plan's windows and the
     aggregate equals `submit`'s at that window, batch and counter); every
     batch served in (b)-(d) recomputed as in (b); (e) `python3 -m
     fddm_asr_tpu_torch.serve` in a subprocess: start to ready, a request,
     `/healthz`, phase 23 (f)'s stream, exit 0 on SIGINT;
 17. `exported`: the AOT artifacts (`aot.py`) from phase 15's files: (a)
     `python3 -m fddm_asr_tpu_torch.export_model` in a subprocess from
     configs/fddm_zhTW_base.yaml, batches 1-16 x 10, 20 s (one program a
     duration, its batch dynamic), seq_len 128, pcm16, condition mask on,
     greedy: seconds a program, artifact bytes under 1.2 x the params'
     (no fresh loading process: (c) and (e) load the artifact in this
     process); (c) 8 x 20 s through the graph beside the eager `transcribe_with_ids` in this process: wall
     (median of 5), RTFx, busy time, idle share, host launches a call; (d)
     a second artifact under phase 12's wavlm_config, exported in a second
     subprocess beside (a)'s and checked in this process while (a)'s
     program is still traced (both end before (c)), bucket 8 x 20 s: ids
     equal to the live pipeline's, a replay counting and showing B1 24, B7
     144 and B8 6; (e) `serve --exported` in this process under phase 16
     (c)'s load (256 untraced, 64 traced uploads), then a 6 s upload alone
     (the 10 s program), every served batch's ids equal to the live
     pipeline's at the artifact's bucket and the engine's counter, each
     program serving batches, beside phase 16's numbers, and its `/healthz`
     naming every bucket as a graph; (c) and (e) share that one load, and
     the `python3 -m` entry point is phase 16 (e)'s (a process of its own
     here would add a fourth load, ~75 s);
 18. `train`: the training entry point on 64 train, 16 validation and 16
     test clips of 20 s (`synthetic_audio`, written with `save_wav`; texts
     of the 8000-piece tokenizer's pieces, 40-120 ids each) and phase 15's
     tokenizer and HF WavLM-large: the loader's encode time for a batch of
     32; (a) `python3 -m fddm_asr_tpu_torch.train` in a subprocess from
     configs/fddm_zhTW_base.yaml with `data.cache_features` (frozen
     decoder training, B = 16, 4 steps, `log_every: 1`, `metrics_jsonl`,
     `val_kl: sampled`): the cache built and device-resident, its seconds
     and bytes, steps/s, eval and checkpoint seconds and bytes; then
     `--resume ep001.state.pt` to two epochs, which must start at epoch 2
     and step 5 with the best_val_cer carried; (b) `train.main` in this
     process from configs/fddm_zhTW_finetune.yaml with `--wavlm-ckpt`, 12
     steps of 32 x 20 s (the train manifest six times over): B3, B4 and
     B5 per step equal to phase 7's, L_fd at steps 4, 8 and 12, B1 24 times
     an eval decode batch, examples/s over steps 3-8 from metrics.jsonl
     beside phase 7's bare step, steps 9-12 under the profiler (busy, idle
     share, host time in `host_to_device`; started after step 8's record,
     so the profiler stays out of the timed steps), how far the host runs
     ahead of the device at steps 4 and 8, peak memory, and the bytes and
     seconds of each checkpoint file; (c) `python3 -m fddm_asr_tpu_torch.inference --ckpt
     best_model.pt --encoder-ckpt best_model.encoder.pt` on 8 validation
     clips, whose ids equal those of the CLI's `transcribe` in this process
     on a pipeline carrying the EMA weights of `best_model.state.pt`; (b)'s
     optimizer and EMA bytes are kept for phase 19;
 19. `train_recipe`: the rest of the training recipe in this process, on
     phase 18's corpus and phase 15's tokenizer and HF WavLM-large: (a)
     `train.main` from configs/fddm_zhTW_finetune.yaml with LoRA (rank 8,
     alpha 16), grad_accum_steps 2, bfloat16 adam_mu_dtype and ema_dtype
     and log.async_checkpoint, 12 micro-steps of 32 x 20 s (phase 18 (b)'s
     windows): B3, B4 and B5 per micro-step equal to phase 7's, the adapter
     count that of the targeted layers' shapes, the optimizer and EMA bytes
     and peak memory beside phase 18 (b)'s full fine-tune, examples/s over
     micro-steps 3-8 and micro-steps 9-12 under the profiler (busy, idle
     share) beside (b)'s, each checkpoint's blocked seconds beside its
     files' write seconds and bytes; (b) `inference.main --encoder-ckpt best_model.encoder.pt
     --wavlm-ckpt ...` in this process on phase 18 (c)'s 8 validation clips, whose
     ids equal a pipeline's with the EMA adapters of best_model.state.pt
     merged by hand; (c) one step of phase 7's configuration under
     remat_policy full and under dots (step time, peak memory, launches),
     and one step of phase 6's small model with attention_dropout 0.1: a
     finite loss and no kernel launched (the plain path);
 20. `parallel`: several GPUs (`parallel/`), on this one card.  The
     one-rank reference: phase 7's fine-tune in float32 with dropout off,
     warmup 0, on a global batch of 8 x 20 s, the first step's gradients
     of four watched tensors, then 3 steps (L_fd on 1 and 3); (a) the same
     steps on a data=1 mesh over NCCL at world size 1 (the gradients go
     through the NCCL all-reduce): metrics, gradients and updated tensors
     as the bare step's; (b) two processes (`--parallel-rank`) sharing the
     card over gloo, CUDA tensors staged through pinned host memory: (b1)
     the steps on data=2, 4 rows a rank: each step's metrics within rtol
     1e-5 of the one rank's, the gradients within phase 6's tolerance and
     the updated tensors as phase 6 checks them, B3/B4/B5 a rank a step
     as phase 7's, each rank's peak memory and step time; (b2) the ring at
     ring 2 on B=2, L=5120 (f32, one row 4999 keys): forward within 2e-5 of
     the plain f32 attention and within one bf16 ulp (`within_tol`) of B2,
     gradients within 1e-4 (of the largest) of the kernels' backward on one
     rank, the ring's time; a float32 transcription of 2 x 102.4 s through
     the ring with the ids of one rank's (B2) at the same x_init, and the
     ids' agreement in bfloat16; (b3) `torchrun --nproc_per_node 2 -m
     fddm_asr_tpu_torch.train --mesh data=2` (frozen, 2 steps of 16 on
     phase 18's corpus, sharded evaluation; rank 0's metrics.jsonl and
     checkpoints) and phase 18 (c)'s inference CLI run under torchrun
     with `--mesh data=2`, its rows equal to that process's, run once the
     ranks of (b) reach phase 21 (e), beside its exports; (c) with two
     cards or more, (b) over NCCL one card a rank, else the line says it
     was not run.
 21. tensor parallelism at full width, model=2: after (b2) the same two
     processes of phase 20 (b) split the weights of `_DECODER_RULES` over
     a model=2 mesh (WavLM's 16 heads, 8 a rank; the decoder's 12, 6 a
     rank; the FFNs' columns and rows; the 8000-token vocabulary): (a) a
     float32 transcribe of 8 x 20 s at an injected x_init, its ids equal
     to one process's, B1 24 times a rank; the same in bfloat16, its ids'
     agreement with one process's printed; (b) two of phase 20's reference
     steps (float32, dropout off, 8 x 20 s) with the weights split: metrics,
     gathered gradients and updated tensors as (b1) holds them, B3/B4/B5
     47/24/24 a rank a step, each rank's step time and peak memory and
     gloo's staged bytes; (c) the int8_fused encoder (float32) at model=2,
     its ids equal to one process's int8_fused, B7 96 times a rank (the
     column slices: q, k, v and intermediate_dense; the row-parallel
     layers take the library product); then in this process B1 and
     B3/B4/B5 at H = 8 (B=8, L=1024, 999 valid keys a row; f32 and bf16)
     and B7 at the column slices' shapes (1024 -> 512, 1024 -> 2048, M =
     8192, f32) against their plain versions, timed; (d) `torchrun
     --nproc_per_node 2 -m fddm_asr_tpu_torch.serve --mesh model=2`
     (float32, gloo on the card): 4 uploads of 2-20 s one at a time, their
     served ids equal to this process's pipeline of the same flags on the
     same padded batches and seeds; SIGINT to rank 0 stops both ranks;
     (e) sharded AOT artifacts: (e1), in the same two processes after (c),
     the float32 pipeline at model=2 (tensor parallel) exported
     (`aot.save_artifact`: one program a rank, the collectives
     `torch.ops.fddm` nodes keyed by mesh axis), bucket 8 x 20 s, seq_len
     64, greedy (and a bucket of one row at 20 s: the same program),
     loaded (eager: gloo) and run on (a)'s batch at a fixed
     seed: ids equal to the live model=2 pipeline's and to one process's,
     B1 24 a rank a call inside the program; (e2) the same with
     `--seq-parallel` at 6 of WavLM's 24 layers, in a second pair of gloo
     ranks started beside (e1) (with phase 20 (b3); (e1), (e2) and (b3)
     share the card and the host): ids equal to one process's at that
     depth, the ring's 6 hops in the program and no B1; (e3) `torchrun --nproc_per_node 2 -m
     fddm_asr_tpu_torch.serve --exported` on (e1)'s artifact (its ranks,
     and (d)'s, start before phase 22, which runs beside their start-up,
     then this phase's one-process references; the kernels at H = 8 are
     timed after both servers stop): 3 uploads of
     2-20 s, ids equal to this process's at the same padded batches and
     counter, `/healthz` naming the mesh and the eager mode, SIGINT
     stopping both ranks; with two cards or more (e1) over NCCL in phase 20
     (c)'s ranks, every bucket a CUDA graph, else the line says it was not
     run.
 22. `offline` (run before phase 21's checks, while phase 21's servers
     start): the offline workflow and the user scripts
     (`fddm_asr_tpu_torch.scripts`) on phase 18's files: (a) `python3 -m
     ...preprocess --enable_audio_hash` on a dump of 18 clips at 48 kHz
     (two text duplicates and one audio duplicate removed, 16 kHz WAVs of
     1-3 s kept), then `python3 -m ...tokenizer_train` on its manifests, a
     tokenizer that round-trips a test text; (b) `init_random_ckpt
     --make-tokenizer` on configs/fddm_zhTW_base.yaml: the pipeline built
     from its `.pt` transcribes phase 4's batch to the ids of the
     in-process pipeline of the same state (`train_lib.training_pipeline`),
     B1 24; (c) `precompute_features` of phase 18 (a)'s config over its
     three splits (96 clips, WavLM-large): B1 24 a batch, the train cache's
     meta.json that of the cache phase 18 (a)'s run built and its features
     within one bf16 ulp of them, and `run_training`'s own check opens it
     unbuilt; (d) `average_checkpoints --last 2` over phase 18 (a)'s
     ep001.pt and ep002.pt: every tensor the float64 mean of its inputs
     cast back, and a pipeline transcribes from it; (e) validate_quant's
     core (`validate`) on phase 18 (b)'s best_model.pt and .encoder.pt over
     the 16 test clips, variants fp, int8, int8_fused, pcm16 and mulaw8: B1
     24 a transcribe, B7 144 in int8_fused, the fp texts those of a
     pipeline built apart from the same files, the report printed (the int8
     gate, taken on the card); (f) `sweep` of two trials of two steps over
     phase 18 (a)'s config and feature cache (opened, not rebuilt),
     evaluated on 4 validation clips: result.json and summary.json ranked.
 23. `host_tools`: the host tools and profilers (`fddm_asr_tpu_torch.scripts`)
     on phase 15's and phase 18's files: (a) `python3 -m ...profile_step
     --batch 8` (8 x 20 s) with one transcribe traced: B1 24 a transcribe
     by the wrappers' counts, beside the profiler's count of the kernel, the
     top-10 listing, busy time and idle share; (b) `profile_finetune --batch
     8 --iters 1 --no-dropout`: B3/B4/B5 47/24/24 a step (with WavLM's
     attention_dropout 0.1 a training step takes the plain attention, as
     the JAX package's does); (c) `profile_frontend --per-layer`: every
     variant timed; (d) `bench_train` three times (`--lfd`, `--finetune
     --no-dropout`, `--model paper --lfd`, the 253 M scanned decoder):
     each JSON line with its peak memory and kernel launches a step, MFU
     non-null and in (0, 100); (e) `bench_serve --concurrency 8
     --duration-s 2 --audio-seconds 10` on phase 15's decoder, then
     `--stream --duration-s 2`: errors 0, requests served; (f) `stream_client`
     (in this process) against phase 16 (e)'s `python3 -m ...serve` process
     with a 20 s clip at --pace 0 in 5 s windows, run there: partials and a
     final; (g) in this
     process `make_longform --minutes 1` over phase 18's test manifest,
     `inspect_transcripts --n 8` on phase 18 (b)'s best model (B1 24),
     `convergence_report` on phase 18 (b)'s log, `sanity_check_scheduler`
     and `sanity_forward` at WavLM-large on the card (B1 24).

Phases 4 and 7 run at full depth with as many timed runs as before.  The
phases' processes take most of the time, each mostly its start (imports,
the model drawn on the card, first calls), and so do the AOT programs'
traces and loads (host work, 20-80 s each); they are cut in depth first
(phase 21 (e2) at 6 layers, phase 23's profilers at 8 x 20 s, its load
tests 2 s), and host work runs beside other host work where its inputs
allow and no timed section is in its way (phase 17 (d) beside (a)'s
export, phase 21 (e2) and phase 20 (b3) beside phase 21 (e1), phase 22
beside phase 21's servers' start).  PERF.md's "Chip budget" gives the whole run's seconds
on an H100, the kernels' build included, against its 1200 s limit (hosts
differ by up to 45 %); the `phase_end_s` line gives the seconds from the
start to the end of each group of phases.

Prints the kernels' JSON line, then the card line, then as the last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --b7-times DIR
    python3 chip_smoke.py --b8-times DIR
    python3 chip_smoke.py --b8-f32-times DIR
    python3 chip_smoke.py --b1-f32-times DIR
    python3 chip_smoke.py --b5-f32-times DIR
    python3 chip_smoke.py --b4-f32-times DIR

(`--parallel-rank DIR` is one of phase 20's ranks, `--ring-artifact-rank
DIR` one of phase 21 (e2)'s, both started by phase 20.)
These time only the fused int8 kernel (at phase 8's bfloat16 shapes: CUDA events
over back-to-back calls, device time per launch, host time a call), only
the fused conv layer (its kernel and the layer's weight handling, at phase
9's six bfloat16 layer shapes, or in float32 at those six shapes with erf
and tanh GELU: CUDA events, device time, host time a call),
only the float32 gated-attention forward (at phase 2's float32 shapes and a
transcribe's: CUDA events), or only float32 B5 or only float32 B4 (at
phase 5's float32 shape, the fine-tune's and B=3, L=203: CUDA events, each
kernel's device time), of the port checked out at DIR, to compare two trees on one card;
they print no result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                                 # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / f32 (no TF32)
TF32_PEAK_FLOPS = 495e12  # dense tf32: the f32 forward runs 3xTF32 on the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}          # unit-scale inputs
ENCODER_REL_L2_TOL = 5e-2  # bf16 P rounding differs (kernel: before the 1/l, plain: after), 24 layers
# backward kernels, as a fraction of the reference's max-abs: against the
# plain backward (same rounding points) and against autograd of the plain
# forward (which keeps dS in f32 but rounds dO.V^T to bf16)
BWD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
AUTOGRAD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
LSE_TOL = 1e-3             # the row logsumexp, f32 in both
# phase 2's untimed lengths: both forward kernels' 128-query blocks and
# 64-key steps, each +-1 (63, 64, 65, 127, 128, 129), bias rows no TMA can
# address (L % 4 != 0 in f32, L % 8 != 0 in bf16: 63, 65, 127, 129, 203),
# and a ragged last step (1000)
EDGE_LENGTHS = (63, 64, 65, 127, 128, 129, 203, 1000)
# phase 5's: the edges of B4's and B5's 128-query, 128-key and 64-row tiles
# (float32 B5: 64-key and 64-query blocks, 32-query steps; float32 B4:
# 128-query blocks, 32-key steps), and bias rows that are not 16-byte
# aligned (127, 129, 203; in float32 31, 33, 63 and 65 too)
B4_B5_EDGE_LENGTHS = (31, 32, 33, 63, 64, 65, 127, 128, 129, 203, 1000, 1024)
# the device kernels of each training wrapper in float32, all 3xTF32 on wgmma
F32_TRAINING_KERNELS = {"fwd_lse": ["gated_attention_tf32x3_kernel"],
                        "bwd_dq": ["bwd_dq_tf32x3_kernel"],
                        "bwd_dkv": ["bwd_dkv_tf32x3_kernel", "bwd_dbias_tf32x3_kernel"]}
SMALL_STEP_REL_TOL = 1e-4  # f32 fine-tune step, card vs CPU, of the largest gradient
FINETUNE_B, FINETUNE_SECONDS, FINETUNE_TOKENS = 32, 20.0, 128
TIMED_STEPS = 4            # one L_fd period
REPEATS = 5                # timed transcribes after the counted one; their median is reported
SMALL_ENCODER_TOL = 1e-3   # float32, two layers; card and CPU sum in different orders
INT8_PEAK_OPS = 1979e12    # H100 SXM dense int8
# (abs, rel); bfloat16: 3e-2 plus one bf16 ulp of the reference, whose values reach past 4
CONV_TOL = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (3e-2, 2.0 ** -7)}
# the float32 encoder's output under the fused front-end against the unfused
# one's: both f32 (the fused layers' 3xTF32 products keep f32 accuracy), so
# they differ by summation order, carried through 24 layers
ENCODER_F32_FUSED_REL_L2 = 1e-3
SMALL_QUANT_ENCODER_TOL = 5e-2  # phase 11: int8 steps flip at f32 rounding of a half
NBEST_CONFIDENCE_TOL = 1e-5     # phase 3: f32 geometric means, card vs CPU
QUANT_REL_L2 = (1e-6, 5e-2)     # int8 encoder vs full precision: must differ, and little
WAVLM_DENSE_SHAPES = ((1024, 1024), (1024, 4096), (4096, 1024))  # (din, dout): 4 + 1 + 1 a layer
# (T, k, s) of conv layers 1-6 at 8 x 20 s: what B8 runs in one fused-front-end transcribe
FRONTEND_LAYERS = ((63999, 3, 2), (31999, 3, 2), (15999, 3, 2), (7999, 3, 2), (3999, 2, 2),
                   (1999, 2, 2))
FUSED_WAVLM_CONFIG = {"quant_dense": "int8_fused", "fused_frontend": True,
                      "gelu_approx_tanh": True}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def seconds_of(fn, n: int) -> list:
    """Host wall seconds of `n` calls of `fn`, each ended by a synchronize."""
    out = []
    for _ in range(n):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        out.append(time.time() - t0)
    return out


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, name: str = "") -> float:
    """Device time by torch.profiler over `reps` calls of `fn`, free of the
    host's: with `name`, a kernel's own time a launch, the mean over the
    device events whose name holds it; without, all device events of a call.
    The profiler can leave events of a window unrecorded (on an H100, one
    launch of every window in phase 9, and once all of a window's), so a
    named time is the mean over the launches it recorded, and a window with
    no event is profiled again, three windows at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if name in e.key]
        total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                    for e in events)
        count = sum(e.count for e in events)
        if total > 0 and count > 0:
            return total / (count if name else reps) / 1e3
    fail(f"the profiler saw no device event named {name!r} in three windows")


def attention_inputs(B, L, H, dtype, gen, ragged=True, valid=None):
    """Unit-scale q/k/v/bias, gates in [1, 2) and a key mask: ragged (row b
    keeps L - 97 b keys, the last row none) or, with `valid`, the first
    `valid` keys of every row, as a batch of equal-length utterances padded
    to L (a list: row b's own count, as a served batch of mixed lengths)."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    q, k, v = randn(B, L, H * 64), randn(B, L, H * 64), randn(B, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(B, H, L, device=dev, generator=gen) + 1.0
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    if valid is not None:
        for b, n in enumerate([valid] * B if isinstance(valid, int) else valid):
            mask[b, n:] = False
    elif ragged:
        for b in range(B - 1):
            mask[b, L - 97 * b:] = False
        mask[B - 1] = False  # an all-masked row
    return q, k, v, bias, gate, mask


def attention_bound_ms(q, bias, gate, mask, H, tf32x3: bool = False) -> tuple:
    """The least time on the card: each input read once and the output
    written once over HBM, or the products the inputs need (a row with
    kept keys needs q.k and p.v over them; an all-masked row only the mean
    of v, once) at the dense peak of q's type; the larger of the two.
    `tf32x3`: the products three times over at the dense tf32 peak (the
    float32 kernel's own arithmetic: each product as three tf32 ones)."""
    from fddm_asr_tpu_torch.profiling import gated_attention_flops

    B, L, HD = q.shape
    es = q.element_size()
    nbytes = 4 * B * L * HD * es + bias.numel() * es + gate.numel() * 4 + mask.numel()
    ops = gated_attention_flops("fwd", mask.sum(dim=1).tolist(), L, H, HD // H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * ops / TF32_PEAK_FLOPS if tf32x3 else ops / PEAK_FLOPS[q.dtype]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_ms_by_kernel(fn, reps: int, name: str) -> dict:
    """Device time a call of `fn` by torch.profiler, of each kernel whose
    name holds `name`, keyed by the kernel's own name (as `device_ms`, a
    window with no such event is profiled again, three at most; {} if none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if name in e.key and total > 0:
                short = re.search(r"\w*" + name + r"\w*", e.key).group(0)
                out[short] = out.get(short, 0.0) + total / reps / 1e3
        if out:
            return out
    return {}


def main_device_kernel(fn) -> str:
    """The name of the device kernel that takes most of one profiled call
    of `fn`: what a library yardstick ran.  A window in which the profiler
    recorded no device time is profiled again, three at most (see
    `device_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times = [(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0),
                  e.key) for e in prof.key_averages()]
        times = [t for t in times if t[0] > 0]
        if times:
            return max(times)[1]
    return "not recorded"


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of x (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs()).exponent - 8)


def within_tol(err: torch.Tensor, ref: torch.Tensor, dtype) -> torch.Tensor:
    """err / bound, at most 1 where an element passes: TOL, and in bfloat16
    also one bf16 ulp of the plain version's value (above TOL where that
    value reaches 4): the kernel and the plain version round their f32
    results to bf16 apart (ROADMAP C7, repaired)."""
    if dtype == torch.bfloat16:
        return err / torch.clamp(bf16_ulp(ref), min=TOL[dtype])
    return err / TOL[dtype]


def kernel_vs_plain(FA, L: int, dtype, gen, B: int = 8, valid=None, H: int = 16) -> dict:
    """B1 against its plain version at B x L with H heads (a tensor-parallel
    rank's H / M among them), timed beside the plain version, a library
    yardstick and the bound."""
    q, k, v, bias, gate, mask = attention_inputs(B, L, H, dtype, gen, valid=valid)
    out = FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, num_heads=H)
    torch.cuda.synchronize()
    ref = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H).float()
    err = (out.float() - ref).abs()
    del out
    if not torch.isfinite(err).all():
        fail(f"kernel output not finite at B={B} L={L} {dtype}")
    row = {"B": B, "L": L, "H": H, "valid": valid, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "tol": TOL[dtype], "max_err_over_tol": within_tol(err, ref, dtype).max().item()}
    if dtype == torch.bfloat16:
        row.update({"tol": f"{TOL[dtype]} or one bf16 ulp of the plain value",
                    "elements_over_abs_tol": int((err > TOL[dtype]).sum()),
                    "plain_abs_at_max_err": ref.flatten()[err.argmax()].abs().item()})
    del err, ref
    reps = 20 if L <= 1024 else 5
    row["ms"] = time_ms(lambda: FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, H), reps)
    row["plain_ms"] = time_ms(
        lambda: FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, H), max(2, reps // 4), 1)
    # yardstick: one library call over the same function (mask built outside the timing)
    float_mask = (gate[..., None] * bias[None].float()).masked_fill(
        ~mask[:, None, None, :], torch.finfo(torch.float32).min).to(dtype)
    heads = [x.view(B, L, H, 64).transpose(1, 2) for x in (q, k, v)]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        *heads, attn_mask=float_mask)
    row["library_ms"] = time_ms(sdpa, max(2, reps // 4), 1)
    row["library_kernel"] = main_device_kernel(sdpa)[:120]
    del float_mask, sdpa
    row["bound_ms"], row["bound_by"] = attention_bound_ms(q, bias, gate, mask, H)
    if dtype == torch.float32:  # beside the f32-FMA bound, comparable with earlier rows
        row["bound_tc_ms"], row["bound_tc_by"] = attention_bound_ms(q, bias, gate, mask, H,
                                                                    tf32x3=True)
    print(json.dumps({"kernel_vs_plain": row}), flush=True)
    if not row["max_err_over_tol"] <= 1.0:
        fail(f"kernel disagrees with its plain version at B={B} L={L} H={H} {dtype}: {row}")
    torch.cuda.empty_cache()
    return row


def served_valid_frames() -> dict:
    """{(B, L): each row's valid frames} of phase 16's served batches, for
    phase 2 to hold B1 at them.  (c)'s load: Bp = 16 in the 20 s bucket
    (L = 1024), the first 12 of its U(2, 20) s requests and 4 pad rows of
    0.1 s; (d)'s `?stream=1`: Bp = 4 in the 30 s bucket (L = 1536), the four
    windows `plan_silence_chunks` cuts from its 100 s recording (read back
    from the WAV it uploads)."""
    from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD
    from fddm_asr_tpu_torch.data.audio_io import plan_silence_chunks
    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig
    from fddm_asr_tpu_torch.serve import _decode_wav_bytes

    def frames(samples):  # the engine's lengths: one receptive field at least
        return [WavLMConfig.large().feat_extract_output_length(max(n, CONV_RECEPTIVE_FIELD))
                for n in samples]

    durations = np.random.default_rng(SERVE_SEED).uniform(2.0, 20.0, SERVE_REQUESTS)[:12]
    load = frames([int(16000 * float(x)) for x in durations] + [1600] * 4)
    with tempfile.TemporaryDirectory() as d:
        wave = _decode_wav_bytes(_wav_bytes(os.path.join(d, "long.wav"), synthetic_audio(
            1, SERVE_LONG_SECONDS, seed=SERVE_LONG_SEED)[0]))
    windows = frames([e - s for s, e in plan_silence_chunks(wave, 30 * 16000)])
    if len(windows) != 4:
        fail(f"the 100 s recording plans {len(windows)} windows at 30 s, not 4")
    return {(16, 1024): load, (4, 1536): windows}


def edge_lengths_match_plain(FA, gen) -> list:
    """Phase 2, untimed: the forward kernels at the edges of their 128-query
    blocks and 64-key steps and at L whose bias rows are not 16-byte
    aligned (EDGE_LENGTHS), B=3 (a ragged, a full and an all-masked row),
    both types: out within TOL (or, in bfloat16, one bf16
    ulp of the plain value), lse within LSE_TOL and
    exactly f32-min at the all-masked row, and the inference launch's output
    bit-identical to the lse launch's."""
    rows = []
    for L in EDGE_LENGTHS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias, gate, mask = attention_inputs(3, L, 16, dtype, gen)
            out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, 16)
            same = torch.equal(FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, 16), out)
            ref, ref_lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, 16)
            err = (out.float() - ref.float()).abs()
            row = {"L": L, "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err.max().item(),
                   "max_err_over_tol": within_tol(err, ref.float(), dtype).max().item(),
                   "lse_err": (lse - ref_lse).abs().max().item(), "outputs_identical": same,
                   "lse_all_masked_is_f32_min": bool(
                       (lse[2] == torch.finfo(torch.float32).min).all())}
            rows.append(row)
            if not (row["max_err_over_tol"] <= 1.0 and row["lse_err"] <= LSE_TOL and same
                    and row["lse_all_masked_is_f32_min"]):
                fail(f"kernel disagrees with its plain version at an edge length: {row}")
    print(json.dumps({"edge_lengths_vs_plain": rows}), flush=True)
    return rows


def synthetic_tokenizer(directory: str, vocab_size: int) -> str:
    """4 specials + single-ideograph pieces (U+4E00..), with the vocab.json
    sidecar that names the special ids."""
    path = os.path.join(directory, "spm_synth.vocab")
    with open(path, "w", encoding="utf-8") as f:
        f.write("<unk>\t0\n<s>\t0\n</s>\t0\n<pad>\t0\n")
        for i in range(vocab_size - 4):
            f.write(f"{chr(0x4E00 + i)}\t{-(i + 1)}\n")
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({"special_token_ids": {"unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": 3}}, f)
    return path


def flagship_config(tokenizer_path: str, wavlm_config: dict = None, dtype: str = "bfloat16"):
    """configs/fddm_zhTW_base.yaml's model, data and diffusion blocks, in
    code; `wavlm_config` goes under encoder.wavlm_config, `dtype` is
    model.dtype."""
    from fddm_asr_tpu_torch.config import Config

    cfg = Config({
        "seed": 1337,
        "data": {"vocab_size": 8000, "pad_id": 0, "tokenizer_path": tokenizer_path},
        "model": {"d_model": 768, "nhead": 12, "num_layers": 6, "dim_ff": 2048,
                  "dtype": dtype,
                  "encoder": {"wavlm_name": "microsoft/wavlm-large", "freeze": True,
                              "proj": "linear", "pooling": "none"}},
        "diffusion": {"T": 200, "beta_max": 0.2},
    }).to_dict()
    if wavlm_config:
        cfg["model"]["encoder"]["wavlm_config"] = dict(wavlm_config)
    return Config(cfg)


def synthetic_audio(B: int, seconds: float, seed: int) -> np.ndarray:
    """Voiced-like bursts: harmonic tones under a syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds), dtype=np.float32) / 16000.0
    f0 = rng.uniform(90.0, 250.0, (B, 1)).astype(np.float32)
    wav = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3, 4))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 5.0, (B, 1)) * t))
    wav = 0.1 * wav * envelope + 0.01 * rng.standard_normal((B, t.size))
    return wav.astype(np.float32)


def wire_codes(wav: np.ndarray) -> dict:
    """The batch in the serving path's wire dtypes: int16 pcm16 (x * 32768)
    and uint8 mu-law (mu = 255, u8 = round(127.5 + 127.5 sign(x) ln(1 +
    255|x|) / ln 256)), which the pipeline decodes on its device."""
    x = np.clip(wav, -1.0, 1.0)
    mu = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log(256.0)
    return {"int16": np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16),
            "uint8": np.clip(np.round(127.5 + 127.5 * mu), 0, 255).astype(np.uint8)}


def small_pipeline_matches_cpu(FA, tokenizer_dir: str) -> dict:
    """A small float32 pipeline whose WavLM heads are 64 wide (so attention
    takes the kernel) transcribes the same batch and x_T on the card and on
    the CPU (plain attention, the path the CPU tests hold against the JAX
    package), from the same weights: token ids must be identical; the same
    for the batch as int16 and as uint8 mu-law codes."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    K, B, seq_len = 64, 2, 16
    cfg = Config({
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192,
                  "dtype": "float32",
                  "encoder": {"wavlm_name": "tiny", "proj": "linear", "wavlm_config": {
                      "hidden_size": 128, "num_attention_heads": 2,
                      "intermediate_size": 256}}},
        "diffusion": {"T": 200, "beta_max": 0.2},
    })
    tok = load_tokenizer(synthetic_tokenizer(tokenizer_dir, K))
    cpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cpu")
    gpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cuda")
    gpu.decoder.load_state_dict(cpu.decoder.state_dict())
    gpu.encoder.load_state_dict(cpu.encoder.state_dict())
    wav = synthetic_audio(B, 1.0, seed=1)
    wav[1, 8000:] = 0.0
    x_init = np.random.default_rng(2).integers(0, K, (B, seq_len))
    sampling = dict(T_infer=20, r=5, greedy=True, x_init=x_init)
    before = FA.wavlm_gated_attention_cuda.launches
    got = gpu.transcribe_with_ids(wav, seq_len=seq_len, **sampling)
    torch.cuda.synchronize()
    launched = FA.wavlm_gated_attention_cuda.launches - before
    want = cpu.transcribe_with_ids(wav, seq_len=seq_len, **sampling)
    feat_err = (gpu.encode_waveform(wav)[0].cpu() - cpu.encode_waveform(wav)[0]).abs().max().item()
    result = {"frames": gpu.encoder.config.feat_extract_output_length(wav.shape[1]),
              "kernel_launches": launched, "encoder_max_abs_err": feat_err,
              "encoder_tol": SMALL_ENCODER_TOL,
              "ids_equal": [r[1] for r in got] == [r[1] for r in want], "wire": {}}
    for name, codes in wire_codes(wav).items():
        got_w = gpu.transcribe_with_ids(codes, seq_len=seq_len, **sampling)
        want_w = cpu.transcribe_with_ids(codes, seq_len=seq_len, **sampling)
        err_w = (gpu.encode_waveform(codes)[0].cpu() - cpu.encode_waveform(codes)[0]).abs().max()
        result["wire"][name] = {"encoder_max_abs_err": err_w.item(),
                                "ids_equal": [r[1] for r in got_w] == [r[1] for r in want_w]}
    result["nbest"], result["chunks"] = small_nbest_and_chunks(gpu, cpu, K, seq_len)
    print(json.dumps({"small_pipeline_card_vs_cpu": result}), flush=True)
    if not (result["nbest"]["ids_equal"] and result["nbest"]["confidence_max_abs_err"]
            <= NBEST_CONFIDENCE_TOL):
        fail(f"small pipeline best-of-N, card vs CPU: {result['nbest']}")
    if not result["chunks"]["ids_equal"]:
        fail(f"small pipeline on silence-planned windows, card vs CPU: {result['chunks']}")
    for name, row in result["wire"].items():
        if not (row["encoder_max_abs_err"] <= SMALL_ENCODER_TOL and row["ids_equal"]):
            fail(f"small pipeline fed {name} codes, card vs CPU: {row}")
    if launched != 2:
        fail(f"small pipeline launched the kernel {launched} times, expected 2")
    if not feat_err <= SMALL_ENCODER_TOL:
        fail(f"small pipeline encoder, card vs CPU: max abs err {feat_err}")
    if not result["ids_equal"]:
        fail(f"small pipeline token ids differ, card {got} vs CPU {want}")
    return result


def small_nbest_and_chunks(gpu, cpu, K: int, seq_len: int) -> dict:
    """Phase 3, continued: `transcribe_nbest` with N = 4 at one injected
    [B*N, L] x_T gives the same candidates on the card and the CPU (each
    utterance's candidates compared in (ids, confidence) order, so that two
    of nearly equal confidence may sort either way), confidences within
    NBEST_CONFIDENCE_TOL; and the windows `plan_silence_chunks` cuts from a
    3.3 s recording, transcribed as one condition-masked batch at one
    injected x_T, give the same ids."""
    from fddm_asr_tpu_torch.data.audio_io import plan_silence_chunks

    n, B = 4, 2
    wav = synthetic_audio(B, 1.0, seed=1)
    x_init = np.random.default_rng(3).integers(0, K, (B * n, seq_len))
    kw = dict(seq_len=seq_len, num_candidates=n, x_init=x_init, T_infer=20, r=5, greedy=True)
    got = [sorted(u, key=lambda c: c[1:]) for u in gpu.transcribe_nbest(wav, **kw)]
    want = [sorted(u, key=lambda c: c[1:]) for u in cpu.transcribe_nbest(wav, **kw)]
    nbest = {"candidates": n, "ids_equal": [[c[1] for c in u] for u in got]
             == [[c[1] for c in u] for u in want],
             "confidence_max_abs_err": max(abs(a[2] - b[2]) for ua, ub in zip(got, want)
                                           for a, b in zip(ua, ub)),
             "confidence_tol": NBEST_CONFIDENCE_TOL}
    long = synthetic_audio(1, 3.3, seed=4)[0]
    spans = plan_silence_chunks(long, 16000)
    batch = np.zeros((len(spans), 16000), np.float32)
    for j, (a, b) in enumerate(spans):
        batch[j, :b - a] = long[a:b]
    lengths = np.asarray([max(b - a, 400) for a, b in spans])
    x_win = np.random.default_rng(5).integers(0, K, (len(spans), seq_len))
    rows = {}
    for name, pipe in (("card", gpu), ("cpu", cpu)):
        pipe.use_condition_mask = True
        try:
            rows[name] = [r[1] for r in pipe.transcribe_with_ids(
                batch, lengths, seq_len=seq_len, x_init=x_win, T_infer=20, r=5, greedy=True)]
        finally:
            pipe.use_condition_mask = False
    chunks = {"spans": spans, "ids_equal": rows["card"] == rows["cpu"]}
    return nbest, chunks


def device_time_breakdown(run, wall_s: float, ranges=()) -> dict:
    """One more run under torch.profiler: device time by event name, and the
    device's busy time against the host wall time of the unprofiled run
    (`idle_share`) and of the profiled run itself (`idle_share_profiled`),
    both unclamped.  Busy time is the union of the device events' intervals,
    so time that two events share (a duplicate, an annotation spanning
    kernels, a second stream) counts once; `overlap_ms` is the plain sum of
    event times less the union, `nested_ms` the events that lie wholly
    inside an earlier one, by name, and `containers` the names that hold
    them.  For each name in `ranges` (a `record_function` range of the
    port), `ranges` gives its count and the device time of the kernels
    launched inside it (`device_ms`), and the device-side spans of the
    range (`span_ms`, gaps included), which stay out of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        profiled_ms = (time.time() - t0) * 1e3
    return profile_breakdown(prof, wall_s * 1e3, profiled_ms, ranges)


def profile_breakdown(prof, wall_ms: float, profiled_ms: float, ranges=()) -> dict:
    """`device_time_breakdown`'s numbers from a finished profiler window
    (`profiling.breakdown`): `wall_ms` the unprofiled wall time,
    `profiled_ms` the window's own; each range also with the host time of
    its spans (`host_ms`)."""
    from fddm_asr_tpu_torch import profiling

    try:
        return profiling.breakdown(prof, wall_ms, profiled_ms, ranges)
    except RuntimeError as e:
        fail(str(e))


def port_kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its launches are
    reported under; each carries a `.launches` count."""
    from fddm_asr_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def transcribe_full_width(FA, tokenizer_dir: str, card: str, name: str = "transcribe",
                          wavlm_config: dict = None, expect: dict = None) -> dict:
    """Phase 4, and under `wavlm_config` phase 12: 8 x 20 s through
    `transcribe_with_ids` at full width; `expect` gives the launches of one
    transcribe for the kernels it runs (every other kernel: none).  Returns
    the result with the pipeline's encoder output under "feats" (not
    printed)."""
    import fddm_asr_tpu_torch.models.wavlm as W
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    B, seconds = 8, 20.0
    cfg = flagship_config(synthetic_tokenizer(tokenizer_dir, 8000), wavlm_config)
    t0 = time.time()
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_layers = pipe.encoder.config.num_hidden_layers
    wav = synthetic_audio(B, seconds, seed=0)
    sampling = dict(T_infer=20, r=5, greedy=True, posterior_mode="map", sampling_mode="exact")

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = pipe.transcribe_with_ids(wav, seq_len=64, generator=gen, with_confidence=True,
                                        **sampling)
        torch.cuda.synchronize()
        return rows

    gc.collect()  # the earlier phases' pipelines: not collected during the timed runs
    run()  # warm-up: lazy CUDA/cuBLAS/cuDNN initialisation
    torch.cuda.reset_peak_memory_stats()  # the peak of the transcribe alone, not of phase 2
    wrappers = port_kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    rows = run()  # the main path's run: its kernel launches are counted
    counts = {k: f.launches for k, f in wrappers.items()}
    launches = counts["fwd"]
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in wrappers}
    want.update(expect or {"fwd": n_layers})
    if counts != want:
        fail(f"kernel launches in one {name} {counts}, expected {want}")
    step_samples = seconds_of(run, REPEATS)

    # where the time goes: encode and sample apart
    encode_samples = seconds_of(lambda: pipe.encode_waveform(wav), REPEATS)
    feats, _ = pipe.encode_waveform(wav)
    sample_samples = seconds_of(lambda: pipe.sample(
        feats, 64, generator=torch.Generator(device="cuda").manual_seed(0), **sampling), REPEATS)
    ids, p = pipe.sample(feats, 64, generator=torch.Generator(device="cuda").manual_seed(0),
                         **sampling)

    S = pipe.encoder.config.feat_extract_output_length(wav.shape[1])
    if tuple(feats.shape) != (B, S, 768) or not torch.isfinite(feats.float()).all():
        fail(f"encoder output {tuple(feats.shape)} not finite or not [{B}, {S}, 768]")
    if len(rows) != B or any(len(r[1]) != 64 for r in rows):
        fail("transcripts are not 8 rows of 64 ids")
    if not all(0 <= i < 8000 for r in rows for i in r[1]) or not torch.isfinite(p).all():
        fail("ids out of range or p_x0 not finite")
    if [r[1] for r in rows] != ids.cpu().tolist():
        fail("transcribe_with_ids and encode_waveform + sample disagree")

    rel_l2 = None
    if not wavlm_config:  # phase 4: the same encoder with the plain attention on the card
        kernel_route = W.wavlm_gated_attention_heads_packed
        W.wavlm_gated_attention_heads_packed = FA.wavlm_gated_attention_plain
        try:
            plain_feats, _ = pipe.encode_waveform(wav)
        finally:
            W.wavlm_gated_attention_heads_packed = kernel_route
        rel_l2 = ((feats.float() - plain_feats.float()).norm()
                  / plain_feats.float().norm()).item()
        if not rel_l2 <= ENCODER_REL_L2_TOL:
            fail(f"encoder with kernel vs plain attention: rel L2 {rel_l2} > {ENCODER_REL_L2_TOL}")

    step_s = statistics.median(step_samples)
    breakdown = device_time_breakdown(run, step_s)
    port_names = {"fwd": "gated_attention_bf16_kernel",
                  "int8_matmul_fused": "int8_matmul_fused_kernel",
                  "conv_ln_gelu": "conv_ln_gelu_bf16_kernel"}
    breakdown["port_kernels_ms"] = {k: sum(t["ms"] for t in breakdown["all"] if n in t["name"])
                                    for k, n in port_names.items() if want[k]}
    del breakdown["all"]
    port_kernels_ms = breakdown["port_kernels_ms"]
    print(json.dumps({f"{name}_device_time": breakdown}), flush=True)

    result = {
        "card": card, "transcripts": len(rows), "audio_s": B * seconds, "frames": S,
        "step_s": step_s, "rtfx": B * seconds / step_s, "step_s_samples": step_samples,
        "encode_s": statistics.median(encode_samples),
        "sample_s": statistics.median(sample_samples), "repeats": REPEATS,
        "pipeline_build_s": build_s, "kernel_launches": launches,
        "launches": {k: n for k, n in counts.items() if n},
        "wavlm_config": wavlm_config or {},
        "encoder_rel_l2_kernel_vs_plain": rel_l2, "encoder_rel_l2_tol": ENCODER_REL_L2_TOL,
        "example_text": rows[0][0][:16], "example_confidence": rows[0][2],
        "peak_mem_gb": peak_mem_gb, "port_kernels_ms": port_kernels_ms,
        "device_busy_ms": breakdown["device_busy_ms"], "idle_share": breakdown["idle_share"],
    }
    print(json.dumps({name: result}, ensure_ascii=False), flush=True)
    result["feats"] = feats
    result["ids"] = [r[1] for r in rows]
    return result


def transcribe_f32_full_width(tokenizer_dir: str, card: str, bf16: dict,
                              unfused: dict = None) -> dict:
    """Phase 4's transcribe at model.dtype float32 (`transcribe_f32`): the
    same config, seed (so the same float32 parameters), batch and sampling,
    as `inference.py --dtype float32` and the server run it.  B1 in float32
    24 times a transcribe (checked) and no other kernel; wall median of
    REPEATS, RTFx, busy ms and the f32 kernel's device ms from one profiled
    run; the ids beside phase 4's bfloat16 ones (a count, not a check: the
    two encoders round apart).  Given `unfused` (this function's result
    without it), the same under `fused_frontend: true`
    (`transcribe_f32_fused_frontend`): B8 in float32 once a conv layer 1-6
    and B1 24 (checked), B8's device ms in the profiled run, the encoder's
    output within ENCODER_F32_FUSED_REL_L2 of the unfused run's (checked),
    the ids beside its (a count).  Returns the result with the encoder's
    output under "feats" and the ids under "ids" (not printed)."""
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    B, seconds = 8, 20.0
    fused = unfused is not None
    name = "transcribe_f32_fused_frontend" if fused else "transcribe_f32"
    cfg = flagship_config(synthetic_tokenizer(tokenizer_dir, 8000),
                          {"fused_frontend": True} if fused else None, dtype="float32")
    t0 = time.time()
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    wav = synthetic_audio(B, seconds, seed=0)
    sampling = dict(T_infer=20, r=5, greedy=True, posterior_mode="map", sampling_mode="exact")

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = pipe.transcribe_with_ids(wav, seq_len=64, generator=gen, with_confidence=True,
                                        **sampling)
        torch.cuda.synchronize()
        return rows

    gc.collect()
    run()
    torch.cuda.reset_peak_memory_stats()
    wrappers = port_kernel_wrappers()
    _reset(wrappers)
    rows = run()
    counts = _counts_since_reset(wrappers)
    want = {k: 0 for k in wrappers}
    want["fwd"] = pipe.encoder.config.num_hidden_layers
    if fused:
        want["conv_ln_gelu"] = len(FRONTEND_LAYERS)
    if counts != want:
        fail(f"kernel launches in one float32 transcribe ({name}) {counts}, expected {want}")
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ids = [r[1] for r in rows]
    if len(rows) != B or any(len(r) != 64 or not all(0 <= i < 8000 for i in r) for r in ids):
        fail("float32 transcripts are not 8 rows of 64 ids in range")
    step_samples = seconds_of(run, REPEATS)
    step_s = statistics.median(step_samples)
    breakdown = device_time_breakdown(run, step_s)
    f32_kernel = [t for t in breakdown["all"] if "gated_attention_tf32x3_kernel" in t["name"]]
    if not f32_kernel:
        fail("the profiled float32 transcribe shows no gated_attention_tf32x3_kernel")
    b8_ms = sum(t["ms"] for t in breakdown["all"] if "conv_ln_gelu_tf32x3_kernel" in t["name"])
    del breakdown["all"]
    with torch.no_grad():
        feats, _ = pipe.encode_waveform(wav)
    same = sum(a == b for ra, rb in zip(ids, bf16["ids"]) for a, b in zip(ra, rb))
    result = {
        "card": card, "dtype": "float32", "audio_s": B * seconds, "step_s": step_s,
        "rtfx": B * seconds / step_s, "step_s_samples": step_samples,
        "pipeline_build_s": build_s, "launches": {k: n for k, n in counts.items() if n},
        "peak_mem_gb": peak_mem_gb, "device_busy_ms": breakdown["device_busy_ms"],
        "idle_share": breakdown["idle_share"],
        "b1_f32_device_ms": f32_kernel[0]["ms"],
        "b1_f32_device_ms_per_launch": f32_kernel[0]["ms"] / want["fwd"],
        "top": breakdown["top"][:6],
        "bf16_transcribe": {"step_s": bf16["step_s"], "device_busy_ms": bf16["device_busy_ms"],
                            "b1_device_ms": bf16["port_kernels_ms"]["fwd"]},
        "ids_equal_to_bf16": {"tokens": same, "of": B * 64,
                              "rows": sum(a == b for a, b in zip(ids, bf16["ids"]))},
    }
    if fused:
        ref = unfused["feats"].float()
        rel_l2 = ((feats.float() - ref).norm() / ref.norm()).item()
        result.update({
            # the profiler can leave B8's cluster launches unrecorded (PERF.md §7)
            "b8_f32_device_ms": b8_ms,
            "encoder_rel_l2_vs_unfused": rel_l2,
            "encoder_rel_l2_tol": ENCODER_F32_FUSED_REL_L2,
            "unfused_f32_transcribe": {"step_s": unfused["step_s"],
                                       "device_busy_ms": unfused["device_busy_ms"]},
            "ids_equal_to_f32": {
                "tokens": sum(a == b for ra, rb in zip(ids, unfused["ids"])
                              for a, b in zip(ra, rb)),
                "of": B * 64, "rows": sum(a == b for a, b in zip(ids, unfused["ids"]))}})
        if not (tuple(feats.shape) == tuple(ref.shape) and rel_l2 <= ENCODER_F32_FUSED_REL_L2):
            fail(f"float32 encoder under the fused front-end vs unfused: shape "
                 f"{tuple(feats.shape)}, rel L2 {rel_l2} > {ENCODER_F32_FUSED_REL_L2}")
    print(json.dumps({name: result}, ensure_ascii=False), flush=True)
    result["feats"], result["ids"] = feats, ids
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------ training path
TRAIN_KERNELS = ("fwd_lse", "bwd_dq", "bwd_dkv")


def _training_wrappers(FA):
    return {"fwd_lse": FA.wavlm_gated_attention_fwd_lse_cuda,
            "bwd_dq": FA.wavlm_gated_attention_bwd_dq_cuda,
            "bwd_dkv": FA.wavlm_gated_attention_bwd_dkv_cuda}


def _rel_err(got, want) -> tuple:
    """(max abs err, reference max-abs), in float32."""
    want = want.float()
    return (got.float() - want).abs().max().item(), max(want.abs().max().item(), 1e-30)


def training_bounds(q, bias, gate, mask, H) -> dict:
    """The least time of each training kernel at these inputs: bytes (each
    input read once, each output written once) over HBM, or the products
    the data needs (per (query, kept key) pair and head: B3 4*64 for q.k
    and p.v, B4 6*64 for q.k, dO.v and dS.k, B5 8*64 for q.k, dO.v, P^T.dO
    and dS^T.q; a row whose keys are all masked needs no product but B5's
    column sum of dO) at the dense peak of q's type; the larger of the two.
    In float32 each kernel also gets `bound_tc_ms` / `bound_tc_by`: the
    products three times over at the dense tf32 peak, as 3xTF32 runs them."""
    from fddm_asr_tpu_torch.profiling import gated_attention_flops

    B, L, HD = q.shape
    es = q.element_size()
    act = B * L * HD * es                       # one of q, k, v, dO, out, dq, dk, dv
    small = gate.numel() * 4                    # gate, lse, delta, dgate: [B, H, L] f32
    common = bias.numel() * es + mask.numel()
    kept = mask.sum(dim=1).tolist()
    nbytes = {"fwd_lse": 4 * act + common + 2 * small, "bwd_dq": 5 * act + common + 4 * small,
              "bwd_dkv": 6 * act + common + 3 * small + H * L * L * 4}
    work = {key: (n, gated_attention_flops(key, kept, L, H, HD // H))
            for key, n in nbytes.items()}
    out = {}
    for key, (nbytes, ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
        out[key] = {"bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if q.dtype == torch.float32:
            t_tc = 3 * ops / TF32_PEAK_FLOPS * 1e3
            out[key].update(bound_tc_ms=max(t_bytes, t_tc),
                            bound_tc_by="bytes" if t_bytes >= t_tc else "operations")
    return out


def training_kernels_vs_plain(FA, L: int, dtype, gen, timed: bool, B: int = 8,
                              valid=None, H: int = 16) -> dict:
    """B3, B4, B5 against their plain versions and against autograd of the
    plain forward, with ragged key masks or `valid` keys in every row, at H
    heads; `timed`: each kernel's time beside the plain version's, a library
    yardstick's and the bound."""
    q, k, v, bias, gate, mask = attention_inputs(B, L, H, dtype, gen, valid=valid)
    dout = torch.randn(B, L, H * 64, device="cuda", generator=gen).to(dtype)
    wrap = _training_wrappers(FA)
    out, lse = wrap["fwd_lse"](q, k, v, bias, gate, mask, H)
    delta = (dout.float() * out.float()).view(B, L, H, 64).sum(-1).transpose(1, 2).contiguous()
    dq, dgate = wrap["bwd_dq"](q, k, v, bias, gate, mask, lse, delta, dout, H)
    dq_again = wrap["bwd_dq"](q, k, v, bias, gate, mask, lse, delta, dout, H)
    dk, dv, dbias = wrap["bwd_dkv"](q, k, v, bias, gate, mask, lse, delta, dout, H)
    again = wrap["bwd_dkv"](q, k, v, bias, gate, mask, lse, delta, dout, H)
    torch.cuda.synchronize()
    # B4 and B5 write each output element once, from a fixed order of sums: bit for bit
    dq_deterministic = all(torch.equal(a, b) for a, b in zip((dq, dgate), dq_again))
    deterministic = all(torch.equal(a, b) for a, b in zip((dk, dv, dbias), again))
    del again, dq_again
    got = {"dq": dq, "dk": dk, "dv": dv, "dbias": dbias, "dgate": dgate}
    ref_out, ref_lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, H)
    plain = dict(zip(("dq", "dk", "dv", "dbias", "dgate"), FA.wavlm_gated_attention_bwd_plain(
        q, k, v, bias, gate, mask, out, lse, dout, H)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias, gate)]
    auto = dict(zip(("dq", "dk", "dv", "dbias", "dgate"), torch.autograd.grad(
        FA.wavlm_gated_attention_plain(*leaves, mask, num_heads=H), leaves, dout)))
    del leaves

    row = {"B": B, "L": L, "H": H, "valid": valid, "dtype": str(dtype).replace("torch.", ""),
           "tol_out": TOL[dtype], "tol_lse": LSE_TOL, "tol_bwd_rel": BWD_REL_TOL[dtype],
           "tol_autograd_rel": AUTOGRAD_REL_TOL[dtype], "bwd_dq_deterministic": dq_deterministic,
           "bwd_dkv_deterministic": deterministic, "errors": {}}
    failures = [] if dq_deterministic else ["B4 outputs differ between two calls"]
    if not deterministic:
        failures.append("B5 outputs differ between two calls")
    out_err, _ = _rel_err(out, ref_out)
    lse_err, _ = _rel_err(lse, ref_lse)
    row["errors"]["out"], row["errors"]["lse"] = out_err, lse_err
    if not out_err <= TOL[dtype] or not lse_err <= LSE_TOL:
        failures.append(f"fwd_lse out {out_err} lse {lse_err}")
    for name, g in got.items():
        if not torch.isfinite(g).all():
            failures.append(f"{name} not finite")
            continue
        e_plain, s_plain = _rel_err(g, plain[name])
        e_auto, s_auto = _rel_err(g, auto[name])
        row["errors"][name] = {"vs_plain": e_plain, "plain_max_abs": s_plain,
                               "vs_autograd": e_auto, "autograd_max_abs": s_auto}
        if not e_plain <= BWD_REL_TOL[dtype] * s_plain:
            failures.append(f"{name} vs plain {e_plain} > {BWD_REL_TOL[dtype]} x {s_plain}")
        if not e_auto <= AUTOGRAD_REL_TOL[dtype] * s_auto:
            failures.append(f"{name} vs autograd {e_auto} > {AUTOGRAD_REL_TOL[dtype]} x {s_auto}")
    row["fwd_lse"] = {"max_abs_err": out_err}
    row["bwd_dq"] = {"max_abs_err": max(row["errors"][n]["vs_plain"] for n in ("dq", "dgate"))}
    row["bwd_dkv"] = {"max_abs_err": max(row["errors"][n]["vs_plain"]
                                         for n in ("dk", "dv", "dbias"))}
    del plain, auto, ref_out, ref_lse

    if timed:
        reps = 10
        args = (q, k, v, bias, gate, mask)
        bwd_args = (*args, lse, delta, dout, H)
        row["fwd_lse"]["ms"] = time_ms(lambda: wrap["fwd_lse"](*args, H), reps)
        row["bwd_dq"]["ms"] = time_ms(lambda: wrap["bwd_dq"](*bwd_args), reps)
        row["bwd_dkv"]["ms"] = time_ms(lambda: wrap["bwd_dkv"](*bwd_args), reps)
        row["fwd_lse"]["plain_ms"] = time_ms(
            lambda: FA.wavlm_gated_attention_fwd_lse_plain(*args, H), 3, 1)
        bwd_plain_ms = time_ms(lambda: FA.wavlm_gated_attention_bwd_plain(
            *args, out, lse, dout, H), 3, 1)
        row["bwd_dq"]["plain_ms"] = row["bwd_dkv"]["plain_ms"] = bwd_plain_ms
        # yardsticks: one SDPA call with the gated float mask, and autograd
        # of it with respect to q, k, v and the mask (where a backend can)
        float_mask = (gate[..., None] * bias[None].float()).masked_fill(
            ~mask[:, None, None, :], torch.finfo(torch.float32).min).to(dtype)
        heads = [x.view(B, L, H, 64).transpose(1, 2) for x in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["fwd_lse"]["library_ms"] = time_ms(lambda: sdpa(*heads, attn_mask=float_mask), 3, 1)
        lib_leaves = [x.detach().clone().requires_grad_() for x in (*heads, float_mask)]
        try:
            lib_out = sdpa(*lib_leaves[:3], attn_mask=lib_leaves[3])
            lib_dout = dout.view(B, L, H, 64).transpose(1, 2)
            bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, lib_leaves, lib_dout, retain_graph=True), 3, 1)
        except RuntimeError as e:  # no backend differentiates the mask
            print(json.dumps({"library_backward": f"none: {str(e)[:200]}"}), flush=True)
            bwd_lib_ms = None
        row["bwd_dq"]["library_ms"] = row["bwd_dkv"]["library_ms"] = bwd_lib_ms
        del float_mask, heads, lib_leaves
        for key, bounds in training_bounds(q, bias, gate, mask, H).items():
            row[key].update(bounds)
    print(json.dumps({"training_kernels_vs_plain": row}), flush=True)
    if failures:
        fail(f"training kernels disagree at B={B} L={L} H={H} {dtype}: {failures}")
    torch.cuda.empty_cache()
    return row


def finetune_config(tokenizer_path: str, small: bool = False):
    """configs/fddm_zhTW_finetune.yaml over fddm_zhTW_base.yaml, in code,
    as `flagship_config`; `small` is phase 6's float32
    version with 64-wide WavLM heads, no dropout and a tiny vocabulary."""
    from fddm_asr_tpu_torch.config import Config

    cfg = flagship_config(tokenizer_path).to_dict()
    cfg["data"]["max_len"] = FINETUNE_TOKENS
    cfg["model"]["dropout"] = 0.1
    cfg["model"]["projector"] = {"d_proj": 256}
    cfg["model"]["encoder"].update({
        "freeze": False, "mask_time_prob": 0.065, "mask_time_length": 10,
        "wavlm_config": {"scan_layers": True, "remat_layers": True,
                         "freeze_feature_extractor": True, "fused_attention": True,
                         "hidden_dropout": 0.0, "attention_dropout": 0.0,
                         "activation_dropout": 0.0, "feat_proj_dropout": 0.0}})
    cfg["optim"] = {"batch_size": FINETUNE_B, "lr": 2e-4, "weight_decay": 0.01,
                    "grad_accum_steps": 1, "warmup_steps": 500, "dtype": "bfloat16",
                    "encoder_lr": 1e-5, "ema_decay": 0.999, "lr_schedule": "cosine",
                    "decay_steps": 20000}
    cfg["lfd"] = {"lambda_offdiag": 5e-3, "n_step_fd": 4, "tau": 1.0}
    if small:
        cfg["seed"] = 0
        cfg["data"].update({"vocab_size": 64, "max_len": 16})
        cfg["model"].update({"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192,
                             "dtype": "float32", "dropout": 0.0, "projector": {"d_proj": 32}})
        cfg["model"]["encoder"].update({"wavlm_name": "tiny", "mask_time_prob": 0.2,
                                        "mask_time_length": 3})
        cfg["model"]["encoder"]["wavlm_config"].update(
            {"hidden_size": 128, "num_attention_heads": 2, "intermediate_size": 256})
        cfg["optim"].update({"lr": 1e-3, "encoder_lr": 3e-4, "warmup_steps": 0,
                             "dtype": "float32"})
    return Config(cfg)


def _launch_counts(FA) -> dict:
    return {"fwd": FA.wavlm_gated_attention_cuda.launches,
            **{k: f.launches for k, f in _training_wrappers(FA).items()}}


def _reset_launches(FA) -> None:
    FA.wavlm_gated_attention_cuda.launches = 0
    for f in _training_wrappers(FA).values():
        f.launches = 0


def small_finetune_step_matches_cpu(FA, tokenizer_dir: str) -> dict:
    """One float32 fine-tune step with L_fd on the card and on the CPU from
    the same weights and draws: the card runs B3/B4/B5, the CPU the plain
    versions the CPU tests hold against the JAX package."""
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    cfg = finetune_config(synthetic_tokenizer(tokenizer_dir, 64), small=True)
    tok = load_tokenizer(cfg.data.tokenizer_path)
    B, seq = 3, 16
    wav = synthetic_audio(B, 1.0, seed=3)
    rng = np.random.default_rng(4)
    x0 = rng.integers(4, 64, (B, seq))
    x0[1, 10:] = 3  # pad tail
    sides = {}
    for dev in ("cpu", "cuda"):
        pipe = FDDMPipeline.from_config(cfg, tokenizer=tok, device=dev)
        if dev == "cuda":
            pipe.decoder.load_state_dict(sides["cpu"][0].decoder.state_dict())
            pipe.encoder.load_state_dict(sides["cpu"][0].encoder.state_dict())
            heads = TL.make_projection_heads(cfg, dev, torch.float32)
            for h, ref in zip(heads, sides["cpu"][1].trained_modules()[1:4]):
                h.load_state_dict(ref.state_dict())
            state = TL.init_train_state(pipe, cfg, heads=heads)
        else:
            state = TL.init_train_state(pipe, cfg, generator=torch.Generator().manual_seed(5))
        sides[dev] = (pipe, state, TL.make_train_step(pipe, cfg, train_encoder=True))
    S = sides["cpu"][0].encoder.config.feat_extract_output_length(wav.shape[1])
    draws = {"t": rng.integers(1, 201, (B,)), "xt": rng.integers(0, 64, (B, seq)),
             "time_mask": rng.random((B, S)) < 0.2}

    grads = {}
    for dev, (pipe, state, step) in sides.items():
        loss, _ = step.forward(state, wav, x0, True, **draws)
        grads[dev] = [None if g is None else g.detach().cpu() for g in torch.autograd.grad(
            loss, state.optimizer.params, allow_unused=True)]
    _reset_launches(FA)
    metrics = {dev: step(state, wav, x0, True, **draws) for dev, (_, state, step) in sides.items()}
    torch.cuda.synchronize()
    launches = _launch_counts(FA)
    n_layers = sides["cuda"][0].encoder.config.num_hidden_layers
    want_launches = {"fwd": 0, "fwd_lse": 2 * n_layers - 1, "bwd_dq": n_layers,
                     "bwd_dkv": n_layers}

    scale = max(g.abs().max().item() for g in grads["cpu"] if g is not None)
    grad_err = max((a - b).abs().max().item() for a, b in zip(grads["cuda"], grads["cpu"])
                   if a is not None)
    # Adam's first update is +-lr wherever the gradient's sign is resolved
    # (|g| above twice the gradient tolerance); an element at the noise
    # level may take the other sign on the other side: up to 2 lr
    param_err = resolved_err = 0.0
    for a, b, g in zip(sides["cuda"][1].optimizer.params, sides["cpu"][1].optimizer.params,
                       grads["cpu"]):
        diff = (a.detach().cpu() - b.detach()).abs()
        param_err = max(param_err, diff.max().item())
        if g is not None:
            resolved = g.abs() > 2 * SMALL_STEP_REL_TOL * scale
            resolved_err = max(resolved_err, diff[resolved].max().item() if resolved.any() else 0.0)
    metric_err = {k: abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k]))
                  / max(abs(float(metrics["cpu"][k])), 1e-30) for k in metrics["cpu"]}
    result = {"launches": launches, "expected_launches": want_launches,
              "grad_max_abs_err": grad_err, "grad_scale": scale,
              "grad_tol": SMALL_STEP_REL_TOL * scale, "metric_rel_err": metric_err,
              "param_max_abs_err": param_err, "resolved_param_max_abs_err": resolved_err,
              "loss": float(metrics["cuda"]["total_loss"])}
    print(json.dumps({"small_finetune_card_vs_cpu": result}), flush=True)
    if launches != want_launches:
        fail(f"small fine-tune step launches {launches}, expected {want_launches}")
    if not grad_err <= SMALL_STEP_REL_TOL * scale:
        fail(f"small fine-tune gradients, card vs CPU: {grad_err} > {SMALL_STEP_REL_TOL} x {scale}")
    if not all(e <= 1e-4 for e in metric_err.values()):
        fail(f"small fine-tune metrics, card vs CPU: {metric_err}")
    if not param_err <= 2.1 * float(cfg.optim.lr) or not resolved_err <= 1e-5:
        fail(f"small fine-tune updated parameters, card vs CPU: {param_err}, "
             f"{resolved_err} where the gradient is resolved")
    return result


def finetune_full_width(FA, tokenizer_dir: str, card: str, isolated: dict) -> dict:
    """`isolated`: phase 5's row at this step's attention shape; each
    kernel's time per launch in the profiled step is printed beside its
    CUDA-event time there."""
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    B, seconds, Lt = FINETUNE_B, FINETUNE_SECONDS, FINETUNE_TOKENS
    cfg = finetune_config(synthetic_tokenizer(tokenizer_dir, 8000))
    t0 = time.time()
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path))
    state = TL.init_train_state(pipe, cfg, generator=torch.Generator(device="cuda").manual_seed(7))
    step = TL.make_train_step(pipe, cfg, train_encoder=True)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    enc_cfg = pipe.encoder.config
    n_layers = enc_cfg.num_hidden_layers
    wav = synthetic_audio(B, seconds, seed=5)
    rng = np.random.default_rng(6)
    x0 = rng.integers(4, 8000, (B, Lt))
    for b, n in enumerate(rng.integers(Lt // 4, Lt + 1, B)):
        x0[b, n:] = pipe.pad_id
    gen = torch.Generator(device="cuda").manual_seed(8)

    backbone = pipe.encoder.backbone
    watched = {"encoder.layers.12.attention.q_proj.weight":
                   backbone.encoder.layers[12].attention.q_proj.weight,
               "encoder.layers.0.attention.rel_attn_embed.weight":
                   backbone.encoder.layers[0].attention.rel_attn_embed.weight,
               "masked_spec_embed": backbone.masked_spec_embed,
               "decoder.blocks.0.ff.0.weight": pipe.decoder.blocks[0].ff[0].weight,
               "s_proj": state.s_proj.proj.net[0].weight}
    before = {n: p.detach().clone() for n, p in watched.items()}
    frontend = [p.detach().clone() for p in backbone.feature_extractor.parameters()]

    def run(apply_lfd=None):
        m = step(state, wav, x0, apply_lfd, generator=gen)
        torch.cuda.synchronize()
        return m

    t0 = time.time()
    warm = [run(True), run(False)]  # lazy init, both step variants
    warm_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    step_s, per_step, metrics = [], [], []
    for _ in range(TIMED_STEPS):  # steps 3..6: L_fd on step 4 only
        _reset_launches(FA)
        t0 = time.time()
        metrics.append(run())
        step_s.append(time.time() - t0)
        per_step.append(_launch_counts(FA))
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"fwd": 0, "fwd_lse": 2 * n_layers - 1, "bwd_dq": n_layers, "bwd_dkv": n_layers}
    if any(c != want for c in per_step):
        fail(f"kernel launches per fine-tune step {per_step}, expected {want}")
    lfd_steps = [i for i, m in enumerate(metrics) if "loss_fd" in m]
    if lfd_steps != [1]:
        fail(f"L_fd ran on timed steps {lfd_steps}, expected [1] (every 4th step)")
    losses = [float(m["total_loss"]) for m in warm + metrics]
    if not all(np.isfinite(losses)):
        fail(f"fine-tune loss not finite: {losses}")
    moved = {n: (p.detach() - before[n]).abs().max().item() for n, p in watched.items()}
    if not all(d > 0 for d in moved.values()):
        fail(f"fine-tune left parameters unchanged: {moved}")
    if not all(torch.equal(a, p)
               for a, p in zip(frontend, backbone.feature_extractor.parameters())):
        fail("the frozen conv front-end changed")

    breakdown = device_time_breakdown(run, statistics.median(step_s),
                                      ranges=(FA.BWD_DELTA_RANGE,))
    delta_ops = breakdown.pop("ranges")[FA.BWD_DELTA_RANGE]
    if delta_ops["count"] != n_layers:
        fail(f"the profiled fine-tune step shows {delta_ops['count']} {FA.BWD_DELTA_RANGE} "
             f"ranges, expected {n_layers}")
    print(json.dumps({"finetune_delta_ops": {
        **delta_ops, "device_ms_per_launch": delta_ops["device_ms"] / n_layers,
        "ops": "dout.float() * out.float(), .sum(-1) over the head dims, "
               ".transpose(1, 2).contiguous(): delta = rowsum(dO O) for B4 and B5"}}),
          flush=True)
    names = {"fwd_lse": ("gated_attention_bf16_kernel",), "bwd_dq": ("bwd_dq_bf16_kernel",),
             "bwd_dkv": ("bwd_dkv_bf16_kernel", "bwd_dbias_bf16_kernel")}
    breakdown["port_kernels_by_name"] = {t["name"]: t["ms"] for t in breakdown["all"]
                                         if any(n in t["name"] for ns in names.values()
                                                for n in ns)}
    breakdown["port_kernels_ms"] = {k: sum(t["ms"] for t in breakdown["all"]
                                           if any(n in t["name"] for n in ns))
                                    for k, ns in names.items()}
    for k, ns in names.items():
        if not all(any(n in t["name"] for t in breakdown["all"]) for n in ns):
            fail(f"the profiled fine-tune step shows no {ns} kernel")
    breakdown["port_kernel_ms_per_launch"] = {
        k: {"profiled": ms / per_step[0][k], "isolated": isolated[k]["ms"]}
        for k, ms in breakdown["port_kernels_ms"].items()}
    del breakdown["all"]
    print(json.dumps({"finetune_device_time": breakdown}), flush=True)
    result = {
        "card": card, "batch": B, "audio_s_per_example": seconds,
        "frames": enc_cfg.feat_extract_output_length(wav.shape[1]), "tokens": Lt,
        "step_s": statistics.median(step_s), "step_s_samples": step_s,
        "examples_per_s": B / statistics.median(step_s), "warmup_s": warm_s,
        "build_s": build_s, "peak_mem_gb": peak_mem_gb,
        "kernel_launches_per_step": per_step[0], "lfd_on_timed_step": lfd_steps,
        "metrics": [{k: float(v) for k, v in m.items()} for m in warm + metrics],
        "param_max_change": moved, "frontend_unchanged": True,
    }
    print(json.dumps({"finetune": result}), flush=True)
    return result


# -------------------------------------------- int8 and fused front-end path
def _bound(nbytes: float, ops: float, peak: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def int8_matmul_vs_plain(Q, M: int, din: int, dout: int, dtype, with_bias: bool, gen,
                         timed: bool) -> dict:
    """B7 against its plain version on x [M, din] (values up to a few units,
    so the row scales differ) and a weight of nn.Linear's init scale; output
    type = input type, as WavLM calls it.  Both hold the same exact integers
    and round the same f32 steps, so they agree within one ulp of the output
    type (f32: of each value; in practice bit for bit)."""
    dev = torch.device("cuda")
    x = (torch.randn(M, din, device=dev, generator=gen)
         * (0.5 + 2.0 * torch.rand(M, 1, device=dev, generator=gen))).to(dtype)
    weight = (torch.rand(dout, din, device=dev, generator=gen) * 2 - 1) / din ** 0.5
    bias = torch.randn(dout, device=dev, generator=gen) if with_bias else None
    wq_sw = Q.quantized_weight({}, "w", weight)
    out = Q.int8_matmul_fused_cuda(x, *wq_sw, bias, dtype)
    torch.cuda.synchronize()
    ref = Q.int8_matmul_fused_plain(x, weight, bias, dtype, wq_sw=wq_sw)
    err = (out.float() - ref.float()).abs()
    ulp = torch.finfo(dtype).eps * ref.float().abs().clamp(min=torch.finfo(dtype).tiny)
    row = {"M": M, "din": din, "dout": dout, "dtype": str(dtype).replace("torch.", ""),
           "bias": with_bias, "max_abs_err": err.max().item(),
           "not_identical": int((err > 0).sum().item()),
           "beyond_one_ulp": int((err > ulp).sum().item())}
    del err, ulp
    if timed:
        es = x.element_size()
        kernel = lambda: Q.int8_matmul_fused_cuda(x, *wq_sw, bias, dtype)  # noqa: E731
        # back-to-back calls by CUDA events, as every kernel's `ms`; the
        # kernel's own device time (profiler) beside it
        row["ms"] = time_ms(kernel, 20)
        row["device_ms"] = device_ms(kernel, 20, "int8_matmul_fused_kernel")
        row["workspace_bytes"] = Q.fused_workspace_bytes(M, din)
        row["plain_ms"] = time_ms(
            lambda: Q.int8_matmul_fused_plain(x, weight, bias, dtype, wq_sw=wq_sw), 3, 1)
        # yardstick: the port's own unfused `int8` mode on the same inputs
        lib = Q.int8_matmul(x, weight, bias, dtype, wq_sw=wq_sw)
        row["library_max_abs_diff"] = (lib.float() - out.float()).abs().max().item()
        row["library_ms"] = time_ms(
            lambda: Q.int8_matmul(x, weight, bias, dtype, wq_sw=wq_sw), 10)
        if dtype == torch.bfloat16:  # the yardstick int8 has to beat: the bf16 matmul
            wb = weight.bfloat16()
            row["bf16_matmul_ms"] = time_ms(lambda: torch.nn.functional.linear(x, wb), 10)
            row["bf16_matmul_device_ms"] = device_ms(
                lambda: torch.nn.functional.linear(x, wb), 10)
        else:
            row["bf16_matmul_ms"] = row["bf16_matmul_device_ms"] = None
        nbytes = M * din * es + din * dout + dout * 4 * (2 if with_bias else 1) + M * dout * es
        row["bound_ms"], row["bound_by"] = _bound(nbytes, 2.0 * M * din * dout, INT8_PEAK_OPS)
        if dtype == torch.float32:  # the same product as a float32 GEMM: FMA, and 3xTF32
            row["bound_f32_fma_ms"], row["bound_f32_fma_by"] = _bound(
                nbytes, 2.0 * M * din * dout, PEAK_FLOPS[torch.float32])
            row["bound_tc_ms"], row["bound_tc_by"] = _bound(nbytes, 3 * 2.0 * M * din * dout,
                                                            TF32_PEAK_FLOPS)
        # the weight's quantization, done once per weight and kept (ops/quant.quantized_weight)
        row["weight_quant_ms"] = time_ms(lambda: Q.quantized_weight({}, "w", weight), 5)
    print(json.dumps({"int8_matmul_vs_plain": row}), flush=True)
    if row["beyond_one_ulp"] or not torch.isfinite(out.float()).all():
        fail(f"fused int8 matmul disagrees with its plain version: {row}")
    return row


def conv_inputs(T: int, k: int, dtype, gen) -> tuple:
    """x [8, T, 512] in `dtype` and, in float32 as an `nn.Conv1d` layer
    holds them, its weight [512, 512, k] (its init scale) and bias, with
    ln_scale and ln_bias, on the card."""
    dev = torch.device("cuda")
    B, C = 8, 512
    x = torch.randn(B, T, C, device=dev, generator=gen).to(dtype)
    weight = (torch.rand(C, C, k, device=dev, generator=gen) * 2 - 1) / (k * C) ** 0.5
    b = torch.randn(C, device=dev, generator=gen) * 0.1
    ln_scale = torch.rand(C, device=dev, generator=gen) + 0.5
    ln_bias = torch.randn(C, device=dev, generator=gen) * 0.1
    return x, weight, b, ln_scale, ln_bias


def conv_vs_plain(CF, T: int, k: int, s: int, dtype, gelu_tanh: bool, gen, timed: bool) -> dict:
    """B8 against its plain version at B = 8, Cin = Cout = 512, with the
    weight in the form the fused layer passes it (`CF.kernel_weight`, and in
    float32 `CF.kernel_weight_tf32`)."""
    F = torch.nn.functional
    x, weight, b, ln_scale, ln_bias = conv_inputs(T, k, dtype, gen)
    B, C = x.shape[0], x.shape[2]
    cache = {}
    w = CF.kernel_weight(cache, weight, dtype)
    f32 = dtype == torch.float32

    def kernel():  # as models/wavlm.py calls it
        return CF.conv_ln_gelu_cuda(
            x, CF.kernel_weight(cache, weight, dtype), b, ln_scale, ln_bias, s,
            gelu_tanh=gelu_tanh, w_tf32=CF.kernel_weight_tf32(cache, weight) if f32 else None)

    with torch.no_grad():
        out = kernel()
        torch.cuda.synchronize()
        ref = CF.conv_ln_gelu_plain(x, w, b, ln_scale, ln_bias, s, gelu_tanh=gelu_tanh)
    T_out = (T - k) // s + 1 if T >= k else 0
    atol, rtol = CONV_TOL[dtype]
    row = {"T": T, "T_out": T_out, "k": k, "s": s, "dtype": str(dtype).replace("torch.", ""),
           "gelu": "tanh" if gelu_tanh else "erf", "atol": atol, "rtol": rtol}
    if tuple(out.shape) != (B, T_out, C) or out.shape != ref.shape:
        fail(f"conv+LN+GELU output shape {tuple(out.shape)}, expected {(B, T_out, C)}")
    if T_out:
        err = (out.float() - ref.float()).abs()
        row["max_abs_err"] = err.max().item()
        row["beyond_tol"] = int((err > atol + rtol * ref.float().abs()).sum().item())
        del err
        if row["beyond_tol"] or not torch.isfinite(out.float()).all():
            fail(f"conv+LN+GELU kernel disagrees with its plain version: {row}")
    del ref
    if timed:
        reps = 10
        with torch.no_grad():
            row["ms"] = time_ms(kernel, reps)
            row["device_ms"] = device_ms(
                kernel, reps, "conv_ln_gelu_tf32x3_kernel" if f32 else "conv_ln_gelu_bf16_kernel")
            row["plain_ms"] = time_ms(lambda: CF.conv_ln_gelu_plain(
                x, w, b, ln_scale, ln_bias, s, gelu_tanh=gelu_tanh), 2, 1)
            # yardstick: the unfused layer's three library calls, as models/wavlm.py runs them
            wt, bt = weight.to(dtype), b.to(dtype)
            ls, lb = ln_scale.to(dtype), ln_bias.to(dtype)

            def library():
                y = F.conv1d(x.transpose(1, 2), wt, bt, stride=s).transpose(1, 2)
                return F.gelu(F.layer_norm(y, (C,), ls, lb, 1e-5),
                              approximate="tanh" if gelu_tanh else "none")

            row["library_max_abs_diff"] = (library().float() - out.float()).abs().max().item()
            row["library_ms"] = time_ms(library, reps)
        es = x.element_size()
        nbytes = x.numel() * es + w.numel() * es + 3 * C * 4 + out.numel() * es
        row["bound_ms"], row["bound_by"] = _bound(
            nbytes, 2.0 * B * T_out * k * C * C, PEAK_FLOPS[dtype])
        if dtype == torch.float32:  # bound_ms is f32 FMA's; 3xTF32 on the tensor cores
            row["bound_tc_ms"], row["bound_tc_by"] = _bound(
                nbytes, 3 * 2.0 * B * T_out * k * C * C, TF32_PEAK_FLOPS)
    print(json.dumps({"conv_ln_gelu_vs_plain": row}), flush=True)
    torch.cuda.empty_cache()
    return row


def bhld_attention_vs_plain(FA, dtype, gen) -> dict:
    """B6's entry point, `wavlm_gated_attention` on [B, L, H, dh]: driven
    once through the dispatcher (its launch counted), held against its
    plain version, timed."""
    B, L, H = 8, 1024, 16
    q, k, v, bias, gate, mask = attention_inputs(B, L, H, dtype, gen)
    q4, k4, v4 = (x.view(B, L, H, 64) for x in (q, k, v))
    FA.wavlm_gated_attention_bhld_cuda.launches = 0
    out = FA.wavlm_gated_attention(q4, k4, v4, bias, gate, mask)
    torch.cuda.synchronize()
    launches = FA.wavlm_gated_attention_bhld_cuda.launches
    ref = FA.wavlm_gated_attention_bhld_plain(q4, k4, v4, bias, gate, mask)
    err = (out.float() - ref.float()).abs()
    row = {"L": L, "dtype": str(dtype).replace("torch.", ""), "launches": launches,
           "max_abs_err": err.max().item(), "tol": TOL[dtype]}
    if launches != 1 or tuple(out.shape) != (B, L, H, 64):
        fail(f"wavlm_gated_attention: {launches} launches, output {tuple(out.shape)}")
    del out, ref, err
    row["ms"] = time_ms(lambda: FA.wavlm_gated_attention_bhld_cuda(q4, k4, v4, bias, gate, mask), 20)
    row["plain_ms"] = time_ms(
        lambda: FA.wavlm_gated_attention_bhld_plain(q4, k4, v4, bias, gate, mask), 4, 1)
    float_mask = (gate[..., None] * bias[None].float()).masked_fill(
        ~mask[:, None, None, :], torch.finfo(torch.float32).min).to(dtype)
    heads = [x.transpose(1, 2) for x in (q4, k4, v4)]
    row["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=float_mask),
        4, 1)
    del float_mask
    row["bound_ms"], row["bound_by"] = attention_bound_ms(q, bias, gate, mask, H)
    print(json.dumps({"bhld_attention_vs_plain": row}), flush=True)
    if not row["max_abs_err"] <= TOL[dtype]:
        fail(f"wavlm_gated_attention disagrees with its plain version: {row}")
    torch.cuda.empty_cache()
    return row


def small_quant_pipeline_matches_cpu(tokenizer_dir: str) -> dict:
    """Phase 11: a small float32 pipeline with the int8 encoder (fused
    kernel), the fused conv front-end and the int8 decoder on the card and
    on the CPU (plain versions) from the same weights and x_T.  The
    encoder's output decides (see the module docstring); ids are printed."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    K, B, seq_len = 64, 2, 16
    cfg = Config({
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192,
                  "dtype": "float32", "quant_dense": "int8",
                  "encoder": {"wavlm_name": "tiny", "proj": "linear", "wavlm_config": {
                      "hidden_size": 128, "num_attention_heads": 2, "intermediate_size": 256,
                      "conv_dim": [128] * 7, **FUSED_WAVLM_CONFIG}}},
        "diffusion": {"T": 200, "beta_max": 0.2},
    })
    tok = load_tokenizer(synthetic_tokenizer(tokenizer_dir, K))
    cpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cpu")
    gpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cuda")
    gpu.decoder.load_state_dict(cpu.decoder.state_dict())
    gpu.encoder.load_state_dict(cpu.encoder.state_dict())
    wav = synthetic_audio(B, 1.0, seed=1)
    wav[1, 8000:] = 0.0
    x_init = np.random.default_rng(2).integers(0, K, (B, seq_len))
    sampling = dict(T_infer=20, r=5, greedy=True, x_init=x_init)
    wrappers = port_kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    got = gpu.transcribe_with_ids(wav, seq_len=seq_len, **sampling)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in wrappers.items() if f.launches}
    n_layers = gpu.encoder.config.num_hidden_layers
    want = {"fwd": n_layers, "int8_matmul_fused": 6 * n_layers, "conv_ln_gelu": 6}
    c_gpu, _ = gpu.encode_waveform(wav)
    c_cpu, _ = cpu.encode_waveform(wav)
    feat_err = (c_gpu.cpu() - c_cpu).abs().max().item()
    ids_cpu, p_cpu = cpu.sample(c_cpu, seq_len, **sampling)
    got_ids = torch.tensor([r[1] for r in got])
    differ = (got_ids != ids_cpu).nonzero().tolist()
    top2 = p_cpu.topk(2, dim=-1).values
    result = {"launches": counts, "expected_launches": want, "encoder_max_abs_err": feat_err,
              "encoder_tol": SMALL_QUANT_ENCODER_TOL, "ids_equal": not differ,
              "ids_card": got_ids.tolist(), "ids_cpu": ids_cpu.tolist(),
              "cpu_margin_where_ids_differ": [
                  {"at": [b, i], "margin": (top2[b, i, 0] - top2[b, i, 1]).item()}
                  for b, i in differ]}
    print(json.dumps({"small_quant_pipeline_card_vs_cpu": result}), flush=True)
    if counts != want:
        fail(f"small quantized pipeline launches {counts}, expected {want}")
    if not feat_err <= SMALL_QUANT_ENCODER_TOL or not torch.isfinite(c_gpu).all():
        fail(f"small quantized pipeline encoder, card vs CPU: max abs err {feat_err}")
    return result


def transcribe_quantized_full_width(FA, tokenizer_dir: str, card: str, base_feats) -> dict:
    """Phase 12: the int8_fused + fused front-end configuration, the same
    with the library's int8 product and with no int8 at all (`quant_dense:
    none`: what the front-end and the tanh GELU do alone), and the int8
    encoder's output against that full-precision one."""
    fused = transcribe_full_width(
        FA, tokenizer_dir, card, "transcribe_int8_fused", FUSED_WAVLM_CONFIG,
        {"fwd": 24, "int8_matmul_fused": 144, "conv_ln_gelu": 6})
    library = transcribe_full_width(
        FA, tokenizer_dir, card, "transcribe_int8", {**FUSED_WAVLM_CONFIG, "quant_dense": "int8"},
        {"fwd": 24, "conv_ln_gelu": 6})
    front = transcribe_full_width(
        FA, tokenizer_dir, card, "transcribe_fused_frontend",
        {**FUSED_WAVLM_CONFIG, "quant_dense": "none"}, {"fwd": 24, "conv_ln_gelu": 6})
    ref = front["feats"].float()
    # phase 4's configuration once more, late in the process: the host's share of the wall
    # time grows over the run, so walls compare only between neighbours
    repeat = transcribe_full_width(FA, tokenizer_dir, card, "transcribe_repeat")
    fused["transcribe_repeat"] = {k: v for k, v in repeat.items() if k != "feats"}

    def rel_l2(a):
        return ((a.float() - ref).norm() / ref.norm()).item()

    result = {"int8_fused_vs_full_precision": rel_l2(fused["feats"]),
              "int8_vs_full_precision": rel_l2(library["feats"]),
              "int8_fused_vs_int8": ((fused["feats"].float() - library["feats"].float()).norm()
                                     / library["feats"].float().norm()).item(),
              "fused_frontend_tanh_vs_phase_4": rel_l2(base_feats),
              "bounds": list(QUANT_REL_L2)}
    print(json.dumps({"quantized_encoder_rel_l2": result}), flush=True)
    lo, hi = QUANT_REL_L2
    if not lo < result["int8_fused_vs_full_precision"] < hi:
        fail(f"int8_fused encoder vs full precision: rel L2 {result} outside ({lo}, {hi})")
    if not result["fused_frontend_tanh_vs_phase_4"] > lo:
        fail("fused_frontend + gelu_approx_tanh left the encoder's output unchanged")
    return fused


# ------------------------------------------------- the transcription surface
NBEST_N = 4
CLI_MAIN_CONFIG = os.path.join("configs", "fddm_zhTW_base.yaml")  # relative to the repo
# phase 15 (c)'s whole 100 s WAV: its frames, padded to a multiple of 128
WHOLE_FILE_FRAMES, WHOLE_FILE_L = 4999, 5120
CLI_RUNS = ("a_csv_best_of_4", "b_180s_in_20s_windows", "c_100s_whole_file")


def _flagship_pipeline(tokenizer_dir: str, seed: int = None):
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    cfg = flagship_config(synthetic_tokenizer(tokenizer_dir, 8000))
    return cfg, FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path),
                                         seed=seed)


def _counts_since_reset(wrappers: dict) -> dict:
    return {k: f.launches for k, f in wrappers.items()}


def _reset(wrappers: dict) -> None:
    for f in wrappers.values():
        f.launches = 0


def nbest_full_width(tokenizer_dir: str, card: str, phase4: dict, repeat: dict) -> dict:
    """Phase 13: phase 4's batch (8 x 20 s, full width, same weights and
    sampling) best-of-4, timed as phase 4 times `transcribe`: the encoder
    runs once (B1 24 launches) and every decoder call takes the 32 folded
    rows; the rows are the most confident of `transcribe_nbest`'s
    candidates; wall, RTFx, peak memory and busy time beside phase 4's and
    phase 12's `transcribe_repeat` (phase 4's configuration late in the
    process)."""
    B, seconds = 8, 20.0
    _, pipe = _flagship_pipeline(tokenizer_dir)
    n_layers = pipe.encoder.config.num_hidden_layers
    wav = synthetic_audio(B, seconds, seed=0)
    sampling = dict(T_infer=20, r=5, greedy=True, posterior_mode="map", sampling_mode="exact")
    decoder_rows = []
    hook = pipe.decoder.register_forward_pre_hook(
        lambda module, args: decoder_rows.append(args[0].shape[0]))

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = pipe.transcribe_with_ids(wav, seq_len=64, generator=gen, with_confidence=True,
                                        num_candidates=NBEST_N, **sampling)
        torch.cuda.synchronize()
        return rows

    gc.collect()
    run()
    torch.cuda.reset_peak_memory_stats()
    wrappers = port_kernel_wrappers()
    _reset(wrappers)
    decoder_rows.clear()
    rows = run()  # the main path's run: its launches are counted
    counts = _counts_since_reset(wrappers)
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    rows_seen = list(decoder_rows)
    want = {k: 0 for k in wrappers}
    want["fwd"] = n_layers
    if counts != want:
        fail(f"kernel launches in one best-of-{NBEST_N} transcribe {counts}, expected {want}")
    if rows_seen != [B * NBEST_N] * 4:
        fail(f"decoder calls took {rows_seen} rows, expected four of {B * NBEST_N}")
    step_samples = seconds_of(run, REPEATS)
    hook.remove()
    nbest = pipe.transcribe_nbest(wav, seq_len=64, generator=torch.Generator(
        device="cuda").manual_seed(0), num_candidates=NBEST_N, **sampling)
    if [r[1:] for r in rows] != [(u[0][1], u[0][2]) for u in nbest]:
        fail("best-of-N rows are not the most confident of transcribe_nbest's candidates")
    if not all(len(u) == NBEST_N and all(0 <= i < 8000 for c in u for i in c[1]) for u in nbest):
        fail("transcribe_nbest did not give 4 candidates of in-range ids per utterance")
    step_s = statistics.median(step_samples)
    breakdown = device_time_breakdown(run, step_s)
    breakdown["port_kernels_ms"] = {"fwd": sum(t["ms"] for t in breakdown["all"]
                                               if "gated_attention_bf16_kernel" in t["name"])}
    del breakdown["all"]
    print(json.dumps({"nbest_device_time": breakdown}), flush=True)

    def beside(r):
        return {k: r[k] for k in ("step_s", "rtfx", "peak_mem_gb", "device_busy_ms",
                                  "idle_share")}

    result = {"card": card, "candidates": NBEST_N, "audio_s": B * seconds,
              "step_s": step_s, "rtfx": B * seconds / step_s, "step_s_samples": step_samples,
              "repeats": REPEATS, "peak_mem_gb": peak_mem_gb,
              "device_busy_ms": breakdown["device_busy_ms"],
              "idle_share": breakdown["idle_share"], "launches": {k: n for k, n in counts.items()
                                                                  if n},
              "decoder_rows_per_call": rows_seen, "example_confidence": rows[0][2],
              "confidences_of_utterance_0": [c[2] for c in nbest[0]],
              "phase_4": beside(phase4), "transcribe_repeat": beside(repeat)}
    print(json.dumps({"nbest": result}), flush=True)
    return result


def evaluators_full_width(tokenizer_dir: str, card: str) -> dict:
    """Phase 14: two batches of 8 x 20 s with 64-token targets (random ids,
    eos then pad after 40-63 tokens) at full width through the four
    evaluators; each value, wall time and launch counts (B1: 24 per encoded
    batch, so 48 each)."""
    from collections import namedtuple

    from fddm_asr_tpu_torch import eval as E

    cfg, pipe = _flagship_pipeline(tokenizer_dir)
    pad, eos = pipe.pad_id, pipe.special_ids["eos_id"]
    Batch = namedtuple("Batch", "wave wave_lengths tokens")
    rng = np.random.default_rng(31)
    batches = []
    for i in range(2):
        wav = synthetic_audio(8, 20.0, seed=40 + i)
        tokens = rng.integers(4, 8000, (8, 64))
        for b, n in enumerate(rng.integers(40, 64, 8)):
            tokens[b, n], tokens[b, n + 1:] = eos, pad
        batches.append(Batch(wav, np.full(8, wav.shape[1]), tokens))
    runs = {
        "validation_loss": lambda: E.evaluate_validation_loss(pipe, batches),
        "validation_kl_sampled": lambda: E.evaluate_validation_kl_sampled(pipe, batches),
        "cer_full_sampling": lambda: E.evaluate_cer_with_full_sampling(pipe, batches, cfg),
        "cer_multi_sample_logprob": lambda: E.evaluate_cer_with_multi_sample(
            pipe, batches, cfg, voting="logprob", num_samples=3),
    }
    pipe.encode_waveform(batches[0].wave)  # warm-up
    wrappers = port_kernel_wrappers()
    want = {k: 0 for k in wrappers}
    want["fwd"] = 2 * pipe.encoder.config.num_hidden_layers
    result = {"card": card, "batches": 2, "batch": "8 x 20 s, 64-token targets"}
    for name, fn in runs.items():
        _reset(wrappers)
        torch.cuda.synchronize()
        t0 = time.time()
        value = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _counts_since_reset(wrappers)
        result[name] = {"value": value, "wall_s": wall,
                        "launches": {k: n for k, n in counts.items() if n}}
        if counts != want:
            fail(f"{name}: kernel launches {counts}, expected {want}")
        if not (np.isfinite(value) and value > 0):
            fail(f"{name} gave {value}: expected a finite positive value for random weights")
    print(json.dumps({"eval": result}), flush=True)
    return result


def write_hf_wavlm(backbone, directory: str) -> None:
    """The port's WavLM as a Hugging Face directory: config.json and
    pytorch_model.bin, the positional conv as weight_g / weight_v (HF's
    weight norm over dim 2), float32."""
    import dataclasses

    os.makedirs(directory, exist_ok=True)
    sd = {k: v.detach().float().cpu() for k, v in backbone.state_dict().items()}
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    sd["encoder.pos_conv_embed.conv.weight_g"] = w.norm(dim=(0, 1), keepdim=True)
    sd["encoder.pos_conv_embed.conv.weight_v"] = w
    torch.save(sd, os.path.join(directory, "pytorch_model.bin"))
    fields = dataclasses.asdict(backbone.cfg)
    keys = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
            "conv_dim", "conv_kernel", "conv_stride", "conv_bias", "feat_extract_norm",
            "do_stable_layer_norm", "num_buckets", "max_bucket_distance",
            "num_conv_pos_embeddings", "num_conv_pos_embedding_groups", "layer_norm_eps",
            "feat_proj_dropout", "hidden_dropout", "attention_dropout", "activation_dropout")
    config = {"model_type": "wavlm", "architectures": ["WavLMModel"],
              **{k: list(fields[k]) if isinstance(fields[k], tuple) else fields[k] for k in keys}}
    with open(os.path.join(directory, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2)


def _cli_output(stdout: str) -> list:
    out = stdout.strip()
    if out.startswith("{\n"):
        return [json.loads(out)]
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def cli_full_width(tokenizer_dir: str, card: str) -> dict:
    """Phase 15: the port's CLI in a subprocess (`python3 -m
    fddm_asr_tpu_torch.inference`) from configs/fddm_zhTW_base.yaml and
    configs/diffusion.yaml, with `--wavlm-ckpt` an HF directory written from
    a seeded random WavLM-large and `--ckpt` a random decoder's bare
    state_dict: (a) a 16-row CSV (20 s each, a `text` column) 8 a batch,
    bucketed to whole seconds, best-of-4 with confidence, ending in the CER
    summary; (b) a 180 s WAV in silence-cut 20 s windows (9 or 10); (c) a
    100 s WAV whole (4999 frames, padded to 5120: the gated-attention
    kernel past 4096 frames, the TPU's B2).  Each run's ids against the
    CLI's own `transcribe` of the same arguments in this process, on the
    pipeline `build_pipeline` makes of them; each run's wall and launches
    from `--stats-json` (the process's first calls included), and the
    in-process wall of the same work; (c) once more under the profiler for
    the kernel's device time at L = 5120."""
    import fddm_asr_tpu_torch.models.wavlm as W
    from fddm_asr_tpu_torch import inference as cli
    from fddm_asr_tpu_torch.data.audio_io import load_audio, save_wav

    root = os.path.dirname(os.path.abspath(__file__))
    d = tokenizer_dir
    _, pipe = _flagship_pipeline(d, seed=5)
    ckpt = os.path.join(d, "decoder.pt")
    torch.save({k: v.cpu() for k, v in pipe.decoder.state_dict().items()}, ckpt)
    hf_dir = os.path.join(d, "wavlm-large")
    write_hf_wavlm(pipe.encoder.backbone, hf_dir)
    del pipe
    rng = np.random.default_rng(50)
    csv_path = os.path.join(d, "set.csv")
    rows = []
    for i in range(16):
        path = os.path.join(d, f"u{i:02d}.wav")
        save_wav(path, synthetic_audio(1, 20.0, seed=100 + i)[0], 16000)
        text = "".join(chr(0x4E00 + int(j)) for j in rng.integers(0, 7996, int(rng.integers(8, 21))))
        rows.append(f"{path},{text}")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write("path,text\n" + "\n".join(rows) + "\n")
    p180, p100 = os.path.join(d, "long180.wav"), os.path.join(d, "long100.wav")
    save_wav(p180, synthetic_audio(1, 180.0, seed=200)[0], 16000)
    save_wav(p100, synthetic_audio(1, 100.0, seed=201)[0], 16000)
    base = ["--ckpt", ckpt, "--main-config", os.path.join(root, CLI_MAIN_CONFIG),
            "--diffusion-config", os.path.join(root, "configs", "diffusion.yaml"),
            "--tokenizer", os.path.join(d, "spm_synth.vocab"), "--wavlm-ckpt", hf_dir, "--greedy"]
    extra = {"a_csv_best_of_4": ["--csv", csv_path, "--batch-size", "8", "--bucket-seconds", "1",
                                 "--num-candidates", str(NBEST_N), "--confidence"],
             "b_180s_in_20s_windows": ["--wav", p180, "--chunk-seconds", "20"],
             "c_100s_whole_file": ["--wav", p100]}
    audio_s = {"a_csv_best_of_4": 320.0, "b_180s_in_20s_windows": 180.0, "c_100s_whole_file": 100.0}
    gc.collect()
    torch.cuda.empty_cache()  # the subprocess needs the memory this process has cached
    result = {"card": card}
    printed = {}
    for name in CLI_RUNS:
        stats_path = os.path.join(d, f"{name}.stats.json")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "fddm_asr_tpu_torch.inference", *extra[name], *base,
             "--stats-json", stats_path], cwd=root, capture_output=True, text=True,
            timeout=600)
        process_s = time.time() - t0
        if proc.returncode != 0:
            fail(f"CLI run {name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        printed[name] = _cli_output(proc.stdout)
        with open(stats_path, encoding="utf-8") as f:
            stats = json.load(f)
        result[name] = {"process_s": process_s, "build_s": stats["build_s"],
                        "transcribe_s": stats["transcribe_s"],
                        "rtfx": audio_s[name] / stats["transcribe_s"],
                        "launches": {k: n for k, n in stats["launches"].items() if n}}

    # the same three runs through the CLI's own `transcribe` in this process, on the
    # pipeline it builds from the same arguments
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as in the CLI's process
    try:
        run_args = {name: cli.parse_args([*extra[name], *base]) for name in CLI_RUNS}
        pipe = cli.build_pipeline(run_args["a_csv_best_of_4"])
        n_layers = pipe.encoder.config.num_hidden_layers
        wrappers = port_kernel_wrappers()

        def timed(fn):
            _reset(wrappers)
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            return out, time.time() - t0, _counts_since_reset(wrappers)

        built_mask = pipe.use_condition_mask
        long180 = load_audio(p180, target_sr=16000)[0]
        spans = cli.chunk_spans(long180, 320000, run_args["b_180s_in_20s_windows"].chunk_align)
        long100 = load_audio(p100, target_sr=16000)[0]
        attention_L = []
        kernel_route = W.wavlm_gated_attention_heads_packed

        def recording(q, *a, **k):
            attention_L.append(q.shape[1])
            return kernel_route(q, *a, **k)

        def run(name):
            pipe.use_condition_mask = built_mask  # as the CLI's process finds it
            return cli.transcribe(pipe, run_args[name])

        expect_fwd = {"a_csv_best_of_4": 2 * n_layers,
                      "b_180s_in_20s_windows": -(-len(spans) // 8) * n_layers,
                      "c_100s_whole_file": n_layers}
        W.wavlm_gated_attention_heads_packed = recording
        try:
            for name in CLI_RUNS:
                run(name)  # warm: this process has run nothing at these shapes yet
                attention_L.clear()
                out, wall, counts = timed(lambda: run(name))
                r = result[name]
                r.update({"in_process_s": wall, "in_process_rtfx": audio_s[name] / wall,
                          "in_process_launches": {k: n for k, n in counts.items() if n},
                          "ids_equal_in_process": [x["ids"] for x in out] == [
                              x["ids"] for x in printed[name] if "ids" in x],
                          "attention_L": sorted(set(attention_L))})
                want = {k: 0 for k in wrappers}
                want["fwd"] = expect_fwd[name]
                if counts != want or {k: r["launches"].get(k, 0) for k in wrappers} != want:
                    fail(f"CLI run {name}: launches {r['launches']} (CLI), {counts} (in "
                         f"process), expected {want}")
                if not r["ids_equal_in_process"]:
                    fail(f"CLI run {name}: ids differ from the in-process pipeline's")
        finally:
            W.wavlm_gated_attention_heads_packed = kernel_route
        breakdown = device_time_breakdown(lambda: run("c_100s_whole_file"),
                                          result["c_100s_whole_file"]["in_process_s"])
        fwd_ms = sum(t["ms"] for t in breakdown["all"] if "gated_attention_bf16_kernel" in t["name"])
        result["c_100s_whole_file"].update({
            "device_busy_ms": breakdown["device_busy_ms"], "idle_share": breakdown["idle_share"],
            "gated_attention_device_ms": fwd_ms, "gated_attention_ms_per_launch": fwd_ms / n_layers,
            "frames": pipe.encoder.config.feat_extract_output_length(len(long100))})
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32

    a, b, c = (printed[n] for n in CLI_RUNS)
    result["a_csv_best_of_4"].update({"rows": len(a) - 1, "summary": a[-1],
                                      "example": {k: a[0][k] for k in ("text", "confidence",
                                                                        "cer")}})
    result["b_180s_in_20s_windows"].update({"windows": len(b[0]["chunks"]), "spans": spans,
                                            "confidence": b[0].get("confidence")})
    print(json.dumps({"cli": result}, ensure_ascii=False), flush=True)
    if len(a) != 17 or a[-1].get("summary") != "cer" or a[-1].get("utterances") != 16:
        fail(f"CLI run a: expected 16 rows and a CER summary line, got {a[-1]}")
    if not 9 <= len(spans) <= 10 or len(b[0]["chunks"]) != len(spans):
        fail(f"CLI run b: {len(b[0]['chunks'])} windows ({len(spans)} planned), expected 9-10")
    if (result["c_100s_whole_file"]["attention_L"] != [WHOLE_FILE_L]
            or result["c_100s_whole_file"]["frames"] != WHOLE_FILE_FRAMES):
        fail(f"CLI run c: attention at L = {result['c_100s_whole_file']['attention_L']} over "
             f"{result['c_100s_whole_file']['frames']} frames, expected {WHOLE_FILE_L} over "
             f"{WHOLE_FILE_FRAMES} (phase 2's whole-file shape)")
    return result


SERVE_FLAGS = ["--max-batch", "16", "--max-wait-ms", "20", "--pipeline-depth", "2",
               "--bucket-seconds", "1", "--max-seconds", "30", "--warmup-seconds", "5,20"]
SERVE_SERIAL_SECONDS = (0.02, 3.2, 7.5, 20.0)
# (c): durations U(2, 20) s from the seed; the timed window's requests, then
# the traced window's
SERVE_REQUESTS, SERVE_TRACED_REQUESTS, SERVE_CLIENTS, SERVE_SEED = 256, 64, 16, 16
SERVE_LONG_SECONDS, SERVE_LONG_SEED, SERVE_STREAM_WINDOW_S = 100.0, 201, 20.0
# the JAX server's result schema (serve.py `_finalize`)
SERVE_RESULT_KEYS = {"wav", "text", "ids", "confidence", "T_infer", "r", "greedy",
                     "posterior_mode"}


def _wav_bytes(path: str, wav: np.ndarray) -> bytes:
    from fddm_asr_tpu_torch.data.audio_io import save_wav

    save_wav(path, wav, 16000)
    with open(path, "rb") as f:
        return f.read()


def _http(base: str, method: str, path: str, body=None, headers=None, chunked=False):
    """(status, body bytes) of one request on its own connection."""
    import http.client

    conn = http.client.HTTPConnection(base.split("//")[1], timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {}, encode_chunked=chunked)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _served_shape(lengths: list) -> tuple:
    """(Bp, T) the engine must pad a batch of these request lengths to under
    SERVE_FLAGS: the next power of two rows up to 16; T the longest length
    rounded up to whole seconds, at least 400 samples, at most 30 s."""
    from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD

    Bp = min(16, 1 << max(0, (len(lengths) - 1).bit_length()))
    T = max(-(-max(max(lengths), 1) // 16000) * 16000, CONV_RECEPTIVE_FIELD)
    return Bp, min(T, 30 * 16000)


def _recomputed_ids(engine, record: dict) -> list:
    """The rows of one dispatched batch as `transcribe_with_ids` gives them
    on the same padded batch and lengths, its generator seeded at the
    engine's counter for that batch; pad rows (0.1 s) dropped."""
    from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD

    waves = [r.wave for r in record["reqs"]]
    Bp, T = _served_shape([len(w) for w in waves])
    if (Bp, T) != record["shape"]:
        fail(f"a served batch of {[len(w) for w in waves]} samples took shape {record['shape']}, "
             f"expected {(Bp, T)}")
    batch = np.zeros((Bp, T), np.float32)
    lengths = np.full((Bp,), min(1600, T), np.int64)
    for i, w in enumerate(waves):
        batch[i, :len(w)] = w
        lengths[i] = max(len(w), CONV_RECEPTIVE_FIELD)
    gen = torch.Generator(device=engine.device).manual_seed(record["counter"])
    rows = engine.pipeline.transcribe_with_ids(batch, lengths, seq_len=engine.seq_len,
                                               generator=gen, with_confidence=True,
                                               **engine.sampling)
    return [row[1] for row in rows[:len(waves)]]


def serve_full_width(d: str, card: str) -> dict:
    """Phase 16: the port's server (`fddm_asr_tpu_torch.serve`) at full width:
    configs/fddm_zhTW_base.yaml's model with the random decoder `.pt` and
    the synthetic tokenizer phase 15 wrote in `d`, a random encoder from the
    config's seed, started in this process by `build_server(parse_args(...))`
    on port 0 with SERVE_FLAGS.  (a) the warm-up's ten calls; (b) four
    uploads one at a time (0.02, 3.2, 7.5, 20 s), each a batch of one whose
    ids must equal `transcribe_with_ids` on the same padded batch at the
    engine's counter; (c) (`_serve_load`) the load's buckets warmed, 256
    uploads of 2-20 s by 16 client threads untraced (requests/s, audio s/s,
    latency percentiles, /stats, B1 launches, 24 a batch, counted from 0
    just before, peak memory), 64 more under the profiler (busy time and
    idle share), and the syncs one batch's dispatch makes under
    `torch.cuda.set_sync_debug_mode("warn")`;
    (d) one 100 s recording to `?stream=1` (a line a 30 s window, then the
    aggregate) and as chunked pcm16 to `/v1/transcribe/stream` at 20 s
    windows (its chunks the plan's windows; its aggregate that of a
    `submit` of the same audio at that window, same batch and counter);
    every batch served in (b)-(d) recomputed as in (b); (e) `python3 -m
    fddm_asr_tpu_torch.serve` in a subprocess: start to ready, one request,
    phase 23 (f)'s `stream_client` run (`stream_client_work`), stopped by
    SIGINT."""
    import threading

    from fddm_asr_tpu_torch import serve as S
    from fddm_asr_tpu_torch.data.audio_io import plan_silence_chunks

    root = os.path.dirname(os.path.abspath(__file__))
    base_args = ["--config", os.path.join(root, CLI_MAIN_CONFIG),
                 "--ckpt", os.path.join(d, "decoder.pt"),
                 "--tokenizer", os.path.join(d, "spm_synth.vocab")]
    gc.collect()
    torch.cuda.empty_cache()
    wrappers = port_kernel_wrappers()
    result = {"card": card, "flags": SERVE_FLAGS}

    # (a) build and warm up
    _reset(wrappers)
    t0 = time.time()
    srv = S.build_server(S.parse_args([*base_args, "--port", "0", *SERVE_FLAGS]))
    engine = srv.engine
    n_layers = engine.pipeline.encoder.config.num_hidden_layers
    result["build_and_warmup_s"] = time.time() - t0
    result["warmup"] = srv.warmup
    warm_counts = _counts_since_reset(wrappers)
    if len(srv.warmup) != 10 or warm_counts["fwd"] != 10 * n_layers:
        fail(f"warm-up: {len(srv.warmup)} calls and {warm_counts} launches, expected 10 calls "
             f"(B in 1..16 x 5 s, 20 s) and {10 * n_layers} B1 launches")
    if engine._rng_counter != 0:
        fail("warm-up moved the engine's counter")
    dispatched = _record_dispatches(engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def check_batches(records, what):
        return _check_batches(engine, records, what)

    try:
        # (b) serial correctness
        serial = []
        for i, seconds in enumerate(SERVE_SERIAL_SECONDS):
            body = _wav_bytes(os.path.join(d, f"serial{i}.wav"),
                              synthetic_audio(1, seconds, seed=400 + i)[0])
            n_before = len(dispatched)
            status, raw = _http(base, "POST", "/v1/transcribe", body,
                                {"Content-Type": "audio/wav"})
            obj = json.loads(raw)
            recs = dispatched[n_before:]
            if status != 200 or set(obj) != SERVE_RESULT_KEYS:
                fail(f"(b) {seconds} s: status {status}, keys {sorted(obj)}")
            if not np.isfinite(obj["confidence"]) or len(recs) != 1 or recs[0]["shape"][0] != 1:
                fail(f"(b) {seconds} s: confidence {obj['confidence']}, batches "
                     f"{[r['shape'] for r in recs]} (expected one of one row)")
            check_batches(recs, f"(b) {seconds} s")
            serial.append({"seconds": seconds, "shape": recs[0]["shape"],
                           "counter": recs[0]["counter"], "ids_equal": True,
                           "confidence": obj["confidence"], "n_ids": len(obj["ids"])})
        result["serial"] = serial

        # (c) load: 256 + 64 uploads of 2-20 s by 16 closed-loop clients
        result["load"] = _serve_load(engine, base, d, wrappers, dispatched, n_layers)

        # (d) long-form: 100 s to ?stream=1 at 30 s windows, and as a chunked
        # pcm16 stream at 20 s windows
        body = _wav_bytes(os.path.join(d, "long100.wav"),
                          synthetic_audio(1, SERVE_LONG_SECONDS, seed=SERVE_LONG_SEED)[0])
        wave = S._decode_wav_bytes(body)
        plan30 = plan_silence_chunks(wave, 30 * 16000)
        n_before = len(dispatched)
        status, raw = _http(base, "POST", "/v1/transcribe?stream=1", body,
                            {"Content-Type": "audio/wav"})
        lines = [json.loads(x) for x in raw.decode("utf-8").splitlines() if x.strip()]
        partials, agg = lines[:-1], lines[-1]
        if (status != 200 or len(plan30) < 4 or len(partials) != len(plan30)
                or [p.get("chunk_index") for p in partials] != list(range(len(plan30)))
                or any(p.get("chunk_count") != len(plan30) for p in partials)
                or agg.get("chunks") != [p["text"] for p in partials]
                or agg.get("ids") != [p["ids"] for p in partials]):
            fail(f"(d) ?stream=1: status {status}, {len(partials)} partials for "
                 f"{len(plan30)} planned windows, aggregate keys {sorted(agg)}")
        recs30 = dispatched[n_before:]
        if [r.wave.tobytes() for rec in recs30 for r in rec["reqs"]] != [
                wave[s:e].tobytes() for s, e in plan30]:
            fail("(d) ?stream=1: the served windows are not plan_silence_chunks' windows")
        checked = check_batches(recs30, "(d) ?stream=1")

        pcm = np.round(wave * 32768.0).astype("<i2").tobytes()  # the WAV's own samples
        plan20 = plan_silence_chunks(wave, int(SERVE_STREAM_WINDOW_S * 16000))
        max_wait, counter = engine.max_wait_s, engine._rng_counter
        engine.max_wait_s = 2.0  # every window of the stream in one batch, as submit's
        n_before = len(dispatched)
        try:
            status, raw = _http(
                base, "POST", f"/v1/transcribe/stream?format=pcm16&window-seconds="
                f"{SERVE_STREAM_WINDOW_S}", (pcm[i:i + 32000] for i in range(0, len(pcm), 32000)),
                chunked=True)
            recs_stream = dispatched[n_before:]
            engine._rng_counter = counter
            engine.max_samples = int(SERVE_STREAM_WINDOW_S * 16000)
            submitted = engine.submit(wave, "<stream:pcm16>")
            recs_submit = dispatched[n_before + len(recs_stream):]
        finally:
            engine.max_wait_s, engine.max_samples = max_wait, 30 * 16000
        lines = [json.loads(x) for x in raw.decode("utf-8").splitlines() if x.strip()]
        stream_agg = lines[-1]
        chunks = [r.wave.tobytes() for rec in recs_stream for r in rec["reqs"]]
        if status != 200 or chunks != [wave[s:e].tobytes() for s, e in plan20]:
            fail(f"(d) stream: status {status}, {len(chunks)} chunks committed, "
                 f"{len(plan20)} planned, or their samples differ")
        if len(lines) != len(plan20) + 1 or stream_agg != submitted:
            fail(f"(d) stream: {len(lines) - 1} partials for {len(plan20)} windows, or its "
                 "aggregate differs from submit's at the same window, batch and counter "
                 f"(batches {[r['shape'] for r in recs_stream]} and "
                 f"{[r['shape'] for r in recs_submit]})")
        checked += check_batches(recs_stream + recs_submit, "(d) stream")
        result["long_form"] = {
            "seconds": SERVE_LONG_SECONDS, "stream_1_windows": len(plan30),
            "stream_1_spans": plan30, "chunked_pcm16_windows": len(plan20),
            "chunked_pcm16_spans": plan20,
            "chunked_batches": [r["shape"] for r in recs_stream],
            "aggregate_equals_submit": True, "batches_recomputed": checked}
    finally:
        srv.shutdown()
        srv.server_close()
        engine.shutdown()
    del srv, engine
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the process entry point
    result["process"] = _serve_process(base_args, d, "serve", 300, work=stream_client_work(d))
    from fddm_asr_tpu_torch.data.mp3 import mpg123_available

    # what path mode can read on this machine besides WAV
    result["mp3_decoders"] = {"libmpg123": mpg123_available(),
                              "ffmpeg": shutil.which("ffmpeg") is not None}
    print(json.dumps({"serve": result}, ensure_ascii=False), flush=True)
    return result


def _record_dispatches(engine) -> list:
    """Wrap the engine's `_dispatch` to record, for every batch it queues,
    the counter it seeded the batch's generator with, its requests and its
    (Bp, T); returns the list the records go to."""
    dispatched = []
    dispatch = engine._dispatch

    def recording(batch):
        out = dispatch(batch)
        dispatched.append({"counter": engine._rng_counter, "reqs": list(batch),
                           "shape": engine._plan_shape(batch)})
        return out

    engine._dispatch = recording
    return dispatched


def _serve_process(args: list, d: str, tag: str, ready_limit_s: float, work=None) -> dict:
    """`python3 -m fddm_asr_tpu_torch.serve *args --port 0` in a subprocess:
    seconds from start to its serving line, one 5 s upload (the JAX
    server's result keys), `/healthz`, `work(url)`'s result when given, and
    exit 0 on SIGINT."""
    import queue as queue_mod
    import signal
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    stderr_path = os.path.join(d, f"{tag}.stderr")
    with open(stderr_path, "w") as stderr:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fddm_asr_tpu_torch.serve", *args, "--port", "0"],
            cwd=root, stdout=subprocess.PIPE, stderr=stderr, text=True)
    lines_q = queue_mod.Queue()
    threading.Thread(target=lambda: [lines_q.put(x) for x in proc.stdout], daemon=True).start()
    t0 = time.time()
    try:
        ready = None
        while ready is None:
            try:
                line = lines_q.get(timeout=max(1.0, ready_limit_s - (time.time() - t0)))
            except queue_mod.Empty:
                fail(f"(e) the server process printed no serving line in {ready_limit_s} s")
            if line.startswith('{"serving"'):
                ready = json.loads(line)
        ready_s = time.time() - t0
        body = _wav_bytes(os.path.join(d, "e.wav"), synthetic_audio(1, 5.0, seed=700)[0])
        t1 = time.time()
        status, raw = _http(ready["serving"], "POST", "/v1/transcribe", body,
                            {"Content-Type": "audio/wav"})
        first_request_s = time.time() - t1
        obj = json.loads(raw)
        status_h, raw_h = _http(ready["serving"], "GET", "/healthz")
        worked = work(ready["serving"]) if work is not None else None
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail("(e) the server process did not stop on SIGINT")
    if status != 200 or set(obj) != SERVE_RESULT_KEYS or status_h != 200 or rc != 0:
        with open(stderr_path, encoding="utf-8", errors="replace") as f:
            fail(f"(e) request status {status}, keys {sorted(obj)}, healthz {status_h}, "
                 f"exit {rc}:\n{f.read()[-4000:]}")
    return {"start_to_ready_s": ready_s, "first_request_s": first_request_s, "exit_code": rc,
            "healthz": json.loads(raw_h), "work": worked}


def _check_batches(engine, records: list, what: str, recompute=None) -> int:
    """Every record's served ids against `recompute(engine, record)`
    (default `_recomputed_ids`)."""
    for rec in records:
        if [r.result.get("ids") for r in rec["reqs"]] != (recompute or _recomputed_ids)(
                engine, rec):
            fail(f"{what}: served ids of batch {rec['counter']} differ from "
                 "transcribe_with_ids at the engine's counter")
    return len(records)


def _load_window(engine, base: str, bodies: list, durations, wrappers: dict,
                 dispatched: list, n_layers: int, traced: bool, recompute=None) -> dict:
    """One window of phase 16 (c): `bodies` uploaded by SERVE_CLIENTS
    closed-loop client threads; client latency, requests/s, `/stats` over
    the window alone, B1 launches (from 0 just before), peak memory, the
    batches at a shape not dispatched before, and every batch recomputed.
    `traced`: under torch.profiler (CUDA activity), whose device events'
    union over the window is the busy time."""
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(bodies)
    latencies, statuses = [None] * n, [None] * n

    def client(k):
        for i in range(k, n, SERVE_CLIENTS):
            t = time.time()
            status, raw = _http(base, "POST", "/v1/transcribe", bodies[i],
                                {"Content-Type": "audio/wav"})
            latencies[i] = (time.time() - t) * 1e3
            statuses[i] = (status, "error" in json.loads(raw))

    with engine.stats_lock:  # /stats over the window alone
        engine.stats["latencies_ms"].clear()
        engine.stats.update({k: 0 * v for k, v in engine.stats.items()
                             if k != "latencies_ms"})
    warm = set(engine._warm_shapes)
    n_before = len(dispatched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(wrappers)
    tracing = profile(activities=[ProfilerActivity.CUDA]) if traced else contextlib.nullcontext()
    with tracing as prof:
        t0 = time.time()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        window_s = time.time() - t0
        torch.cuda.synchronize()
    counts = _counts_since_reset(wrappers)
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    status, raw = _http(base, "GET", "/stats")
    stats = json.loads(raw)
    what = "(c) traced window" if traced else "(c) load"
    if status != 200 or any(s != (200, False) for s in statuses):
        fail(f"{what}: /stats status {status}, request statuses {statuses}")
    batches = stats["batches"]
    want = {k: 0 for k in wrappers}
    want["fwd"] = n_layers * batches
    if counts != want or batches != len(dispatched) - n_before:
        fail(f"{what}: launches {counts} over {batches} batches, expected {want}")
    lat = np.asarray(latencies)
    recs = dispatched[n_before:]
    cold = 0  # batches of a shape not dispatched before: they drain the pipeline first
    for rec in recs:
        cold += rec["shape"] not in warm
        warm.add(rec["shape"])
    out = {
        "requests": n, "clients": SERVE_CLIENTS, "traced": traced,
        "audio_s": float(np.sum(durations)), "window_s": window_s,
        "requests_per_s": n / window_s, "audio_s_per_s": float(np.sum(durations)) / window_s,
        "latency_ms": {"p50": float(np.percentile(lat, 50)),
                       "p95": float(np.percentile(lat, 95)),
                       "p99": float(np.percentile(lat, 99)), "max": float(lat.max())},
        "batches": batches, "batch_shapes": [r["shape"] for r in recs],
        "cold_shape_batches": cold, "stats": stats,
        "launches": {k: c for k, c in counts.items() if c},
        "launches_per_batch": counts["fwd"] / batches, "peak_mem_gb": peak_mem_gb,
        "batches_recomputed": _check_batches(engine, recs, what, recompute)}
    if traced:
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not spans:
            fail(f"{what}: the profiler saw no device event")
        busy_us, cover = 0.0, None
        for start, end in spans:
            if cover is None or start > cover[1]:
                busy_us += 0.0 if cover is None else cover[1] - cover[0]
                cover = [start, end]
            else:
                cover[1] = max(cover[1], end)
        busy_ms = (busy_us + cover[1] - cover[0]) / 1e3
        out.update({
            "device_busy_ms": busy_ms, "device_events": len(spans),
            "device_events_per_batch": len(spans) / batches,
            "idle_share": 1.0 - busy_ms / (window_s * 1e3),
            "busy_is": "union of the device events' intervals over the window "
                       "(torch.profiler, CUDA activity only, on during the window)"})
    return out


def _load_bodies(d: str) -> tuple:
    """(durations, WAV bodies) of (c)'s uploads: U(2, 20) s from SERVE_SEED."""
    rng = np.random.default_rng(SERVE_SEED)
    durations = rng.uniform(2.0, 20.0, SERVE_REQUESTS + SERVE_TRACED_REQUESTS)
    bodies = [_wav_bytes(os.path.join(d, "load.wav"),
                         synthetic_audio(1, float(s), seed=500 + i)[0])
              for i, s in enumerate(durations)]
    return durations, bodies


def _serve_load(engine, base: str, d: str, wrappers: dict, dispatched: list,
                n_layers: int) -> dict:
    """Phase 16 (c): every (Bp, T) bucket the load can give warmed first
    (`_warmup` at 2-20 s, so no batch of the windows is cold); SERVE_REQUESTS
    WAV uploads of U(2, 20) s (SERVE_SEED) untraced: requests/s, latency,
    `/stats`; then SERVE_TRACED_REQUESTS more under torch.profiler: busy
    time and idle share (and, beside the first window, what tracing costs);
    then one batch of 16 x 10 s dispatched from this thread with the engine
    idle, timed, and once under sync debug mode."""
    import warnings

    from fddm_asr_tpu_torch import serve as S

    durations, bodies = _load_bodies(d)
    buckets = list(range(2, 21))  # whole seconds: U(2, 20) s rounded up
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):  # it prints a line a call
        warmed = S._warmup(engine, ",".join(map(str, buckets)), 16)
    result = {"seed": SERVE_SEED,
              "bucket_warmup": {"seconds": buckets, "calls": len(warmed),
                                "wall_s": time.time() - t0,
                                "max_call_s": max(r["seconds"] for r in warmed)}}
    result.update(_load_window(engine, base, bodies[:SERVE_REQUESTS],
                               durations[:SERVE_REQUESTS], wrappers, dispatched, n_layers,
                               traced=False))
    result["traced_window"] = _load_window(
        engine, base, bodies[SERVE_REQUESTS:], durations[SERVE_REQUESTS:], wrappers,
        dispatched, n_layers, traced=True)

    # one batch dispatched from this thread with the engine idle, at a shape
    # dispatched before (a server's steady state): the host's time to queue
    # it and the wait for its results, medians of five; then once more
    # under sync debug mode, counting the syncs
    reqs = [r for i in range(16) for r in engine._plan_requests(
        synthetic_audio(1, 10.0, seed=600 + i)[0], f"sync{i}")]
    engine._dispatch(reqs)[0]()
    dispatch_ms, wait_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        fin, _host = engine._dispatch(reqs)
        t1 = time.time()
        fin()
        dispatch_ms.append((t1 - t0) * 1e3)
        wait_ms.append((time.time() - t1) * 1e3)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fin, _host = engine._dispatch(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    fin()
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    result["idle_dispatch"] = {
        "batch": [16, 160000], "dispatch_ms": statistics.median(dispatch_ms),
        "wait_ms": statistics.median(wait_ms), "dispatch_ms_runs": dispatch_ms,
        "syncs": len(syncs), "sync_messages": sorted(set(m[:160] for m in syncs))[:5]}
    return result


# ----------------------------------------------------------- the AOT artifacts
# phase 17: (a)'s bucket grid (two durations, so that the server picks
# among programs; a third, 5 s, took about 60 s more to export and load on
# an H100); phase 4's shape; the server's flags
EXPORT_BATCHES, EXPORT_SECONDS, EXPORT_SEQ_LEN = "1,2,4,8,16", "10,20", 128
EXPORTED_BUCKET = (8, 320000)
EXPORTED_SERVE_FLAGS = ["--max-batch", "16", "--max-wait-ms", "20", "--pipeline-depth", "2"]
ARTIFACT_BYTES_LIMIT = 1.2  # of the params' bytes: the weights once, the programs beside
EXPORTED_SEED = 17


def exported_batch(b: int, n: int, seed: int = 0) -> tuple:
    """pcm16 codes [b, n] of synthetic voiced audio, row i silent past its
    length (the first row full, the others U(n/2, n)), and the lengths."""
    rng = np.random.default_rng(seed * 7919 + b * 131 + n // 16000)
    lengths = rng.integers(n // 2, n + 1, b)
    lengths[0] = n
    wav = synthetic_audio(b, n / 16000.0, seed=int(rng.integers(1 << 30)))
    codes = np.clip(np.round(wav * 32768.0), -32768, 32767).astype(np.int16)
    for i, length in enumerate(lengths):
        codes[i, length:] = 0
    return codes, lengths.astype(np.int64)


def host_launches(fn) -> dict:
    """The CUDA runtime calls one call of `fn` makes from the host that
    queue device work (kernel and graph launches, copies, fills), by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        if e.name.startswith("cu") and any(k in e.name for k in ("Launch", "Memcpy", "Memset")):
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


def op_layer_host_us(calls: int = 200) -> dict:
    """Host microseconds a call of B1 at the transcribe's shape (B=8,
    L=1024, bf16) through its launcher (what eager paths call) and through
    its op `torch.ops.fddm.gated_attention` (what a program records), in
    turns; the launches queue behind one another, so this is the host's
    time, not the kernel's."""
    from fddm_asr_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, bias, gate, mask = attention_inputs(8, 1024, 16, torch.bfloat16, gen)
    fns = {"launcher": lambda: FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, 16),
           "op": lambda: torch.ops.fddm.gated_attention(q, k, v, bias, gate, mask, 16)}
    out = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {name: min(us) for name, us in out.items()}


def _replay_kernels(fn) -> dict:
    """Device kernels of one call of `fn` by torch.profiler: the port's
    three by name, and all device events.  CPU activity stays on: with CUDA
    activity alone, an H100 run recorded 3 of B8's 6 cluster launches in a
    replay and none in an eager call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"device_events": len(names),
            **{key: sum(kernel in x for x in names) for key, kernel in (
                ("fwd", "gated_attention_bf16_kernel"),
                ("int8_matmul_fused", "int8_matmul_fused_kernel"),
                ("conv_ln_gelu", "conv_ln_gelu_bf16_kernel"))}}


def graph_kernels(graph, path: str) -> dict:
    """The kernel nodes of a captured CUDA graph (kept by `keep_graph`) by
    the port's three kernel names, read from the graph's DOT dump at `path`
    (one line a kernel node, with its mangled name): what every replay
    launches, as the profiler need not record it."""
    graph.debug_dump(path)
    with open(path) as f:
        lines = f.readlines()
    return {key: sum(kernel in x for x in lines) for key, kernel in (
        ("fwd", "gated_attention_bf16_kernel"),
        ("int8_matmul_fused", "int8_matmul_fused_kernel"),
        ("conv_ln_gelu", "conv_ln_gelu_bf16_kernel"))}


def _export_start(args: list) -> tuple:
    """Start `python3 -m fddm_asr_tpu_torch.export_model *args` in a
    subprocess: (its start time, the process), for `_export_cli`."""
    root = os.path.dirname(os.path.abspath(__file__))
    return time.time(), subprocess.Popen(
        [sys.executable, "-m", "fddm_asr_tpu_torch.export_model", *args], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _export_cli(started: tuple, tag: str) -> dict:
    """Wait for an export `_export_start` began (killed if it outlasts 900
    s): its summary line, the process's seconds and the seconds a program."""
    t0, proc = started
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        _stop(proc)
    if proc.returncode != 0:
        fail(f"export ({tag}) exited {proc.returncode}:\n{stderr[-4000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    with open(os.path.join(summary["out"], "meta.json")) as f:
        meta = json.load(f)
    params = os.path.getsize(os.path.join(summary["out"], "params.npz"))
    out = {"process_s": time.time() - t0, "summary": summary,
           "export_s_per_program": meta["export_seconds"], "params_bytes": params,
           "program_bytes": {f: os.path.getsize(os.path.join(summary["out"], f))
                             for f in sorted(os.listdir(summary["out"])) if f.endswith(".pt2")},
           "artifact_over_params": summary["artifact_bytes"] / params}
    if not out["artifact_over_params"] < ARTIFACT_BYTES_LIMIT:
        fail(f"export ({tag}): the artifact holds {summary['artifact_bytes']} bytes, not under "
             f"{ARTIFACT_BYTES_LIMIT} x the params' {params}: a program holds weights")
    return out


def _stop(proc) -> None:
    """Kill a subprocess that is still running, and reap it."""
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def fused_export_args(d: str, model: list, base_cfg: str) -> list:
    """Phase 17 (d)'s export arguments: one bucket (8 x 20 s) under phase
    12's wavlm_config, whose config this writes into `d`."""
    fused_cfg = os.path.join(d, "fused.yaml")
    with open(fused_cfg, "w") as f:  # JSON is YAML
        json.dump({"base_config": base_cfg,
                   "model": {"encoder": {"wavlm_config": FUSED_WAVLM_CONFIG}}}, f)
    return [*model, "--main-config", fused_cfg, "--out", os.path.join(d, "artifact_fused"),
            "--batch-sizes", str(EXPORTED_BUCKET[0]), "--seconds",
            str(EXPORTED_BUCKET[1] // 16000), "--seq-len", str(EXPORT_SEQ_LEN), "--greedy",
            "--condition-mask", "on", "--input-encoding", "pcm16"]


def exported_int8_fused(d: str, export: dict, model: list, sampling: dict,
                        n_layers: int) -> dict:
    """Phase 17 (d): the artifact of one bucket (8 x 20 s) under phase 12's
    wavlm_config, exported by the CLI in a subprocess (`export`: its
    `_export_cli` result, `fused_export_args`): its ids against the
    live pipeline's, and B1, B7 and B8 in its CUDA graph: the graph's kernel
    nodes, the launches a replay counts and a replay under the profiler
    (each kernel's most over three windows), beside the eager call's.  The
    profiler can miss B8's cluster launches in a whole transcribe (an H100
    run recorded 0 of 6 in every window, replayed and eager alike, while it
    recorded B1 and B7 in full), so B8 is held by the graph's nodes and
    the profiler's count of it is printed beside them."""
    from fddm_asr_tpu_torch import aot
    from fddm_asr_tpu_torch import inference as cli

    wrappers = port_kernel_wrappers()
    fused_cfg = os.path.join(d, "fused.yaml")
    art2 = os.path.join(d, "artifact_fused")
    fused = {"export": export}
    t0 = time.time()
    ep2 = aot.ExportedPipeline.load(art2)
    fused["load_s"] = time.time() - t0
    live2 = cli.build_pipeline(cli.parse_args(["--wav", "-", *model, "--main-config",
                                               fused_cfg]))
    live2.use_condition_mask = True
    codes2, lengths2 = exported_batch(*EXPORTED_BUCKET, seed=5)
    fused["ids_equal_live"] = [r[1] for r in ep2.transcribe_with_ids(
        codes2, lengths2, seed=EXPORTED_SEED)] == [r[1] for r in live2.transcribe_with_ids(
            codes2, lengths2, seq_len=EXPORT_SEQ_LEN,
            generator=torch.Generator(device="cuda").manual_seed(EXPORTED_SEED), **sampling)]
    _reset(wrappers)
    ep2.transcribe_with_ids(codes2, lengths2, seed=1)
    torch.cuda.synchronize()
    fused["launches"] = _counts_since_reset(wrappers)
    # the profiler can leave kernels of a window unrecorded (phase 9): three
    # windows, each kernel's most; the eager call's once beside them
    windows = [_replay_kernels(lambda: ep2.transcribe_with_ids(codes2, lengths2, seed=1))
               for _ in range(3)]
    fused["profiled_replay"] = {k: max(w[k] for w in windows) for k in windows[0]}
    fused["profiled_replay_windows"] = windows
    fused["profiled_eager"] = _replay_kernels(lambda: live2.transcribe_with_ids(
        codes2, lengths2, seq_len=EXPORT_SEQ_LEN, **sampling))
    fused["graph_kernel_nodes"] = graph_kernels(ep2.native[EXPORTED_BUCKET].graph,
                                                os.path.join(d, "fused_graph.dot"))
    want = {"fwd": n_layers, "int8_matmul_fused": 6 * n_layers, "conv_ln_gelu": 6}
    profiled = ("fwd", "int8_matmul_fused")  # B8: by the graph's nodes (docstring)
    del ep2, live2
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"exported_d": fused}), flush=True)
    if not fused["ids_equal_live"]:
        fail("(d) the int8_fused artifact's ids differ from the live pipeline's")
    if ({k: fused["launches"][k] for k in want} != want
            or fused["graph_kernel_nodes"] != want
            or any(fused["profiled_replay"][k] != want[k] for k in profiled)):
        fail(f"(d) launches {fused['launches']}, graph nodes {fused['graph_kernel_nodes']}, "
             f"profiled {fused['profiled_replay_windows']} (eager {fused['profiled_eager']}), "
             f"expected {want}")
    return fused


def exported_full_width(d: str, card: str, served: dict) -> dict:
    """Phase 17: the AOT artifacts at full width, from phase 15's decoder
    `.pt`, random HF WavLM-large and tokenizer in `d`.  (a) export
    configs/fddm_zhTW_base.yaml in a subprocess (`python3 -m
    fddm_asr_tpu_torch.export_model`, 5 x 2 buckets, pcm16, condition mask
    on, greedy, seq_len 128), while (d)'s export runs beside it in a
    second subprocess (their process seconds overlap; both end before any
    measurement); (c) phase 4's shape through the graph (the
    artifact loaded in this process, by the server of (e)) beside the eager
    `transcribe_with_ids`; (d) a second artifact under phase 12's wavlm_config, one
    bucket, ids against the live pipeline, B1/B7/B8 in a profiled replay;
    (e) `serve --exported` under phase 16 (c)'s load, every batch
    recomputed by the live pipeline, beside phase 16's numbers, and its
    `/healthz`; (d) runs first, while (a)'s program is still traced."""
    import threading

    from fddm_asr_tpu_torch import aot
    from fddm_asr_tpu_torch import inference as cli
    from fddm_asr_tpu_torch import serve as S

    root = os.path.dirname(os.path.abspath(__file__))
    art = os.path.join(d, "artifact")
    model = ["--ckpt", os.path.join(d, "decoder.pt"),
             "--diffusion-config", os.path.join(root, "configs", "diffusion.yaml"),
             "--tokenizer", os.path.join(d, "spm_synth.vocab"),
             "--wavlm-ckpt", os.path.join(d, "wavlm-large")]
    base_cfg = os.path.join(root, CLI_MAIN_CONFIG)
    gc.collect()
    torch.cuda.empty_cache()  # the subprocesses need the memory this process has cached
    result = {"card": card}

    # (a) export, and (d)'s beside it: the tracing, most of phase 17, is host
    # work; (d)'s export ends first (one bucket), and (d) runs here while
    # (a)'s is still going
    started_d = _export_start(fused_export_args(d, model, base_cfg))
    started_a = _export_start(
        [*model, "--main-config", base_cfg, "--out", art, "--batch-sizes", EXPORT_BATCHES,
         "--seconds", EXPORT_SECONDS, "--seq-len", str(EXPORT_SEQ_LEN), "--greedy",
         "--condition-mask", "on", "--input-encoding", "pcm16"])
    try:
        fused_export = _export_cli(started_d, "d")
        with open(os.path.join(d, "artifact_fused", "meta.json")) as f:
            fused_sampling = json.load(f)["sampling"]
        result["int8_fused"] = exported_int8_fused(d, fused_export, model, fused_sampling,
                                                   WAVLM_LARGE_LAYERS)
        result["export"] = _export_cli(started_a, "a")
    finally:
        _stop(started_d[1])
        _stop(started_a[1])
    buckets = [tuple(bn) for bn in result["export"]["summary"]["buckets"]]
    print(json.dumps({"exported_a": result["export"]}), flush=True)

    live = cli.build_pipeline(cli.parse_args(["--wav", "-", *model, "--main-config", base_cfg]))
    live.use_condition_mask = True
    with open(os.path.join(art, "meta.json")) as f:
        sampling = json.load(f)["sampling"]

    def live_ids(pipe, codes, lengths, seed):
        return [row[1] for row in pipe.transcribe_with_ids(
            codes, lengths, seq_len=EXPORT_SEQ_LEN,
            generator=torch.Generator(device="cuda").manual_seed(seed), **sampling)]

    n_layers = live.encoder.config.num_hidden_layers

    # (c), (e): the server's artifact in this process; (c) through its pipeline first
    wrappers = port_kernel_wrappers()
    t0 = time.time()
    srv = S.build_server(S.parse_args(["--exported", art, "--port", "0",
                                       *EXPORTED_SERVE_FLAGS]))
    engine = srv.engine
    ep = engine.pipeline.ep
    result["server_build_s"] = time.time() - t0
    codes, lengths = exported_batch(*EXPORTED_BUCKET, seed=4)

    def graph():
        return ep.transcribe_with_ids(codes, lengths, seed=1)

    def eager():
        return live.transcribe_with_ids(
            codes, lengths, seq_len=EXPORT_SEQ_LEN,
            generator=torch.Generator(device="cuda").manual_seed(1), **sampling)

    if [r[1] for r in graph()] != [r[1] for r in eager()]:
        fail("(c) the graph's ids differ from the eager pipeline's at 8 x 20 s")
    _reset(wrappers)
    graph()
    torch.cuda.synchronize()
    counts = _counts_since_reset(wrappers)
    if counts["fwd"] != n_layers:
        fail(f"(c) one replay counted {counts}, expected B1 {n_layers}")
    audio_s = EXPORTED_BUCKET[0] * EXPORTED_BUCKET[1] / 16000.0
    phase4 = {}
    for name, fn in (("graph", graph), ("eager", eager)):
        walls = seconds_of(fn, REPEATS)
        wall = statistics.median(walls)
        breakdown = device_time_breakdown(fn, wall)
        launches = host_launches(fn)
        phase4[name] = {"wall_s": wall, "walls": walls, "rtfx": audio_s / wall,
                        "device_busy_ms": breakdown["device_busy_ms"],
                        "idle_share": breakdown["idle_share"],
                        "host_launches_per_call": sum(launches.values()),
                        "host_launches_by_call": launches}
    phase4["graph"]["launches"] = counts
    phase4["op_layer_host_us"] = op_layer_host_us()
    result["phase4_shape"] = phase4
    print(json.dumps({"exported_c": phase4}), flush=True)

    # (e) serve --exported under phase 16 (c)'s load
    def recompute(engine_, record):
        """A served batch by the live pipeline at the artifact's bucket:
        the engine's padded batch, padded again to the bucket with rows of
        one receptive field, its generator seeded at the engine's counter."""
        from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD

        reqs = record["reqs"]
        Bp, T = engine_._plan_shape(reqs)
        b, n = ep.pick_bucket(Bp, T)
        by_program[n] = by_program.get(n, 0) + 1
        batch = np.zeros((b, n), np.int16)
        lens = np.full((b,), CONV_RECEPTIVE_FIELD, np.int64)
        lens[:Bp] = min(1600, T)
        for i, r in enumerate(reqs):
            batch[i, :len(r.wave)] = r.wave
            lens[i] = max(len(r.wave), CONV_RECEPTIVE_FIELD)
        return live_ids(live, batch, lens, record["counter"])[:len(reqs)]

    by_program: dict = {}  # the recomputed batches of each program (samples)
    durations, bodies = _load_bodies(d)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):  # it prints a line a call
        warmed = S._warmup(engine, "5,10,15,20", 16)
    serving = {"flags": EXPORTED_SERVE_FLAGS, "warmup": {
        "calls": len(warmed), "wall_s": time.time() - t0,
        "max_call_s": max(r["seconds"] for r in warmed)}}
    dispatched = _record_dispatches(engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        serving.update(_load_window(engine, base, bodies[:SERVE_REQUESTS],
                                    durations[:SERVE_REQUESTS], wrappers, dispatched,
                                    n_layers, traced=False, recompute=recompute))
        serving["traced_window"] = _load_window(
            engine, base, bodies[SERVE_REQUESTS:], durations[SERVE_REQUESTS:], wrappers,
            dispatched, n_layers, traced=True, recompute=recompute)
        # a 6 s upload alone: the shorter program's bucket, its ids checked
        first = len(dispatched)
        status, raw = _http(base, "POST", "/v1/transcribe", _wav_bytes(
            os.path.join(d, "short.wav"), synthetic_audio(1, 6.0, seed=601)[0]),
            {"Content-Type": "audio/wav"})
        if status != 200:
            fail(f"(e) a 6 s upload: status {status}: {raw[:400]}")
        _check_batches(engine, dispatched[first:], "(e) a 6 s upload", recompute)
        # one batch of 16 x 10 s dispatched from this thread with the engine idle
        reqs = [r for i in range(16) for r in engine._plan_requests(
            synthetic_audio(1, 10.0, seed=600 + i)[0], f"idle{i}")]
        engine._dispatch(reqs)[0]()
        dispatch_ms, wait_ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            fin, _host = engine._dispatch(reqs)
            t1 = time.time()
            fin()
            dispatch_ms.append((t1 - t0) * 1e3)
            wait_ms.append((time.time() - t1) * 1e3)
        serving["idle_dispatch"] = {"batch": [16, 160000],
                                    "dispatch_ms": statistics.median(dispatch_ms),
                                    "wait_ms": statistics.median(wait_ms)}
        status_h, raw_h = _http(base, "GET", "/healthz")
        serving["healthz"] = json.loads(raw_h)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.shutdown()
    del srv, engine, ep, live
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("requests_per_s", "audio_s_per_s", "latency_ms", "batches", "cold_shape_batches",
            "peak_mem_gb")
    serving["phase16_same_process"] = {
        **{k: served["load"][k] for k in keys}, "stage_ms": served["load"]["stats"]["stage_ms"],
        "traced": {k: served["load"]["traced_window"][k] for k in (
            "requests_per_s", "device_busy_ms", "idle_share", "device_events_per_batch")},
        "idle_dispatch": served["load"]["idle_dispatch"]}
    if status_h != 200 or len(serving["healthz"].get("native_buckets", [])) != len(buckets):
        fail(f"(e) /healthz {status_h} names {serving['healthz'].get('native_buckets')} as "
             f"graphs, exported {buckets}")
    # the server picked among the programs: each served batches, each checked
    serving["batches_by_program"] = {str(n): k for n, k in sorted(by_program.items())}
    if sorted(by_program) != sorted({n for _, n in buckets}):
        fail(f"(e) the served batches ran the programs {serving['batches_by_program']}, "
             f"exported {sorted({n for _, n in buckets})}: the server did not pick among them")
    result["serve"] = serving
    print(json.dumps({"exported_e": serving}, ensure_ascii=False), flush=True)
    print(json.dumps({"exported": result}, ensure_ascii=False), flush=True)
    return result


# ------------------------------------------------------- phase 18: training
TRAIN_SPLITS = (("train", 64), ("validation", 16), ("test", 16))  # 20 s clips
TRAIN_A_BATCH, TRAIN_A_STEPS = 16, 4
# (b): examples/s from the step timer over steps 3-8 (the step-8 record of
# metrics.jsonl), then one L_fd period under the profiler, whose start and
# stop stay out of the timed steps (inside them, the timer's intervals
# would hold the profiler's start and stop)
TRAIN_B_STEPS, TRAIN_B_TIMED_TO, TRAIN_B_PROFILED = 12, 8, (9, 12)
TRAIN_C_CLIPS = 8


def train_corpus(d: str) -> dict:
    """Phase 18's data: 64 train, 16 validation and 16 test clips of 20 s
    from `synthetic_audio` (a seed a clip), written with the port's
    `save_wav`; each text 39-119 of the synthetic tokenizer's single-
    ideograph pieces, so `encode` gives 40-120 ids (the dummy-prefix U+2581
    is no piece and encodes as unk).  Manifests by split, and (b)'s train
    manifest listing the 64 clips six times: 12 steps of 32."""
    from fddm_asr_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(60)
    out, seed = {}, 300
    for split, n in TRAIN_SPLITS:
        records = []
        for i in range(n):
            path = os.path.join(d, f"{split}{i:02d}.wav")
            save_wav(path, synthetic_audio(1, 20.0, seed=seed)[0], 16000)
            seed += 1
            n_chars = int(rng.integers(39, 120))
            records.append({"processed_path": path, "text": "".join(
                chr(0x4E00 + int(j)) for j in rng.integers(0, 7996, n_chars))})
        out[split] = records
    paths = {}
    for name, records in (*out.items(), ("train_x6", out["train"] * 6)):
        paths[name] = os.path.join(d, f"{name}.json")
        with open(paths[name], "w", encoding="utf-8") as f:
            json.dump(records, f, ensure_ascii=False)
    return {"manifests": paths, "records": out}


def _train_config(path: str, base: str, overrides: dict) -> str:
    """A YAML config (written as JSON, which YAML reads) over one of the
    repo's configs through `base_config:`."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"base_config": base, **overrides}, f, ensure_ascii=False)
    return path


def _metrics(ckpt_dir: str) -> list:
    with open(os.path.join(ckpt_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _train_process(args: list, root: str, tag: str) -> tuple:
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "fddm_asr_tpu_torch.train", *args], cwd=root,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"(a) {tag}: the training process exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    return proc, time.time() - t0


def _files(records: list, name: str) -> dict:
    return {f: v for r in records if r["kind"] == "checkpoint" and r["name"] == name
            for f, v in r["files"].items()}


def train_full_width(d: str, card: str, phase7: dict) -> dict:
    """Phase 18: the training entry point at full width (module docstring).
    `d` holds phase 15's tokenizer and HF WavLM-large; `phase7` is the bare
    fine-tune step's line of this process."""
    from torch.profiler import ProfilerActivity, profile

    from fddm_asr_tpu_torch import eval as E
    from fddm_asr_tpu_torch import inference as cli
    from fddm_asr_tpu_torch import train as train_cli
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.data.dataset import ManifestDataset
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    vocab = os.path.join(d, "spm_synth.vocab")
    t0 = time.time()
    corpus = train_corpus(d)
    manifests = corpus["manifests"]
    result = {"card": card, "corpus_write_s": time.time() - t0}
    tok = load_tokenizer(vocab)
    lengths = [len(tok.encode(r["text"])) for r in corpus["records"]["train"]]
    if not 40 <= min(lengths) <= max(lengths) <= 120:
        fail(f"phase 18's texts encode to {min(lengths)}-{max(lengths)} ids, expected 40-120")
    # the loader's own encode time for one batch of (b), in this process
    texts = [r["text"] for r in corpus["records"]["train"][:FINETUNE_B]]
    ds = ManifestDataset(manifests["train"], tok, max_len=FINETUNE_TOKENS, pad_id=3)
    t0 = time.perf_counter()
    for text in texts:
        ds.tokenize(text)
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(FINETUNE_B):
        ds[i]
    item_ms = (time.perf_counter() - t0) * 1e3
    result["loader"] = {"encode_ms_per_batch_of_32": encode_ms,
                        "read_and_encode_ms_per_batch_of_32_one_thread": item_ms,
                        "ids_per_text": [min(lengths), max(lengths)]}
    data = {"train_json": manifests["train"], "val_json": manifests["validation"],
            "test_json": manifests["test"], "tokenizer_path": vocab}
    gc.collect()
    torch.cuda.empty_cache()  # the subprocesses need the memory this process has cached

    # (a) frozen decoder training on the feature cache, then a resume
    a_dir = os.path.join(d, "ckpt_a")
    a_log = {"log_every": 1, "metrics_jsonl": True, "val_kl": "sampled", "ckpt_dir": a_dir}
    base = os.path.join(root, "configs", "fddm_zhTW_base.yaml")
    common = {"data": {**data, "cache_features": os.path.join(d, "feats")}, "log": a_log}
    cfg_a = _train_config(os.path.join(d, "a.yaml"), base, {
        **common, "optim": {"batch_size": TRAIN_A_BATCH, "num_epochs": 1}})
    steps = ["--max-steps-per-epoch", str(TRAIN_A_STEPS)]
    _, a_s = _train_process(["--config", cfg_a, *steps], root, "first run")
    first = _metrics(a_dir)
    cfg_r = _train_config(os.path.join(d, "a_resume.yaml"), base, {
        **common, "optim": {"batch_size": TRAIN_A_BATCH, "num_epochs": 2}})
    proc, r_s = _train_process(["--config", cfg_r, *steps, "--resume",
                                os.path.join(a_dir, "ep001.state.pt")], root, "resume")
    resumed = _metrics(a_dir)[len(first):]
    cache = [r for r in first if r["kind"] == "feature_cache"]
    a_steps = [r for r in first if r["kind"] == "step"]
    r_steps = [r for r in resumed if r["kind"] == "step"]
    epoch1 = [r for r in first if r["kind"] == "epoch"][0]
    epoch2 = [r for r in resumed if r["kind"] == "epoch"]
    best = f"best_val_cer so far {epoch1['best_val_cer']:.4f}"
    if len(cache) != 1 or not cache[0]["built"] or not cache[0]["device_resident"]:
        fail(f"(a) the feature cache was not built and device-resident: {cache}")
    if [r["step"] for r in a_steps] != list(range(1, TRAIN_A_STEPS + 1)):
        fail(f"(a) ran steps {[r['step'] for r in a_steps]}")
    if ([r["step"] for r in r_steps] != list(range(TRAIN_A_STEPS + 1, 2 * TRAIN_A_STEPS + 1))
            or {r["epoch"] for r in r_steps} != {2} or len(epoch2) != 1
            or "Resumed from" not in proc.stderr or "at epoch 2" not in proc.stderr
            or best not in proc.stderr):
        fail(f"(a) the resume did not start at epoch 2, step {TRAIN_A_STEPS + 1} with "
             f"{best}: steps {[(r['epoch'], r['step']) for r in r_steps]}")
    if any(r["kind"] == "feature_cache" and r["built"] for r in resumed):
        fail("(a) the resumed run rebuilt the feature cache")
    if not all(np.isfinite(r["total_loss"]) for r in a_steps + r_steps):
        fail("(a) a training loss is not finite")
    eps = [r["examples_per_s"] for r in a_steps + r_steps if "examples_per_s" in r]
    result["a"] = {
        "process_s": a_s, "resume_process_s": r_s,
        "feature_cache": {k: cache[0][k] for k in ("seconds", "bytes", "shape",
                                                   "device_resident", "upload_seconds")},
        "examples_per_s": eps, "steps_per_s": [e / TRAIN_A_BATCH for e in eps],
        "eval_s": [r["seconds"] for r in first + resumed if r["kind"] == "eval"],
        "checkpoints": {n: _files(first + resumed, n) for n in ("ep001", "best_model", "ep002")},
        "losses": [r["total_loss"] for r in a_steps + r_steps],
        "val_cer": [epoch1["val_cer"], epoch2[0]["val_cer"]],
        "best_val_cer": [epoch1["best_val_cer"], epoch2[0]["best_val_cer"]]}
    print(json.dumps({"train_a": result["a"]}), flush=True)

    # (b) fine-tuning at 32 x 20 s in this process through train.main
    b_dir = os.path.join(d, "ckpt_b")
    cfg_b = _train_config(os.path.join(d, "b.yaml"),
                          os.path.join(root, "configs", "fddm_zhTW_finetune.yaml"), {
        "data": {**data, "train_json": manifests["train_x6"]},
        "optim": {"num_epochs": 1},
        "log": {"log_every": 4, "metrics_jsonl": True, "ckpt_dir": b_dir}})
    wrappers = port_kernel_wrappers()
    per_step, lfd, window, evals, host_lead = [], [], {}, [], []
    make_step, setup_logging = TL.make_train_step, TL.setup_logging
    evaluators = {n: getattr(E, n) for n in ("evaluate_cer_with_jumpy_sampling",
                                              "evaluate_validation_loss",
                                              "evaluate_validation_kl_sampled")}

    def counted_step(*a, **k):
        step = make_step(*a, **k)

        def run(*args, **kw):
            i = len(per_step) + 1
            if i == 1:  # the full fine-tune's optimizer and EMA, for phase 19
                window["state_bytes"] = state_bytes(args[0])
            if i == TRAIN_B_PROFILED[0]:  # from the end of step 8's record to step 12's end
                torch.cuda.synchronize()
                window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA])
                window["prof"].__enter__()
                window["t0"] = time.time()
            before = {n: w.launches for n, w in wrappers.items()}
            metrics = step(*args, **kw)
            per_step.append({n: w.launches - before[n] for n, w in wrappers.items()})
            lfd.append("loss_fd" in metrics)
            if i == TRAIN_B_PROFILED[1]:
                torch.cuda.synchronize()
                window["ms"] = (time.time() - window["t0"]) * 1e3
                window["prof"].__exit__(None, None, None)
            return metrics

        run.forward = step.forward
        return run

    def counted_eval(name):
        def run(pipeline, batches, *a, **k):
            before = wrappers["fwd"].launches
            t0 = time.time()
            value = evaluators[name](pipeline, batches, *a, **k)
            torch.cuda.synchronize()
            evals.append({"evaluator": name, "batches": len(batches), "value": value,
                          "seconds": time.time() - t0,
                          "fwd": wrappers["fwd"].launches - before})
            return value
        return run

    class LeadLog(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "host_lead_ms=" in msg:
                host_lead.append(float(msg.split("host_lead_ms=")[1].split()[0]))

    def logging_with_probe(*a, **k):
        out = setup_logging(*a, **k)
        logging.getLogger().addHandler(LeadLog())
        window["log_file"] = out  # phase 23's convergence_report reads it
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset(wrappers)
    TL.make_train_step, TL.setup_logging = counted_step, logging_with_probe
    for n in evaluators:
        setattr(E, n, counted_eval(n))
    t0 = time.time()
    try:
        summary = train_cli.main(["--config", cfg_b, "--wavlm-ckpt", os.path.join(d, "wavlm-large"),
                                  "--max-steps-per-epoch", str(TRAIN_B_STEPS)])
        torch.cuda.synchronize()
    finally:
        TL.make_train_step, TL.setup_logging = make_step, setup_logging
        for n, f in evaluators.items():
            setattr(E, n, f)
        logging.getLogger().handlers.clear()
    b_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = _counts_since_reset(wrappers)
    records = _metrics(b_dir)
    want = phase7["kernel_launches_per_step"]
    if len(per_step) != TRAIN_B_STEPS or any(
            {k: c[k] for k in want} != want or any(c[k] for k in c if k not in want)
            for c in per_step):
        fail(f"(b) kernel launches per step {per_step}, expected phase 7's {want}")
    lfd_steps = [i + 1 for i, x in enumerate(lfd) if x]
    if lfd_steps != [4, 8, 12]:
        fail(f"(b) L_fd ran on steps {lfd_steps}, expected [4, 8, 12]")
    n_layers = want["bwd_dq"]
    if not evals or any(e["fwd"] != n_layers * e["batches"] for e in evals):
        fail(f"(b) B1 launches per eval decode batch {evals}, expected {n_layers}")
    if not all(launches[k] for k in ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv")):
        fail(f"(b) a kernel of the training path never launched: {launches}")
    steps_b = [r for r in records if r["kind"] == "step"]
    if not all(np.isfinite(r["total_loss"]) for r in steps_b) or not np.isfinite(
            summary["train_loss"]):
        fail(f"(b) a training loss is not finite: {steps_b}")
    names = set(os.listdir(b_dir))
    for prefix in ("ep001", "best_model"):
        missing = {f"{prefix}{x}" for x in (".pt", ".state.pt", ".encoder.pt", ".meta.json")} - names
        if missing:
            fail(f"(b) missing checkpoint files {sorted(missing)}")
    breakdown = profile_breakdown(window["prof"], window["ms"], window["ms"],
                                  ranges=("host_to_device",))
    h2d = breakdown.pop("ranges")["host_to_device"]
    del breakdown["all"]
    timed = [r for r in steps_b if r["step"] == TRAIN_B_TIMED_TO]
    if not timed or "examples_per_s" not in timed[0]:
        fail(f"(b) metrics.jsonl has no examples_per_s at step {TRAIN_B_TIMED_TO}: {steps_b}")
    eps = timed[0]["examples_per_s"]
    result["b"] = {
        "process_s": b_s, "peak_mem_gb": peak_gb, "steps": TRAIN_B_STEPS,
        "state_bytes": window["state_bytes"],
        "examples_per_s_steps_3_to_8": eps, "phase7_examples_per_s": phase7["examples_per_s"],
        "loop_over_bare_step": eps / phase7["examples_per_s"],
        "kernel_launches_per_step": per_step[0], "lfd_steps": lfd_steps,
        "eval": evals, "eval_s": [r["seconds"] for r in records if r["kind"] == "eval"],
        "steps_9_to_12_profiled": {"wall_ms": window["ms"],
                                  "device_busy_ms": breakdown["device_busy_ms"],
                                  "idle_share": breakdown["idle_share"],
                                  "host_to_device": h2d, "top": breakdown["top"][:6]},
        # at the logged steps 4 and 8 (step 12's ends in the profiler's synchronize)
        "host_lead_ms": host_lead[:2],
        "checkpoints": {n: _files(records, n) for n in ("ep001", "best_model")},
        "losses": [r["total_loss"] for r in steps_b], "launches": launches,
        "log_file": window["log_file"], "config": cfg_b, "ckpt_dir": b_dir}
    print(json.dumps({"train_b": result["b"]}), flush=True)

    # (c) the inference CLI from (b)'s best model beside the in-process
    # pipeline built from the EMA weights in best_model.state.pt
    csv_path = os.path.join(d, "val8.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write("path,text\n" + "".join(f"{r['processed_path']},{r['text']}\n" for r in
                                        corpus["records"]["validation"][:TRAIN_C_CLIPS]))
    args = ["--csv", csv_path, "--ckpt", os.path.join(b_dir, "best_model.pt"),
            "--encoder-ckpt", os.path.join(b_dir, "best_model.encoder.pt"),
            "--main-config", cfg_b,
            "--diffusion-config", os.path.join(root, "configs", "diffusion.yaml"),
            "--tokenizer", vocab, "--batch-size", str(TRAIN_C_CLIPS), "--greedy",
            "--seq-len", str(FINETUNE_TOKENS)]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "fddm_asr_tpu_torch.inference", *args],
                          cwd=root, capture_output=True, text=True, timeout=600)
    c_s = time.time() - t0
    if proc.returncode != 0:
        fail(f"(c) the inference CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    rows = [x for x in _cli_output(proc.stdout) if "ids" in x]
    printed = [x["ids"] for x in rows]
    run_args = cli.parse_args(args)
    pipe = cli.build_pipeline(run_args)
    state = TL.init_train_state(pipe, pipe.cfg)  # for the names of the EMA's tensors
    blob = torch.load(os.path.join(b_dir, "best_model.state.pt"), map_location="cpu",
                      weights_only=True)
    with torch.no_grad():
        pipe.encoder.load_state_dict(blob["modules"]["encoder"])
        pipe.decoder.load_state_dict(blob["modules"]["decoder"])
        modules = {"decoder": pipe.decoder, "encoder": pipe.encoder}
        params = {k: dict(m.named_parameters()) for k, m in modules.items()}
        for (key, name), e in zip(state.param_names(), blob["ema"]):
            if key in params:
                params[key][name].copy_(e)
    del state, blob
    ids = [x["ids"] for x in cli.transcribe(pipe, run_args)]
    del pipe
    result["c"] = {"process_s": c_s, "rows": len(printed), "ids_equal_in_process": ids == printed}
    print(json.dumps({"train_c": result["c"]}), flush=True)
    if len(printed) != TRAIN_C_CLIPS or ids != printed:
        fail(f"(c) the CLI's ids ({len(printed)} rows) differ from the in-process pipeline's "
             "built from best_model.state.pt's EMA")
    print(json.dumps({"train": {"card": card, "corpus_write_s": result["corpus_write_s"],
                                "loader": result["loader"]}}), flush=True)
    result["corpus"], result["data"] = corpus, data
    result["cli_c"] = {"args": args, "rows": rows}  # phase 20 (b3) runs them under a mesh
    return result


def state_bytes(state) -> dict:
    """The bytes a TrainState keeps beside the model: trained parameters (or
    adapters), AdamW's two moments, the accumulated gradients, the EMA."""
    opt = state.optimizer

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors or [])

    return {"trained_params": nbytes(opt.params), "adam_mu": nbytes(opt.mu),
            "adam_nu": nbytes(opt.nu), "accumulated_grads": nbytes(opt.acc),
            "ema": nbytes(state.ema),
            "optimizer_and_ema": nbytes(opt.mu) + nbytes(opt.nu) + nbytes(opt.acc)
            + nbytes(state.ema)}


# ------------------------------------------------ phase 19: the training recipe
# (a): LoRA r = 8, alpha 16, grad_accum_steps 2, bf16 mu and EMA, async
# checkpoints; phase 18 (b)'s 12 steps of 32 x 20 s as micro-steps (6
# updates), timed over 3-8 and profiled over 9-12 as phase 18 (b) is, so
# the two loops compare window for window
RECIPE_RANK, RECIPE_ALPHA = 8, 16


def train_recipe_full_width(d: str, card: str, phase7: dict, phase18: dict) -> dict:
    """Phase 19 (module docstring): (a) the LoRA recipe through `train.main`,
    (b) its adapter checkpoint through the inference CLI beside a pipeline
    with the EMA adapters merged by hand, (c) one full-width step of phase
    7's config under remat_policy full and dots, and one step of phase 6's
    small model with attention_dropout 0.1."""
    from torch.profiler import ProfilerActivity, profile

    from fddm_asr_tpu_torch import inference as cli
    from fddm_asr_tpu_torch import train as train_cli
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.models import lora as LO

    t_phase = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    vocab = os.path.join(d, "spm_synth.vocab")
    manifests = phase18["corpus"]["manifests"]
    wrappers = port_kernel_wrappers()
    result = {"card": card}

    # (a) the LoRA recipe in this process
    r_dir = os.path.join(d, "ckpt_recipe")
    cfg_path = _train_config(os.path.join(d, "recipe.yaml"),
                             os.path.join(root, "configs", "fddm_zhTW_finetune.yaml"), {
        "data": {**phase18["data"], "train_json": manifests["train_x6"]},
        "model": {"encoder": {"lora_rank": RECIPE_RANK, "lora_alpha": RECIPE_ALPHA}},
        "optim": {"num_epochs": 1, "grad_accum_steps": 2, "adam_mu_dtype": "bfloat16",
                  "ema_dtype": "bfloat16"},
        "log": {"log_every": 4, "metrics_jsonl": True, "ckpt_dir": r_dir,
                "async_checkpoint": True}})
    per_step, seen, window = [], {}, {}
    make_step = TL.make_train_step

    def counted_step(*a, **k):
        step = make_step(*a, **k)

        def run(*args, **kw):
            i = len(per_step) + 1
            if i == TRAIN_B_PROFILED[0]:  # after micro-step 8's record, as phase 18 (b)
                torch.cuda.synchronize()
                window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA])
                window["prof"].__enter__()
                window["t0"] = time.time()
            if not per_step:
                state = args[0]
                seen["state_bytes"] = state_bytes(state)
                seen["adapters"] = LO.lora_param_count(state.lora)
                seen["expected"] = sum(
                    RECIPE_RANK * (lin.in_features + lin.out_features)
                    for _, lin in LO.targeted_linears(a[0].encoder))
                seen["adapted_layers"] = len(state.lora)
            before = {n: w.launches for n, w in wrappers.items()}
            metrics = step(*args, **kw)
            per_step.append({n: w.launches - before[n] for n, w in wrappers.items()})
            if i == TRAIN_B_PROFILED[1]:
                torch.cuda.synchronize()
                window["ms"] = (time.time() - window["t0"]) * 1e3
                window["prof"].__exit__(None, None, None)
            return metrics

        run.forward, run.merged = step.forward, step.merged
        return run

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset(wrappers)
    TL.make_train_step = counted_step
    t0 = time.time()
    try:
        summary = train_cli.main(["--config", cfg_path,
                                  "--wavlm-ckpt", os.path.join(d, "wavlm-large"),
                                  "--max-steps-per-epoch", str(TRAIN_B_STEPS)])
        torch.cuda.synchronize()
    finally:
        TL.make_train_step = make_step
        logging.getLogger().handlers.clear()
    a_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = _counts_since_reset(wrappers)
    records = _metrics(r_dir)
    want = phase7["kernel_launches_per_step"]
    if len(per_step) != TRAIN_B_STEPS or any(
            {k: c[k] for k in want} != want or any(c[k] for k in c if k not in want)
            for c in per_step):
        fail(f"19 (a) kernel launches per micro-step {per_step}, expected phase 7's {want}")
    if seen["adapters"] != seen["expected"]:
        fail(f"19 (a) {seen['adapters']} adapter parameters, init_lora's shapes give "
             f"{seen['expected']}")
    steps = [r for r in records if r["kind"] == "step"]
    if not all(np.isfinite(r["total_loss"]) for r in steps) or not np.isfinite(
            summary["train_loss"]):
        fail(f"19 (a) a training loss is not finite: {steps}")
    saves = [r for r in records if r["kind"] == "checkpoint"]
    if [r["name"] for r in saves] != ["best_model", "ep001"] or not all(
            r["asynchronous"] for r in saves):
        fail(f"19 (a) the asynchronous checkpoints: {saves}")
    adapters = torch.load(os.path.join(r_dir, "best_model.encoder.pt"), weights_only=True)
    with open(os.path.join(r_dir, "best_model.meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    if not LO.is_adapter_dict(adapters) or meta.get("lora_rank") != RECIPE_RANK or meta.get(
            "lora_alpha") != float(RECIPE_ALPHA):
        fail(f"19 (a) best_model.encoder.pt is not the adapters, or the sidecar lacks "
             f"rank / alpha: {meta}")
    timed = [r for r in steps if r["step"] == TRAIN_B_TIMED_TO and "examples_per_s" in r]
    breakdown = profile_breakdown(window["prof"], window["ms"], window["ms"],
                                  ranges=("host_to_device",))
    h2d = breakdown.pop("ranges")["host_to_device"]
    del breakdown["all"]
    result["a"] = {
        "process_s": a_s, "micro_steps": TRAIN_B_STEPS, "grad_accum_steps": 2,
        "batch": FINETUNE_B, "peak_mem_gb": peak_gb,
        "full_finetune_peak_mem_gb": phase18["b"]["peak_mem_gb"],
        "state_bytes": seen["state_bytes"],
        "full_finetune_state_bytes": phase18["b"]["state_bytes"],
        "adapter_params": seen["adapters"], "adapted_layers": seen["adapted_layers"],
        "examples_per_s_steps_3_to_8": timed[0]["examples_per_s"] if timed else None,
        "full_finetune_examples_per_s_steps_3_to_8":
            phase18["b"]["examples_per_s_steps_3_to_8"],
        "micro_steps_9_to_12_profiled": {"wall_ms": window["ms"],
                                         "device_busy_ms": breakdown["device_busy_ms"],
                                         "idle_share": breakdown["idle_share"],
                                         "host_to_device": h2d, "top": breakdown["top"][:6]},
        "full_finetune_steps_9_to_12_profiled": phase18["b"]["steps_9_to_12_profiled"],
        "kernel_launches_per_micro_step": per_step[0], "launches": launches,
        "checkpoints": [{"name": r["name"], "blocked_seconds": r["blocked_seconds"],
                         "files": r["files"]} for r in saves],
        "full_finetune_checkpoints": phase18["b"]["checkpoints"],
        "losses": [r["total_loss"] for r in steps]}
    print(json.dumps({"train_recipe_a": result["a"]}), flush=True)

    # (b) the adapter checkpoint through the CLI, beside the EMA adapters
    # of best_model.state.pt merged by hand into the --wavlm-ckpt encoder
    csv_path = os.path.join(d, "val8.csv")
    out_json = os.path.join(d, "recipe_cli.json")
    base_args = ["--csv", csv_path, "--ckpt", os.path.join(r_dir, "best_model.pt"),
                 "--wavlm-ckpt", os.path.join(d, "wavlm-large"), "--main-config", cfg_path,
                 "--diffusion-config", os.path.join(root, "configs", "diffusion.yaml"),
                 "--tokenizer", vocab, "--batch-size", str(TRAIN_C_CLIPS), "--greedy",
                 "--seq-len", str(FINETUNE_TOKENS)]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(base_args + ["--encoder-ckpt", os.path.join(r_dir, "best_model.encoder.pt"),
                              "--out-json", out_json])
    b_s = time.time() - t0
    with open(out_json, encoding="utf-8") as f:
        cli_ids = [r["ids"] for r in json.load(f)]
    run_args = cli.parse_args(base_args)
    pipe = cli.build_pipeline(run_args)
    blob = torch.load(os.path.join(r_dir, "best_model.state.pt"), map_location="cpu",
                      weights_only=True)
    names = [(n, ab) for n, ad in blob["lora"].items() for ab in ad]
    ema = dict(zip(names, blob["ema"][-len(names):]))
    modules = dict(pipe.encoder.named_modules())
    scale = RECIPE_ALPHA / RECIPE_RANK
    with torch.no_grad():
        for n in blob["lora"]:
            a, b = (ema[(n, ab)].float().cuda() for ab in ("a", "b"))
            modules[n].weight += scale * (a @ b).t()
    del blob
    hand_ids = [x["ids"] for x in cli.transcribe(pipe, run_args)]
    del pipe
    result["b"] = {"cli_s": b_s, "rows": len(cli_ids), "ids_equal_hand_merged": cli_ids == hand_ids}
    print(json.dumps({"train_recipe_b": result["b"]}), flush=True)
    if len(cli_ids) != TRAIN_C_CLIPS or cli_ids != hand_ids:
        fail("19 (b) the CLI's ids from the adapter checkpoint differ from a pipeline with "
             "the EMA adapters merged by hand")

    # (c) phase 7's step under remat_policy full and dots; phase 6's small
    # model with attention dropout
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = finetune_config(synthetic_tokenizer(d, 8000))
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path))
    state = TL.init_train_state(pipe, cfg, generator=torch.Generator(device="cuda").manual_seed(7))
    step = TL.make_train_step(pipe, cfg, train_encoder=True)
    wav = synthetic_audio(FINETUNE_B, FINETUNE_SECONDS, seed=5)
    x0 = np.random.default_rng(6).integers(4, 8000, (FINETUNE_B, FINETUNE_TOKENS))
    gen = torch.Generator(device="cuda").manual_seed(8)
    encoder_module = pipe.encoder.backbone.encoder
    remat = {}
    for policy in ("full", "dots"):  # the layers read the policy from their Encoder's config
        encoder_module.cfg = dataclasses.replace(encoder_module.cfg, remat_policy=policy)
        step(state, wav, x0, False, generator=gen)  # warm: the allocator grows to this policy
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        _reset(wrappers)
        t0 = time.time()
        m = step(state, wav, x0, False, generator=gen)
        torch.cuda.synchronize()
        remat[policy] = {"step_s": time.time() - t0,
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                         "launches": _counts_since_reset(wrappers),
                         "loss": float(m["total_loss"])}
        if {k: remat[policy]["launches"][k] for k in want} != want or not np.isfinite(
                remat[policy]["loss"]):
            fail(f"19 (c) remat_policy {policy}: {remat[policy]}, expected phase 7's {want}")
    del pipe, state, step
    gc.collect()
    torch.cuda.empty_cache()
    small_dir = os.path.join(d, "small")  # phase 18's 8000-piece tokenizer stays in d
    os.makedirs(small_dir, exist_ok=True)
    small = finetune_config(synthetic_tokenizer(small_dir, 64), small=True).to_dict()
    small["model"]["encoder"]["wavlm_config"]["attention_dropout"] = 0.1
    small = type(cfg)(small)
    pipe = FDDMPipeline.from_config(small, tokenizer=load_tokenizer(small.data.tokenizer_path))
    state = TL.init_train_state(pipe, small, generator=torch.Generator(device="cuda").manual_seed(5))
    step = TL.make_train_step(pipe, small, train_encoder=True)
    _reset(wrappers)
    m = step(state, synthetic_audio(3, 1.0, seed=3), np.random.default_rng(4).integers(4, 64, (3, 16)),
             True, generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    dropout = {"loss": float(m["total_loss"]), "launches": _counts_since_reset(wrappers)}
    del pipe, state, step
    if not np.isfinite(dropout["loss"]) or any(dropout["launches"].values()):
        fail(f"19 (c) attention dropout: {dropout} (a finite loss, no kernel launch)")
    result["c"] = {"remat": remat, "dots_over_full_step": remat["dots"]["step_s"]
                   / remat["full"]["step_s"],
                   "attention_dropout_small_step": dropout}
    result["seconds"] = time.time() - t_phase
    print(json.dumps({"train_recipe_c": result["c"]}), flush=True)
    print(json.dumps({"train_recipe": {"card": card, "seconds": result["seconds"]}}), flush=True)
    return result


# ---------------------------------------------------- phase 20: several GPUs
# (b1): the fine-tune's global batch, 4 x 20 s a rank on data=2, its steps
# and where each takes L_fd; float32, so that rtol 1e-5 on the loss reads
# the reduction and not bfloat16 rounding in GEMMs of other row counts
PARALLEL_B, PARALLEL_STEPS, PARALLEL_LFD = 8, 3, (True, False, True)
PARALLEL_LOSS_RTOL = 1e-5
# (b2): the ring at ring 2, B = 2 utterances of 5120 frames (102.4 s, the
# kernel's side past 4096 frames), the second 4999 frames long
RING_B, RING_L = 2, 5120
RING_FWD_TOL, RING_GRAD_REL_TOL = 2e-5, 1e-4
RING_SEQ_LEN = 128
# (b3): the training entry point under torchrun, frozen, 2 steps of 16
PARALLEL_TRAIN_B, PARALLEL_TRAIN_STEPS = 16, 2
# the tensors whose gradients and updated values (b1) compares across processes
PARALLEL_WATCHED = ("encoder.layers.12.attention.q_proj.weight",
                    "encoder.layers.0.attention.rel_attn_embed.weight", "masked_spec_embed",
                    "decoder.blocks.0.ff.0.weight")


def parallel_config(tokenizer_path: str):
    """Phase 7's fine-tune configuration in float32 with every dropout off
    (dropout draws per rank), at (b1)'s global batch."""
    from fddm_asr_tpu_torch.config import Config

    cfg = finetune_config(tokenizer_path).to_dict()
    cfg["model"].update({"dtype": "float32", "dropout": 0.0})
    # no warmup: the first update moves the parameters (lr 0 would leave them)
    cfg["optim"].update({"dtype": "float32", "batch_size": PARALLEL_B, "warmup_steps": 0})
    return Config(cfg)


def parallel_batch():
    """(b1)'s global batch: waves [8, 20 s] and tokens [8, 128] with pad tails."""
    wav = synthetic_audio(PARALLEL_B, FINETUNE_SECONDS, seed=55)
    rng = np.random.default_rng(56)
    x0 = rng.integers(4, 8000, (PARALLEL_B, FINETUNE_TOKENS))
    for b, n in enumerate(rng.integers(FINETUNE_TOKENS // 4, FINETUNE_TOKENS + 1, PARALLEL_B)):
        x0[b, n:] = 0
    return wav, x0


def parallel_steps(FA, cfg, mesh, tensor: bool = False, lfd=PARALLEL_LFD) -> dict:
    """(b1)'s work on this process's rows of the global batch (all of them
    without a data axis): a step for each of `lfd`, each one's metrics,
    time and kernel launches; the first step's gradients (as its optimizer
    got them, reduced over the mesh) of the watched tensors and the watched
    tensors after it; the peak memory.  `tensor`: phase 21 (b), the weights
    split over the mesh's "model" ranks, the watched tensors gathered whole."""
    import torch.distributed as dist

    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.parallel import tensor as T
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    t0 = time.time()
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path),
                                    device=str(torch.device("cuda", torch.cuda.current_device())))
    if tensor:
        pipe.enable_tensor_parallel(mesh)
    state = TL.init_train_state(pipe, cfg, generator=torch.Generator(device="cuda").manual_seed(7),
                                mesh=mesh)
    step = TL.make_train_step(pipe, cfg, train_encoder=True, mesh=mesh)
    build_s = time.time() - t0
    wav, x0 = parallel_batch()
    D = mesh.shape["data"] if mesh is not None else 1
    r = mesh.data_rank if mesh is not None else 0
    b = PARALLEL_B // D
    wav, x0 = wav[r * b:(r + 1) * b], x0[r * b:(r + 1) * b]
    params = dict(pipe.encoder.backbone.named_parameters())
    params.update({f"decoder.{n}": p for n, p in pipe.decoder.named_parameters()})
    watched = {n: params[n] for n in PARALLEL_WATCHED}
    axes = {n: ax for n, ax in T.sharded_axes(pipe.encoder.backbone).items()}
    axes.update({f"decoder.{n}": ax for n, ax in T.sharded_axes(pipe.decoder).items()})

    def whole(name, t):
        """A watched tensor (or its gradient) whole: gathered over "model"."""
        if name in axes:
            t = T.gather_tensor(t.detach().contiguous(), axes[name][0], axes[name][1].group)
        return t.detach().cpu().clone()

    out = {"build_s": build_s, "rows": b}
    reduce = state.optimizer.reduce

    def reduce_and_keep(grads):
        """The optimizer's reduction, keeping the first step's gradients."""
        if reduce is not None:
            grads = reduce(grads)
        if "grads" not in out:
            by_id = {id(p): g for p, g in zip(state.optimizer.params, grads)}
            out["grad_scale"] = max(float(g.abs().max()) for g in grads)
            if axes:  # the largest over the slices of every rank
                top = torch.tensor([out["grad_scale"]], dtype=torch.float64)
                dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.model_group)
                out["grad_scale"] = float(top)
            out["grads"] = {n: whole(n, by_id[id(p)]) for n, p in watched.items()}
        return grads

    state.optimizer.reduce = reduce_and_keep
    gen = torch.Generator(device="cuda").manual_seed(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, step_s, launches = [], [], []
    for i, apply_lfd in enumerate(lfd):
        _reset_launches(FA)
        t0 = time.time()
        m = step(state, wav, x0, apply_lfd, generator=gen)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        launches.append(_launch_counts(FA))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["params"] = {n: whole(n, p) for n, p in watched.items()}
    out.update(metrics=metrics, step_s=step_s, launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               lr=max(sched(0) for _, sched in state.optimizer.groups))
    del pipe, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _step_agreement(got: dict, ref: dict) -> dict:
    """(b1)'s comparison of one process's steps with the one-rank reference:
    each step's metrics (relative), the first step's watched gradients
    (of the reference's largest gradient) and its updated watched tensors
    (where the gradient's sign is resolved, and anywhere), as phase 6."""
    scale = ref["grad_scale"]
    metric_rel = max(abs(a[k] - w[k]) / max(abs(w[k]), 1e-30)
                     for a, w in zip(got["metrics"], ref["metrics"]) for k in w)
    grad_err = max(float((got["grads"][n] - ref["grads"][n]).abs().max()) for n in ref["grads"])
    param_err = resolved_err = 0.0
    for n, want in ref["params"].items():
        diff = (got["params"][n] - want).abs()
        param_err = max(param_err, float(diff.max()))
        resolved = ref["grads"][n].abs() > 2 * SMALL_STEP_REL_TOL * scale
        if resolved.any():
            resolved_err = max(resolved_err, float(diff[resolved].max()))
    ok = (metric_rel <= PARALLEL_LOSS_RTOL and grad_err <= SMALL_STEP_REL_TOL * scale
          and resolved_err <= 1e-5 and param_err <= 2.1 * ref["lr"])
    return {"metric_max_rel_err": metric_rel, "grad_max_abs_err": grad_err,
            "grad_tol": SMALL_STEP_REL_TOL * scale, "param_max_abs_err": param_err,
            "resolved_param_max_abs_err": resolved_err, "ok": ok}


def ring_checks(FA, mesh, tokenizer_path: str) -> dict:
    """(b2) on this rank of a model=2 mesh: the ring at B=2, L=5120 against
    the whole sequence on one rank (plain f32, B2, and the kernels'
    backward), timed; then a float32 transcription of 2 x 102.4 s through
    the ring against the same pipeline on one rank (B2), the ids equal, and
    in bfloat16 their agreement."""
    from fddm_asr_tpu_torch.ops.ring_attention import ring_gated_attention
    from fddm_asr_tpu_torch.parallel.distributed import barrier
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    H, B, L = 16, RING_B, RING_L
    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v, bias, gate, mask = attention_inputs(B, L, H, torch.float32, gen,
                                                 valid=[L, WHOLE_FILE_FRAMES])
    dout = torch.randn(B, L, H * 64, device="cuda", generator=gen)
    me = mesh.model_rank
    n = mesh.shape["model"]
    l = L // n
    rows = slice(me * l, (me + 1) * l)
    plain = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)[:, rows]
    b2 = FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, num_heads=H)[:, rows]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias, gate)]
    ref = FA.wavlm_gated_attention_heads_packed_trainable(*leaves, mask, num_heads=H)
    (ref * dout).sum().backward()
    want = {"dq": leaves[0].grad[:, rows], "dk": leaves[1].grad[:, rows],
            "dv": leaves[2].grad[:, rows], "dbias": leaves[3].grad[:, rows],
            "dgate": leaves[4].grad[:, :, rows]}
    del ref, leaves

    def ring_call(grad: bool):
        blk = [t[:, rows].reshape(B, l, H, 64).clone().requires_grad_(grad) for t in (q, k, v)]
        bl = bias[:, rows].clone().requires_grad_(grad)
        gl = gate[:, :, rows].clone().requires_grad_(grad)
        out = ring_gated_attention(*blk, bl, gl, mask[:, rows], mesh.model_group)
        if grad:
            (out.reshape(B, l, H * 64) * dout[:, rows]).sum().backward()
        return out.reshape(B, l, H * 64), blk, bl, gl

    out, blk, bl, gl = ring_call(True)
    got = {"dq": blk[0].grad.reshape(B, l, -1), "dk": blk[1].grad.reshape(B, l, -1),
           "dv": blk[2].grad.reshape(B, l, -1), "dbias": bl.grad, "dgate": gl.grad}
    res = {"rank_rows": [rows.start, rows.stop],
           "fwd_max_abs_err_vs_plain_f32": float((out - plain).abs().max()),
           "fwd_within_tol_vs_b2": float(within_tol((out - b2).abs(), b2,
                                                    torch.bfloat16).max()),
           "grad_rel_err": {key: float((got[key] - want[key]).abs().max()
                                       / want[key].abs().max()) for key in want}}
    del out, blk, bl, gl, got, want, plain, b2
    # the ring's time on this rank, both ranks on one card (no scaling figure)
    times = {}
    for name, grad in (("fwd_ms", False), ("fwd_bwd_ms", True)):
        with torch.set_grad_enabled(grad):
            ring_call(grad)
            barrier()
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(2):
                ring_call(grad)
            torch.cuda.synchronize()
            times[name] = (time.time() - t0) / 2 * 1e3
    res["ring_ms"] = times
    del q, k, v, bias, gate, mask, dout
    gc.collect()
    torch.cuda.empty_cache()

    # a transcription through the ring against one rank's (B2 past 4096 frames)
    wav = synthetic_audio(B, L * 320 / 16000.0, seed=201)
    x_init = torch.randint(0, 8000, (B, RING_SEQ_LEN), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(21))
    for dtype in ("float32", "bfloat16"):
        cfg = flagship_config(tokenizer_path, dtype=dtype)
        pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(tokenizer_path), seed=5)
        ids = {}
        for name in ("one_rank", "ring"):
            if name == "ring":
                pipe.apply_mesh(mesh, seq_parallel=True)
            _reset_launches(FA)
            torch.cuda.synchronize()
            t0 = time.time()
            rows_out = pipe.transcribe_with_ids(wav, seq_len=RING_SEQ_LEN, x_init=x_init,
                                                greedy=True)
            res[f"transcribe_{dtype}_{name}_s"] = time.time() - t0
            res[f"transcribe_{dtype}_{name}_launches"] = _launch_counts(FA)
            ids[name] = [r[1] for r in rows_out]
        agree = [a == b for x, y in zip(ids["one_rank"], ids["ring"]) for a, b in zip(x, y)]
        res[f"ids_{dtype}_equal"] = ids["one_rank"] == ids["ring"]
        res[f"ids_{dtype}_agreement"] = sum(agree) / len(agree)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return res


def parallel_rank(d: str) -> int:
    """`python3 chip_smoke.py --parallel-rank DIR`: one rank of phase 20
    (b) or (c), joined from FDDM_COORDINATOR / FDDM_NUM_PROCESSES /
    FDDM_PROCESS_ID / FDDM_BACKEND / FDDM_DEVICE (LOCAL_RANK): (b1) on a
    data=2 mesh, then (b2) on a model=2 mesh of the same two processes,
    then phase 21 (a)-(c) on a model=2 mesh (`tp_checks`) and (e1)
    (`sharded_artifact`); writes DIR/rank<R>.pt.  Prints no result line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fddm_asr_tpu_torch import parallel as P
    from fddm_asr_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist_cfg = P.DistributedConfig.from_env()
    rank, _ = P.initialize(dist_cfg)
    try:
        dev = dist_cfg.rank_device("cuda")
        with open(os.path.join(d, "parallel.json")) as f:
            spec = json.load(f)
        t0 = time.time()
        out = {"backend": P.DistributedConfig.from_env().resolved_backend(dev),
               "device": str(dev)}
        out["b1"] = parallel_steps(FA, parallel_config(spec["tokenizer"]),
                                   P.make_mesh(P.MeshSpec(data=2, model=1), dev))
        out["b1_s"] = time.time() - t0
        t0 = time.time()
        ring_mesh = P.make_mesh(P.MeshSpec(data=1, model=2), dev)
        out["b2"] = ring_checks(FA, ring_mesh, spec["tokenizer"])
        out["b2_s"] = time.time() - t0
        out["staging"] = P.STAGING.as_dict()
        # phase 21 (a)-(c): the same two processes, the weights split over them
        t0 = time.time()
        out["tp"] = tp_checks(FA, P.make_mesh(P.MeshSpec(data=1, model=2), dev),
                              spec["tokenizer"])
        out["tp_s"] = time.time() - t0
        # phase 21 (e1): a sharded artifact of a model=2 mesh of the same two;
        # (e2) runs in the other pair (`ring_artifact_rank`); (b3) starts now
        if rank == 0:
            with open(os.path.join(d, "e1_started"), "w") as f:
                f.write(str(time.time()))
        out["aot"] = {"e1": sharded_artifact(dev, spec["tokenizer"], d, False)}
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    finally:
        P.shutdown()
    return 0


def ring_artifact_rank(d: str) -> int:
    """`python3 chip_smoke.py --ring-artifact-rank DIR`: one rank of phase 21
    (e2)'s pair of processes, started once phase 20 (b)'s reach (e1), beside
    which it runs (e2) (`sharded_artifact` with the ring: its export and load
    are host work); writes DIR/ring_rank<R>.pt.  Prints no result line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fddm_asr_tpu_torch import parallel as P

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist_cfg = P.DistributedConfig.from_env()
    rank, _ = P.initialize(dist_cfg)
    try:
        with open(os.path.join(d, "parallel.json")) as f:
            spec = json.load(f)
        out = {"e2": sharded_artifact(dist_cfg.rank_device("cuda"), spec["tokenizer"], d, True)}
        torch.save(out, os.path.join(d, f"ring_rank{rank}.pt"))
    finally:
        P.shutdown()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_pair(d: str, backend: str, tag: str, role: str = "--parallel-rank") -> list:
    """Two `role` processes (`--parallel-rank` or `--ring-artifact-rank`)
    over `backend`: on cuda:0 both (gloo), or one card each (nccl)."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "FDDM_COORDINATOR": f"127.0.0.1:{port}",
               "FDDM_NUM_PROCESSES": "2", "FDDM_PROCESS_ID": str(rank),
               "FDDM_BACKEND": backend, "LOCAL_RANK": str(rank)}
        if backend == "gloo":
            env["FDDM_DEVICE"] = "cuda:0"
        log = open(os.path.join(d, f"{tag}.rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), role, d], env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait_pair(procs: list, d: str, tag: str, output: str = "rank") -> tuple:
    """The outputs DIR/<output><R>.pt of `_start_pair`'s processes and
    their wall seconds; stops both when one fails or outlasts 900 s."""
    t0 = time.time()
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, 900 - (time.time() - t0)))
    finally:
        _stop_pair(procs)
    wall = time.time() - t0
    for rank, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(d, f"{tag}.rank{rank}.log")) as f:
                log = f.read()
            fail(f"({tag}) rank {rank} exited {proc.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(d, f"{output}{r}.pt")) for r in range(2)], wall


def _stop_pair(procs: list) -> None:
    for proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _spawn_ranks(d: str, backend: str, tag: str) -> tuple:
    """Two `--parallel-rank` processes over `backend`: their outputs and
    wall seconds."""
    return _wait_pair(_start_pair(d, backend, tag), d, tag)


def _check_ranks(tag: str, ranks: list, reference: dict, want_launches: dict) -> dict:
    """(b1) and (b2) of two ranks against the one-rank reference."""
    out = {}
    for r, res in enumerate(ranks):
        b1, b2 = res["b1"], res["b2"]
        agreement = _step_agreement(b1, reference)
        row = {"backend": res["backend"], "device": res["device"], "rows": b1["rows"],
               "build_s": b1["build_s"], "step_s": b1["step_s"],
               "peak_mem_gb": b1["peak_mem_gb"], "launches_per_step": b1["launches"][1],
               "losses": [m["total_loss"] for m in b1["metrics"]], "vs_one_rank": agreement,
               "b1_s": res["b1_s"], "b2_s": res["b2_s"], "staging": res["staging"],
               "ring": b2}
        out[f"rank{r}"] = row
        if not agreement["ok"]:
            fail(f"({tag}1) rank {r}'s steps disagree with one rank's: {agreement}")
        if any({k: c[k] for k in want_launches} != want_launches for c in b1["launches"]):
            fail(f"({tag}1) rank {r} launched {b1['launches']}, expected {want_launches} a step")
        grad_bad = {k: e for k, e in b2["grad_rel_err"].items() if not e <= RING_GRAD_REL_TOL}
        if (not b2["fwd_max_abs_err_vs_plain_f32"] <= RING_FWD_TOL
                or not b2["fwd_within_tol_vs_b2"] <= 1.0 or grad_bad):
            fail(f"({tag}2) rank {r}'s ring disagrees: {b2}")
        if not b2["ids_float32_equal"]:
            fail(f"({tag}2) rank {r}'s float32 ring transcription ids differ from one rank's")
        if b2["transcribe_float32_one_rank_launches"]["fwd"] == 0:
            fail(f"({tag}2) the one-rank transcription launched no B2: {b2}")
    return out


def parallel_full_width(FA, d: str, card: str, cli_c: dict) -> dict:
    """Phase 20 (module docstring): several GPUs, on one card.  `d` holds
    phase 15's tokenizer and phase 18's corpus; `cli_c` phase 18 (c)'s
    inference CLI run: its arguments and printed rows."""
    from fddm_asr_tpu_torch import parallel as P

    root = os.path.dirname(os.path.abspath(__file__))
    tok = synthetic_tokenizer(d, 8000)
    cfg = parallel_config(tok)
    gc.collect()
    torch.cuda.empty_cache()
    result = {"card": card, "b1_global_batch": f"{PARALLEL_B} x {FINETUNE_SECONDS:g} s, "
              f"{PARALLEL_B // 2} a rank, float32, dropout off"}

    # the one-rank reference of (a) and (b1): the bare step on the global batch
    t0 = time.time()
    reference = parallel_steps(FA, cfg, None)
    # (a) the same steps on a mesh over NCCL at world size 1 (the real backend path)
    P.initialize(P.DistributedConfig(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl"))
    try:
        nccl = parallel_steps(FA, cfg, P.make_mesh(P.MeshSpec(data=1, model=1)))
    finally:
        P.shutdown()
    a = {"vs_bare_step": _step_agreement(nccl, reference), "step_s": nccl["step_s"],
         "bare_step_s": reference["step_s"], "peak_mem_gb": nccl["peak_mem_gb"],
         "bare_peak_mem_gb": reference["peak_mem_gb"],
         "losses": [m["total_loss"] for m in nccl["metrics"]],
         "bare_losses": [m["total_loss"] for m in reference["metrics"]],
         "launches_per_step": nccl["launches"][1], "seconds": time.time() - t0}
    result["a"] = a
    print(json.dumps({"parallel_a": a}), flush=True)
    if not a["vs_bare_step"]["ok"]:
        fail(f"(a) the world-size-1 NCCL steps disagree with the bare step: {a['vs_bare_step']}")
    want = {k: reference["launches"][1][k] for k in ("fwd_lse", "bwd_dq", "bwd_dkv")}

    # (b) two ranks sharing the card over gloo: (b1) the data-parallel steps,
    # (b2) the ring; the kernels' build in _build/ is reused by both
    with open(os.path.join(d, "parallel.json"), "w") as f:
        json.dump({"tokenizer": tok}, f)
    gc.collect()
    torch.cuda.empty_cache()
    pair, ring_pair = _start_pair(d, "gloo", "b"), []
    try:
        # once the ranks reach phase 21 (e1), whose export and load are host
        # work: phase 21 (e2)'s pair and (b3) the entry points under torchrun
        # (two ranks on the card over gloo) beside it; not before, so that
        # (b1), (b2) and phase 21 (a)-(c) have the card and the host alone.
        # (e1)'s, (e2)'s and (b3)'s seconds are taken beside one another.
        t0 = time.time()
        marker = os.path.join(d, "e1_started")
        while not os.path.exists(marker):
            if any(proc.poll() is not None for proc, _ in pair) or time.time() - t0 > 800:
                _stop_pair(pair)
                _wait_pair(pair, d, "b")  # a rank that failed says why
                fail("(b) the ranks ended or stalled before phase 21 (e1)")
            time.sleep(0.5)
        ring_pair = _start_pair(d, "gloo", "b_ring", "--ring-artifact-rank")
        result["b3"] = parallel_entry_points(d, root, cli_c)
        ranks, wall = _wait_pair(pair, d, "b")
        ring_ranks, _ = _wait_pair(ring_pair, d, "b_ring", "ring_rank")
    finally:
        _stop_pair(pair)
        _stop_pair(ring_pair)
    wall = time.time() - t0  # from the ranks' start to their end: (e1), (e2), (b3) included
    result["b"] = {"wall_s": wall, **_check_ranks("b", ranks, reference, want)}
    # phase 21's (a)-(c) and (e1), made by the same processes, (e2) by the
    # ring pair, and (b)'s reference
    result["tp_ranks"] = [r.pop("tp") for r in ranks]
    result["aot_ranks"] = [{**r.pop("aot"), "e2": ring["e2"]}
                           for r, ring in zip(ranks, ring_ranks)]
    result["reference"] = reference
    for i, res in enumerate(ranks):
        result["b"][f"rank{i}"]["tp_s"] = res["tp_s"]
    print(json.dumps({"parallel_b": result["b"]}), flush=True)

    # (c) one card a rank over NCCL
    if torch.cuda.device_count() >= 2:
        ranks, wall = _spawn_ranks(d, "nccl", "c")
        result["c"] = {"wall_s": wall, **_check_ranks("c", ranks, reference, want)}
        result["c_aot_ranks"] = [r.pop("aot") for r in ranks]  # phase 21 (e) over NCCL
    else:
        result["c"] = {"not_run": f"{torch.cuda.device_count()} card: NCCL needs one card a "
                                  "rank, so (b) over NCCL runs only where there are two"}
    print(json.dumps({"parallel_c": result["c"]}), flush=True)
    return result


def parallel_entry_points(d: str, root: str, cli_c: dict) -> dict:
    """(b3): `torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.train --mesh
    data=2` (torch.distributed.run) on phase 18's corpus, frozen, two steps
    of 16, evaluating the validation set sharded; then phase 18 (c)'s
    inference CLI run once more under torchrun with `--mesh data=2`, its
    rows (ids and texts) equal to that one process's."""
    env = {**os.environ, "FDDM_BACKEND": "gloo", "FDDM_DEVICE": "cuda:0"}
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m"]
    manifests = {s: os.path.join(d, f"{s}.json") for s in ("train", "validation")}
    ckpt_dir = os.path.join(d, "ckpt_parallel")
    cfg = _train_config(os.path.join(d, "parallel.yaml"),
                        os.path.join(root, "configs", "fddm_zhTW_base.yaml"), {
        "data": {"train_json": manifests["train"], "val_json": manifests["validation"],
                 "test_json": os.path.join(d, "no_test_set.json"),
                 "tokenizer_path": os.path.join(d, "spm_synth.vocab")},
        "optim": {"batch_size": PARALLEL_TRAIN_B, "num_epochs": 1},
        "log": {"log_every": 1, "metrics_jsonl": True, "ckpt_dir": ckpt_dir}})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    proc = subprocess.run([*run, "fddm_asr_tpu_torch.train", "--config", cfg, "--mesh",
                           "data=2", "--max-steps-per-epoch", str(PARALLEL_TRAIN_STEPS)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    train_s = time.time() - t0
    if proc.returncode != 0:
        fail(f"(b3) torchrun train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    records = _metrics(ckpt_dir)
    steps = [r for r in records if r["kind"] == "step"]
    epoch = [r for r in records if r["kind"] == "epoch"]
    names = set(os.listdir(ckpt_dir))
    res = {"train_s": train_s, "steps": [r["step"] for r in steps],
           "losses": [r["total_loss"] for r in steps], "epoch": epoch,
           "files": sorted(n for n in names if not n.startswith("."))}
    if ([r["step"] for r in steps] != list(range(1, PARALLEL_TRAIN_STEPS + 1))
            or len(epoch) != 1 or not all(np.isfinite(res["losses"]))
            or not {"ep001.pt", "best_model.pt", "ep001.state.pt"} <= names):
        fail(f"(b3) torchrun train wrote {res}")

    stats = os.path.join(d, "parallel_infer.stats.json")
    t0 = time.time()
    proc = subprocess.run([*run, "fddm_asr_tpu_torch.inference", *cli_c["args"], "--mesh",
                           "data=2", "--stats-json", stats], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    res["infer_s"] = time.time() - t0
    if proc.returncode != 0:
        fail(f"(b3) torchrun inference exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    printed = [x for x in _cli_output(proc.stdout) if "ids" in x]
    with open(stats) as f:
        res["infer_launches_rank0"] = json.load(f)["launches"]
    one = cli_c["rows"]
    res.update(rows=len(printed), ids_equal_one_process=[x["ids"] for x in printed] == [
        x["ids"] for x in one], texts_equal_one_process=[x["text"] for x in printed] == [
        x["text"] for x in one])
    print(json.dumps({"parallel_b3": res}), flush=True)
    if len(printed) != len(one) or not res["ids_equal_one_process"] \
            or not res["texts_equal_one_process"]:
        fail(f"(b3) the data=2 CLI's rows differ from phase 18 (c)'s one process: {res}")
    if res["infer_launches_rank0"]["fwd"] == 0:
        fail(f"(b3) rank 0 of the data=2 CLI launched no B1: {res['infer_launches_rank0']}")
    return res


# ------------------------------------------- phase 21: tensor parallelism
# (a)/(c): 8 x 20 s at model=2, the weights split over the two ranks of phase
# 20 (b); (b): two of phase 20's reference steps; (d): uploads served
TP_B, TP_SECONDS, TP_SEQ_LEN = 8, 20.0, 128
TP_LFD = PARALLEL_LFD[:2]
TP_H = 8  # WavLM-large's 16 heads over model=2
TP_SERVE_UPLOADS = 4
# (e): the sharded artifacts of a model=2 mesh, (a)'s batch and one row at
# 20 s (one program, its batch dynamic), x_T drawn from AOT_MESH_SEED; (e3)
# serves AOT_MESH_UPLOADS uploads of it, each a batch of one
AOT_MESH_BUCKET, AOT_MESH_SEQ_LEN, AOT_MESH_SEED = (TP_B, int(TP_SECONDS * 16000)), 64, 215
AOT_MESH_BUCKETS = [(1, AOT_MESH_BUCKET[1]), AOT_MESH_BUCKET]
AOT_MESH_SAMPLING = {"T_infer": 20, "r": 5, "greedy": True}
AOT_MESH_UPLOADS = 3
# (e2)'s depth: the ring's artifact at full width and 6 of WavLM-large's 24
# layers (its trace and load, host work, take about a quarter of the 45 s
# and 20 s that 24 layers took on the card's host)
AOT_RING_LAYERS = 6
AOT_RING_WAVLM = {"num_hidden_layers": AOT_RING_LAYERS}


def tp_transcribe(mesh, tokenizer_path: str, dtype: str, wavlm_config=None) -> dict:
    """Phase 21 (a)/(c): 8 x 20 s through the flagship pipeline of `dtype`
    (seed 5) at an injected x_init, tensor-parallel on `mesh` or in one
    process (None): ids, seconds and every wrapper's launches."""
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    pipe = FDDMPipeline.from_config(flagship_config(tokenizer_path, wavlm_config, dtype),
                                    tokenizer=load_tokenizer(tokenizer_path), seed=5)
    if mesh is not None:
        pipe.apply_mesh(mesh)
    wav = synthetic_audio(TP_B, TP_SECONDS, seed=211)
    x_init = torch.randint(0, 8000, (TP_B, TP_SEQ_LEN), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(212))
    wrappers = port_kernel_wrappers()
    _reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.time()
    rows = pipe.transcribe_with_ids(wav, seq_len=TP_SEQ_LEN, x_init=x_init, greedy=True)
    torch.cuda.synchronize()
    out = {"seconds": time.time() - t0, "launches": _counts_since_reset(wrappers),
           "ids": [r[1] for r in rows]}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_checks(FA, mesh, tokenizer_path: str) -> dict:
    """Phase 21 (a)-(c) on this rank of a model=2 mesh: the float32 and
    bfloat16 transcriptions and the int8_fused one (float32) tensor
    parallel; two of phase 20's fine-tune steps with the weights split
    (`parallel_steps(tensor=True)`); gloo's staged bytes of the phase."""
    from fddm_asr_tpu_torch import parallel as P

    staged = P.STAGING.as_dict()
    t0 = time.time()
    res = {name: tp_transcribe(mesh, tokenizer_path, dtype, wavlm)
           for name, dtype, wavlm in (("float32", "float32", None),
                                      ("bfloat16", "bfloat16", None),
                                      ("int8_fused", "float32", {"quant_dense": "int8_fused"}))}
    res["transcribe_phase_s"] = time.time() - t0
    t0 = time.time()
    res["step"] = parallel_steps(FA, parallel_config(tokenizer_path), mesh, tensor=True,
                                 lfd=TP_LFD)
    res["step_phase_s"] = time.time() - t0
    res["staging"] = {k: v - staged[k] for k, v in P.STAGING.as_dict().items()}
    return res


def sharded_artifact(dev, tokenizer_path: str, d: str, seq_parallel: bool) -> dict:
    """Phase 21 (e1), or (e2) with `seq_parallel`, on this rank: the
    flagship float32 pipeline (seed 5; (e2) at AOT_RING_LAYERS WavLM
    layers) over a model=2 mesh, tensor parallel or on the ring, exported (`aot.save_artifact`: buckets 1 and 8 x 20 s,
    one program, seq_len 64, greedy), loaded (over gloo its programs run eagerly; over
    NCCL, one card a rank, as CUDA graphs) and run once on (a)'s batch at
    AOT_MESH_SEED: the ids, each step's seconds, every wrapper's launches in
    the call and the program's `torch.ops.fddm` nodes; (e1) also the live
    model=2 pipeline's ids at that seed."""
    from fddm_asr_tpu_torch import aot
    from fddm_asr_tpu_torch import parallel as P
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    art = os.path.join(d, "artifact_model2_" + ("ring" if seq_parallel else "tp"))
    wav = synthetic_audio(TP_B, TP_SECONDS, seed=211)
    pipe = FDDMPipeline.from_config(
        flagship_config(tokenizer_path, AOT_RING_WAVLM if seq_parallel else None, "float32"),
        tokenizer=load_tokenizer(tokenizer_path), seed=5)
    pipe.apply_mesh(P.make_mesh(P.MeshSpec(data=1, model=2), dev), seq_parallel=seq_parallel)
    out = {"artifact": art}
    t0 = time.time()
    meta = aot.save_artifact(pipe, art, AOT_MESH_BUCKETS, AOT_MESH_SEQ_LEN, AOT_MESH_SAMPLING,
                             tokenizer_path)
    out.update(export_s=time.time() - t0, meta_mesh=meta["mesh"],
               program_per_model_rank=meta["program_per_model_rank"])
    if not seq_parallel:
        t0 = time.time()
        rows = pipe.transcribe_with_ids(
            wav, seq_len=AOT_MESH_SEQ_LEN,
            generator=torch.Generator(device=dev).manual_seed(AOT_MESH_SEED), **AOT_MESH_SAMPLING)
        out.update(live_ids=[r[1] for r in rows], live_s=time.time() - t0)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ep = aot.ExportedPipeline.load(art, device=str(dev))
    out.update(load_s=time.time() - t0, execution=ep.execution, eager_reason=ep.eager_reason,
               native_buckets=sorted(list(bn) for bn in ep.native))
    wrappers = port_kernel_wrappers()
    _reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.time()
    rows = ep.transcribe_with_ids(wav, seed=AOT_MESH_SEED)
    torch.cuda.synchronize()
    out.update(call_s=time.time() - t0, launches=_counts_since_reset(wrappers),
               ids=[r[1] for r in rows])
    nodes: dict = {}
    for node in next(iter(ep._programs.values())).graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("fddm."):
            nodes[target] = nodes.get(target, 0) + 1
    out["program_fddm_nodes"] = nodes
    del ep
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _torchrun_serve_start(root: str, flags: list, err_path: str) -> tuple:
    """Start `torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.serve *flags
    --port 0`, both ranks on the card over gloo; its lines are read into a
    queue.  (start time, process, lines, flags, stderr path)."""
    import queue as queue_mod
    import threading

    env = {**os.environ, "FDDM_BACKEND": "gloo", "FDDM_DEVICE": "cuda:0"}
    t0 = time.time()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "fddm_asr_tpu_torch.serve", *flags, "--port", "0"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    lines = queue_mod.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    return t0, proc, lines, flags, err_path


def _torchrun_serve(started: tuple, bodies: list, tag: str) -> dict:
    """A server `_torchrun_serve_start` began: once it is ready, `bodies`
    uploaded one at a time, then `/healthz`, then SIGINT to rank 0, which
    sends the stop op; torchrun must exit 0.  The served results, `/healthz`
    and the seconds from its start."""
    import queue as queue_mod
    import signal

    t0, proc, lines, flags, err_path = started
    served, ready, out = [], None, {}
    try:
        while ready is None:
            try:
                line = lines.get(timeout=max(1.0, 300 - (time.time() - t0)))
            except queue_mod.Empty:
                break
            if line.startswith('{"serving"'):
                ready = json.loads(line)
        if ready is not None:
            out["start_to_ready_s"] = time.time() - t0
            t1 = time.time()
            for body in bodies:
                status, raw = _http(ready["serving"], "POST", "/v1/transcribe", body,
                                    {"Content-Type": "audio/wav"})
                served.append((status, json.loads(raw)))
            out["serve_s"] = time.time() - t1
            _, health = _http(ready["serving"], "GET", "/healthz")
            out["health"] = json.loads(health)
            os.kill(ready["pid"], signal.SIGINT)
    finally:
        _stop_server(proc)
    rc = proc.returncode
    if ready is None or rc != 0 or any(st != 200 for st, _ in served):
        with open(err_path, encoding="utf-8", errors="replace") as f:
            fail(f"({tag}) torchrun serve {' '.join(flags[-2:])}: ready {ready}, exit {rc}, "
                 f"statuses {[st for st, _ in served]}:\n{f.read()[-4000:]}")
    out.update(exit_code=rc, ids=[obj["ids"] for _, obj in served])
    return out


def _stop_server(proc) -> None:
    """Wait up to 120 s for a torchrun server to exit, then kill it."""
    try:
        proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _uploads(d: str, n: int, seed: int, tag: str) -> tuple:
    """`n` WAV bodies of U(2, 20) s of synthetic audio, and their samples."""
    rng = np.random.default_rng(seed)
    uploads = [synthetic_audio(1, float(sec), seed=seed + 1 + i)[0]
               for i, sec in enumerate(rng.uniform(2.0, 20.0, n))]
    return [_wav_bytes(os.path.join(d, f"{tag}{i}.wav"), w) for i, w in enumerate(uploads)], uploads


def _tp_serve_args(d: str, root: str) -> list:
    """Phase 21 (d)'s server: phase 15's decoder `.pt` and tokenizer with
    configs/fddm_zhTW_base.yaml's random encoder, in float32."""
    return ["--config", os.path.join(root, CLI_MAIN_CONFIG), "--ckpt",
            os.path.join(d, "decoder.pt"), "--tokenizer", os.path.join(d, "spm_synth.vocab"),
            "--dtype", "float32"]


def _tp_serve(d: str, root: str, started: tuple) -> dict:
    """Phase 21 (d): `torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.serve
    --mesh model=2` (float32, gloo, both ranks on the card) on phase 15's
    decoder `.pt` and tokenizer with configs/fddm_zhTW_base.yaml's random
    encoder; TP_SERVE_UPLOADS uploads of 2-20 s one at a time (a batch of
    one each, batch n at the engine's generator seed n); each served ids
    against this process's pipeline of the same flags (`serve._live_pipeline`)
    on the same padded batch and seed; SIGINT to rank 0 sends the stop op,
    and torchrun must exit 0.  `started`: the server's `_torchrun_serve_start`
    (its start-up runs beside (a)-(c)'s work in this process)."""
    from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD
    from fddm_asr_tpu_torch import serve as S

    args = _tp_serve_args(d, root)
    bodies, uploads = _uploads(d, TP_SERVE_UPLOADS, 213, "tp")
    out = _torchrun_serve(started, bodies, "d")

    # the same batches in this process, one process's pipeline
    pipe, sampling, seq_len = S._live_pipeline(S.parse_args([*args, "--device", "cuda"]), None)
    want = []
    for i, body in enumerate(bodies):
        wave = S._decode_wav_bytes(body)  # the samples the server read
        T = max(-(-len(wave) // 16000) * 16000, CONV_RECEPTIVE_FIELD)
        batch = np.zeros((1, T), np.float32)
        batch[0, :len(wave)] = wave
        rows = pipe.transcribe_with_ids(
            batch, np.array([max(len(wave), CONV_RECEPTIVE_FIELD)]), seq_len=seq_len,
            generator=torch.Generator(device="cuda").manual_seed(i + 1), with_confidence=True,
            **sampling)
        want.append(rows[0][1])
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    got = out["ids"]
    res = {"uploads": len(bodies), "seconds": [round(len(w) / 16000, 2) for w in uploads],
           "start_to_ready_s": out["start_to_ready_s"], "serve_s": out["serve_s"],
           "exit_code": out["exit_code"], "healthz_mesh": out["health"].get("mesh"),
           "ids_equal_in_process": got == want,
           "rows_equal": sum(a == b for a, b in zip(got, want))}
    if not res["ids_equal_in_process"]:
        fail(f"(d) served ids differ from the in-process pipeline's: {res}")
    return res


def sharded_artifacts_full_width(d: str, tok: str, parallel: dict, served: tuple) -> dict:
    """Phase 21 (e): (e1) and (e2) as phase 20's two gloo ranks made them
    (`sharded_artifact`) against one process's flagship float32 pipeline
    (seed 5) at AOT_MESH_SEED: each rank's ids equal, (e1)'s also the live
    model=2 pipeline's, B1 24 a rank a call inside the tensor-parallel
    program, the ring's hop in the sequence-parallel one (AOT_RING_LAYERS
    layers, and no B1: its attention is the ring's), both eager ("gloo: no graph capture"); (e3)
    `torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.serve --exported`
    on (e1)'s artifact: AOT_MESH_UPLOADS uploads of 2-20 s one at a time,
    each a batch of one padded into the 1 x 20 s bucket, ids equal to this
    process's pipeline on that padded batch at the engine's counter,
    `/healthz` naming the mesh and the eager mode; with two cards or more
    (e1) over NCCL from phase 20 (c)'s ranks, every bucket a CUDA graph.
    `served`: (e3)'s `_torchrun_serve_start`, begun with the phase."""
    from fddm_asr_tpu_torch import serve as S
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    t_phase = time.time()

    def one_process(wavlm_config):
        return FDDMPipeline.from_config(flagship_config(tok, wavlm_config, "float32"),
                                        tokenizer=load_tokenizer(tok), seed=5)

    def ids_at(pipe, wav, seed):
        return [r[1] for r in pipe.transcribe_with_ids(
            wav, seq_len=AOT_MESH_SEQ_LEN, generator=torch.Generator(device="cuda").manual_seed(
                seed), **AOT_MESH_SAMPLING)]

    wav = synthetic_audio(TP_B, TP_SECONDS, seed=211)
    ring = one_process(AOT_RING_WAVLM)
    one = {"e2": ids_at(ring, wav, AOT_MESH_SEED)}
    del ring
    pipe = one_process(None)
    one["e1"] = ids_at(pipe, wav, AOT_MESH_SEED)
    result = {"buckets": [list(bn) for bn in AOT_MESH_BUCKETS], "seq_len": AOT_MESH_SEQ_LEN,
              "seed": AOT_MESH_SEED}

    def check(tag: str, ranks: list, execution: str) -> dict:
        rows = {}
        for r, rank in enumerate(ranks):
            e = rank[tag]
            row = {k: e[k] for k in ("export_s", "load_s", "call_s", "execution", "eager_reason",
                                     "native_buckets", "meta_mesh", "program_per_model_rank",
                                     "program_fddm_nodes")}
            row.update(ids_equal_one_process=e["ids"] == one[tag],
                       launches={k: v for k, v in e["launches"].items() if v})
            if tag == "e1":
                row.update(live_model2_ids_equal=e["live_ids"] == e["ids"], live_s=e["live_s"])
            rows[f"rank{r}"] = row
            if not row["ids_equal_one_process"] or not row.get("live_model2_ids_equal", True):
                fail(f"({tag}) rank {r}'s sharded artifact's ids differ: {row}")
            if row["execution"] != execution or (
                    execution == "eager" and row["eager_reason"] != "gloo: no graph capture") or (
                    execution == "cuda graphs"
                    and len(row["native_buckets"]) != len(AOT_MESH_BUCKETS)):
                fail(f"({tag}) rank {r} ran the programs as {row['execution']} "
                     f"({row['eager_reason']}; graphs {row['native_buckets']}), not {execution}")
            if tag == "e1" and e["launches"]["fwd"] != 24:
                fail(f"(e1) rank {r} launched B1 {e['launches']['fwd']} times in a call, not 24")
            if tag == "e2" and (e["launches"]["fwd"] != 0 or row["program_fddm_nodes"].get(
                    "fddm.ring_shift.default", 0) != AOT_RING_LAYERS):
                fail(f"(e2) rank {r}: the ring is not the program's attention: {row}")
        return rows

    ranks = parallel["aot_ranks"]
    for tag in ("e1", "e2"):
        result[tag] = check(tag, ranks, "eager")
    print(json.dumps({"sharded_artifact_e12": result}), flush=True)

    bodies, uploads = _uploads(d, AOT_MESH_UPLOADS, 216, "aot")
    served = _torchrun_serve(served, bodies, "e3")
    want = []
    for i, body in enumerate(bodies):
        wave = S._decode_wav_bytes(body)  # the samples the server read
        batch = np.zeros((1, AOT_MESH_BUCKET[1]), np.float32)
        batch[0, :len(wave)] = wave  # one upload a batch, padded into the bucket
        want.append(ids_at(pipe, batch, i + 1)[0])
    e3 = {"uploads": len(bodies), "seconds": [round(len(w) / 16000, 2) for w in uploads],
          **{k: served[k] for k in ("start_to_ready_s", "serve_s", "exit_code")},
          "healthz": {k: served["health"].get(k) for k in (
              "mesh", "execution", "eager_reason", "native_buckets", "max_batch")},
          "ids_equal_in_process": served["ids"] == want}
    result["e3"] = e3
    if not e3["ids_equal_in_process"]:
        fail(f"(e3) served ids differ from this process's pipeline's: {e3}")
    if (e3["healthz"]["mesh"] != {"data": 1, "model": 2, "seq_parallel": False}
            or e3["healthz"]["execution"] != "eager"
            or e3["healthz"]["eager_reason"] != "gloo: no graph capture"):
        fail(f"(e3) /healthz does not name the mesh and the eager mode: {e3['healthz']}")
    if parallel.get("c_aot_ranks"):
        result["nccl"] = check("e1", parallel["c_aot_ranks"], "cuda graphs")
    else:
        result["nccl"] = {"not_run": f"{torch.cuda.device_count()} card: (e1) over NCCL needs "
                                     "one card a rank"}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    result["phase_s"] = time.time() - t_phase
    print(json.dumps({"sharded_artifact_e3": e3, "sharded_artifact_nccl": result["nccl"],
                      "sharded_artifact_phase_s": result["phase_s"]}), flush=True)
    return result


def tp_servers_start(d: str, parallel: dict) -> dict:
    """Phase 21 (d)'s and (e3)'s servers, started before phase 22: their
    ranks' start-up and loading, host work, run beside phase 22 and phase
    21's one-process references (`_torchrun_serve_start` each)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return {"d": _torchrun_serve_start(root, [*_tp_serve_args(d, root), "--mesh", "model=2"],
                                       os.path.join(d, "tp_serve.stderr")),
            "e3": _torchrun_serve_start(
                root, ["--exported", parallel["aot_ranks"][0]["e1"]["artifact"]],
                os.path.join(d, "aot_serve.stderr"))}


def tp_servers_stop(servers: dict) -> None:
    """Kill a server of `tp_servers_start` still running (a failed phase)."""
    for started in servers.values():
        if started[1].poll() is None:
            started[1].kill()
            started[1].wait()


def tensor_parallel_full_width(FA, Q, d: str, card: str, parallel: dict,
                               servers: dict) -> dict:
    """Phase 21 (module docstring): tensor parallelism at full width.  The
    ranks' (a)-(c) and (e1)-(e2) come from phase 20's processes (`tp_checks`,
    `sharded_artifact`); here the one-process references, (e) and (d) on
    `servers` (`tp_servers_start`), and the kernels at a rank's shapes
    once both servers have stopped."""
    root = os.path.dirname(os.path.abspath(__file__))
    tok = os.path.join(d, "spm_synth.vocab")
    ranks = parallel["tp_ranks"]
    t_phase = time.time()
    result = {"card": card, "batch": f"{TP_B} x {TP_SECONDS:g} s, seq_len {TP_SEQ_LEN}, "
              "model=2: two ranks share the card over gloo"}
    one = {name: tp_transcribe(None, tok, dtype, wavlm)
           for name, dtype, wavlm in (("float32", "float32", None),
                                      ("bfloat16", "bfloat16", None),
                                      ("int8_fused", "float32", {"quant_dense": "int8_fused"}))}
    for r, tp in enumerate(ranks):
        row = {}
        for name in ("float32", "bfloat16", "int8_fused"):
            agree = [a == b for x, y in zip(tp[name]["ids"], one[name]["ids"])
                     for a, b in zip(x, y)]
            row[name] = {"ids_equal_one_process": tp[name]["ids"] == one[name]["ids"],
                         "token_agreement": sum(agree) / len(agree),
                         "seconds": tp[name]["seconds"],
                         "one_process_seconds": one[name]["seconds"],
                         "launches": tp[name]["launches"],
                         "one_process_launches": one[name]["launches"]}
        agreement = _step_agreement(tp["step"], parallel["reference"])
        row["step"] = {"vs_one_rank": agreement, "step_s": tp["step"]["step_s"],
                       "one_rank_step_s": parallel["reference"]["step_s"][:len(TP_LFD)],
                       "peak_mem_gb": tp["step"]["peak_mem_gb"],
                       "one_rank_peak_mem_gb": parallel["reference"]["peak_mem_gb"],
                       "launches": tp["step"]["launches"],
                       "losses": [m["total_loss"] for m in tp["step"]["metrics"]]}
        row.update(staging=tp["staging"], transcribe_phase_s=tp["transcribe_phase_s"],
                   step_phase_s=tp["step_phase_s"])
        result[f"rank{r}"] = row
        if not (row["float32"]["ids_equal_one_process"]
                and row["int8_fused"]["ids_equal_one_process"]):
            fail(f"(a)/(c) rank {r}'s tensor-parallel ids differ from one process's: {row}")
        if not agreement["ok"]:
            fail(f"(b) rank {r}'s tensor-parallel steps disagree with one rank's: {agreement}")
        for name in ("float32", "int8_fused"):
            if row[name]["launches"]["fwd"] != 24:
                fail(f"(a) rank {r} launched B1 {row[name]['launches']['fwd']} times, not 24")
        fused = row["int8_fused"]["launches"]["int8_matmul_fused"]
        if fused != 4 * 24:  # q, k, v, intermediate_dense: the column slices
            fail(f"(c) rank {r} launched B7 {fused} times, not 96 (the column slices)")
        want = {"fwd_lse": 47, "bwd_dq": 24, "bwd_dkv": 24}
        if any({k: c[k] for k in want} != want for c in tp["step"]["launches"]):
            fail(f"(b) rank {r} launched {tp['step']['launches']}, expected {want} a step")
    print(json.dumps({"tensor_parallel_ab": result}), flush=True)

    # (e): the sharded artifacts phase 20's ranks exported, loaded and ran, and
    # (e3)'s server; then (d)'s, long since ready
    result["e"] = sharded_artifacts_full_width(d, tok, parallel, servers["e3"])
    result["d"] = _tp_serve(d, root, servers["d"])
    print(json.dumps({"tensor_parallel_d": result["d"]}), flush=True)

    # the kernels at a rank's shapes, every server stopped: B1 and B3/B4/B5 at
    # H = 8, B7 on column slices
    gen = torch.Generator(device="cuda").manual_seed(21)
    frames = 999  # a 20 s utterance's frames, padded to 1024
    result["kernels_h8"] = {
        "b1": {str(dt).replace("torch.", ""): kernel_vs_plain(FA, 1024, dt, gen, B=TP_B,
                                                              valid=frames, H=TP_H)
               for dt in (torch.float32, torch.bfloat16)},
        "training": {str(dt).replace("torch.", ""): training_kernels_vs_plain(
            FA, 1024, dt, gen, timed=True, B=TP_B, valid=frames, H=TP_H)
            for dt in (torch.float32, torch.bfloat16)}}
    result["b7_column_slices"] = {
        f"{din}x{dout}": int8_matmul_vs_plain(Q, TP_B * 1024, din, dout, torch.float32, True,
                                               gen, timed=True)
        for din, dout in ((1024, 512), (1024, 2048))}
    torch.cuda.empty_cache()

    result["phase_s"] = time.time() - t_phase
    return result


# ---------------------------------------------- phase 22: the offline workflow
# (a): a Common Voice-style dump of OFFLINE_CLIPS 48 kHz clips a split; (c): the
# three splits of phase 18's corpus, B1 24 times a batch of optim.batch_size
OFFLINE_SENTENCES = ("我們可以一起交流", "台灣的高速公路很大", "我們在台灣交流", "高速公路可以交流",
                     "我們的交流道很大", "沒有問題可以交流", "一個大的交流道", "我們有一個問題")
OFFLINE_CLIPS = 6
OFFLINE_VARIANTS = ("fp", "int8", "int8_fused", "pcm16", "mulaw8")
OFFLINE_SWEEP_TRIALS, OFFLINE_SWEEP_STEPS = 2, 2


def _offline_dump(d: str) -> dict:
    """data/raw/cv-synth/zh-TW/ under `d`: OFFLINE_CLIPS clips of 1-3 s at
    48 kHz a split (train, dev, test) under sentences of 4-9 of 24
    ideographs; in train a sentence twice, and one again with punctuation
    (both removed as exact duplicates), in test one clip's audio twice
    (removed by its hash); returns {split: [(clip, sentence)]}."""
    from fddm_asr_tpu_torch.data.audio_io import save_wav

    lang = os.path.join(d, "data", "raw", "cv-synth", "zh-TW")
    os.makedirs(os.path.join(lang, "clips"))
    rng = np.random.default_rng(22)
    rows, seed = {}, 400
    for split in ("train", "dev", "test"):
        lines = []
        for i in range(OFFLINE_CLIPS):
            name = f"{split}_{i}.wav"
            wav = synthetic_audio(1, 1.0 + seed % 3, seed=seed)[0]
            save_wav(os.path.join(lang, "clips", name),
                     np.interp(np.arange(3 * wav.size) / 3.0, np.arange(wav.size), wav), 48000)
            seed += 1
            lines.append((name, "".join(chr(0x4E00 + int(j))
                                        for j in rng.integers(0, 24, rng.integers(4, 10)))))
        if split == "train":
            lines[1] = (lines[1][0], lines[0][1])
            lines[3] = (lines[3][0], lines[2][1] + "!")
        if split == "test":
            shutil.copy(os.path.join(lang, "clips", lines[4][0]),
                        os.path.join(lang, "clips", lines[5][0]))
        rows[split] = lines
        with open(os.path.join(lang, f"{split}.tsv"), "w", encoding="utf-8") as f:
            f.write("client_id\tpath\tsentence\n"
                    + "".join(f"c{i}\t{p}\t{s}\n" for i, (p, s) in enumerate(lines)))
    return rows


def _module_process(args: list, cwd: str, tag: str) -> tuple:
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": root})
    if proc.returncode != 0:
        fail(f"{tag}: `python3 -m {args[0]}` exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc, time.time() - t0


def offline_full_width(d: str, card: str, trained: dict) -> dict:
    """Phase 22 (module docstring): the offline workflow and the user
    scripts on the card.  `d` holds phase 15's tokenizer and phase 18's
    corpus, configs, feature cache and checkpoints; `trained` is phase 18's
    result."""
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.config import load_config
    from fddm_asr_tpu_torch.convert import load_reference_checkpoint
    from fddm_asr_tpu_torch.data.feature_cache import FeatureCache
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.scripts import average_checkpoints as AVG
    from fddm_asr_tpu_torch.scripts import init_random_ckpt as INIT
    from fddm_asr_tpu_torch.scripts import precompute_features as PRE
    from fddm_asr_tpu_torch.scripts import sweep as SWEEP
    from fddm_asr_tpu_torch.scripts import validate_quant as VQ
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    wrappers = port_kernel_wrappers()
    result = {"card": card}
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()

    # (a) preprocess a dump, then train a tokenizer on its manifests: host work
    a_dir = os.path.join(d, "offline")
    rows = _offline_dump(a_dir)
    _, pre_s = _module_process(["fddm_asr_tpu_torch.scripts.preprocess", "--auto_merge",
                                "--splits", "train,dev,test", "--enable_audio_hash"],
                               a_dir, "(a) preprocess")
    processed = os.path.join(a_dir, "data", "processed")
    manifests = {}
    for split in rows:
        with open(os.path.join(processed, f"{split}.json"), encoding="utf-8") as f:
            manifests[split] = json.load(f)
    with open(os.path.join(processed, "merge_report.json"), encoding="utf-8") as f:
        report = json.load(f)["global_statistics"]
    kept = {s: len(m) for s, m in manifests.items()}
    reasons = sorted(x["reason"] for x in report["duplicates_detail"])
    if (kept != {"train": OFFLINE_CLIPS - 2, "dev": OFFLINE_CLIPS, "test": OFFLINE_CLIPS - 1}
            or reasons != ["exact text match"] * 2 + ["identical audio hash"]
            or any(not 1.0 <= r["duration"] <= 3.0 for m in manifests.values() for r in m)
            or any(_wav_rate(os.path.join(a_dir, r["processed_path"])) != 16000
                   for m in manifests.values() for r in m)):
        fail(f"(a) preprocess kept {kept} clips, removed {reasons}")
    tok_cfg = os.path.join(a_dir, "tokenizer.yaml")
    with open(tok_cfg, "w", encoding="utf-8") as f:
        json.dump({"corpus": {"lang_prefix": "zh", "base_path": processed, "text_field": "text",
                              "min_len": 1},
                   "tokenizer": {"model_prefix": "spm_offline", "vocab_size": 40},
                   "output": {"dir": os.path.join(a_dir, "tok")}}, f)
    _, tok_s = _module_process(["fddm_asr_tpu_torch.scripts.tokenizer_train", "--config",
                                tok_cfg], a_dir, "(a) tokenizer_train")
    tok = load_tokenizer(os.path.join(a_dir, "tok", "spm_offline.model"))
    text = manifests["test"][0]["text"]
    if tok.vocab_size() > 40 or tok.decode(tok.encode(text)) != text:
        fail(f"(a) the trained tokenizer ({tok.vocab_size()} pieces) does not round-trip {text!r}")
    result["a"] = {"preprocess_process_s": pre_s, "tokenizer_train_process_s": tok_s,
                   "clips_kept": kept,
                   "duplicates_removed": report["duplicates_removed"],
                   "tokenizer_pieces": tok.vocab_size()}
    print(json.dumps({"offline_a": result["a"]}), flush=True)

    # (b) a random-init checkpoint of the flagship config; a pipeline from it
    # against the in-process pipeline with the same state, on phase 4's batch
    base_cfg = os.path.join(root, "configs", "fddm_zhTW_base.yaml")
    b_dir = os.path.join(d, "random_init")
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        INIT.main(["--config", base_cfg, "--out", os.path.join(b_dir, "random.pt"),
                   "--make-tokenizer"])
    init_s = time.time() - t0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    cfg = load_config(base_cfg)
    tok = load_tokenizer(line["tokenizer"])
    dtype = cfg.optim.get("dtype", cfg.model.get("dtype"))
    wav = synthetic_audio(8, 20.0, seed=0)
    sampling = dict(T_infer=20, r=5, greedy=True, posterior_mode="map", sampling_mode="exact")

    def ids_of(pipe):
        gen = torch.Generator(device="cuda").manual_seed(0)
        _reset(wrappers)
        rows_ = pipe.transcribe_with_ids(wav, seq_len=64, generator=gen, **sampling)
        torch.cuda.synchronize()
        return [r[1] for r in rows_], _counts_since_reset(wrappers)

    loaded = FDDMPipeline.from_config(cfg, ckpt_path=line["out"], tokenizer=tok, dtype=dtype)
    got, launches = ids_of(loaded)
    del loaded
    want, _ = ids_of(TL.training_pipeline(cfg, tokenizer=tok))
    result["b"] = {"init_s": init_s, "params": line["params"], "bytes": line["bytes"],
                   "ids_equal_in_process": got == want, "launches": launches}
    print(json.dumps({"offline_b": result["b"]}), flush=True)
    if got != want or len(got) != 8 or tok.vocab_size() != 8000:
        fail("(b) the random-init .pt's pipeline gives other ids than the in-process one")
    if launches["fwd"] != 24 or any(n for k, n in launches.items() if k != "fwd"):
        fail(f"(b) kernel launches in the transcribe {launches}, expected B1 24")

    # (c) the feature cache at WavLM-large width on phase 18's corpus
    cfg_a = os.path.join(d, "a.yaml")
    acfg = load_config(cfg_a)
    batch = int(acfg.optim.batch_size)
    gc.collect()
    torch.cuda.empty_cache()
    _reset(wrappers)
    t0 = time.time()
    cached = PRE.main(["--config", cfg_a, "--cache-dir", os.path.join(d, "feats22"),
                       "--splits", "train,validation,test"])
    torch.cuda.synchronize()
    pre_s = time.time() - t0
    launches = _counts_since_reset(wrappers)
    n_batches = sum(-(-n // batch) for _, n in TRAIN_SPLITS)
    mine, built_by_run = (FeatureCache(os.path.join(d, name), "train")
                          for name in ("feats22", "feats"))
    a = np.asarray(mine.rows(range(mine.shape[0])).float())
    b = np.asarray(built_by_run.rows(range(built_by_run.shape[0])).float())
    close = within_tol(torch.from_numpy(a - b).abs(), torch.from_numpy(b), torch.bfloat16) <= 1
    pipe = TL.training_pipeline(acfg, tokenizer=load_tokenizer(acfg.data.tokenizer_path))
    _, rebuilt = TL._ensure_feature_cache(
        pipe, TL.training_dataset(acfg, acfg.data.train_json, pipe.tokenizer),
        os.path.join(d, "feats22"), "train", batch, acfg.data.train_json)
    del pipe
    clips = sum(n for _, n in TRAIN_SPLITS)
    result["c"] = {
        "seconds": pre_s, "splits": cached, "launches": {k: n for k, n in launches.items() if n},
        "batches": n_batches, "seconds_per_clip": pre_s / clips,
        "phase18a_cache_seconds_per_train_clip":
            trained["a"]["feature_cache"]["seconds"] / TRAIN_SPLITS[0][1],
        "meta_equal_run_trainings": mine.meta == built_by_run.meta,
        "bits_equal_run_trainings": bool(np.array_equal(a, b)),
        "max_abs_diff_run_trainings": float(np.abs(a - b).max()),
        "run_training_rebuilt": rebuilt}
    print(json.dumps({"offline_c": result["c"]}), flush=True)
    if launches["fwd"] != 24 * n_batches or any(n for k, n in launches.items() if k != "fwd"):
        fail(f"(c) kernel launches {launches}, expected B1 {24 * n_batches}")
    if not mine.meta == built_by_run.meta or not bool(close.all()) or rebuilt:
        fail(f"(c) the precomputed cache is not the one run_training builds: {result['c']}")

    # (d) the mean of phase 18 (a)'s epoch checkpoints, loaded by the pipeline
    ckpt_dir = os.path.join(d, "ckpt_a")
    avg = os.path.join(d, "avg.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        AVG.main(["--last", "2", "--ckpt-dir", ckpt_dir, "--out", avg])
    inputs = [load_reference_checkpoint(os.path.join(ckpt_dir, f"ep00{i}.pt")) for i in (1, 2)]
    mean = load_reference_checkpoint(avg)
    worst = 0
    for key in ("decoder", "s_proj", "t_embed", "t_proj"):
        for name, t in mean[key].items():
            want_t = (sum(ck[key][name].double() for ck in inputs) / 2).to(t.dtype)
            worst += int(not torch.equal(t, want_t))
    moved = not torch.equal(inputs[0]["decoder"]["head.weight"],
                            inputs[1]["decoder"]["head.weight"])
    pipe = FDDMPipeline.from_config(acfg, ckpt_path=avg, tokenizer=load_tokenizer(
        acfg.data.tokenizer_path))
    ids, _ = ids_of(pipe)
    del pipe
    result["d"] = {"tensors_not_the_mean": worst, "epochs": [mean["epoch"], mean["step"]],
                   "inputs_differ": moved, "transcribed_rows": len(ids)}
    print(json.dumps({"offline_d": result["d"]}), flush=True)
    if worst or not moved or mean["epoch"] != 2 or len(ids) != 8:
        fail(f"(d) the averaged checkpoint is not the float64 mean of its inputs: {result['d']}")

    # (e) the int8 gate on phase 18 (b)'s best model, over the 16 test clips
    cfg_b = load_config(os.path.join(d, "b.yaml"))
    best = os.path.join(d, "ckpt_b", "best_model")
    encoder = torch.load(best + ".encoder.pt", map_location="cpu", weights_only=True)
    with open(cfg_b.data.test_json, encoding="utf-8") as f:
        test_records = json.load(f)
    per_variant = {}

    def count(name, _):
        per_variant[name] = _counts_since_reset(wrappers)  # from the previous variant's start
        _reset(wrappers)

    gc.collect()
    torch.cuda.empty_cache()
    seq_len = int(cfg_b.data.max_len)
    T_infer, r = int(cfg_b.inference.get("T_infer", 20)), int(cfg_b.inference.get("r", 5))
    t0 = time.time()
    _reset(wrappers)
    gate, variants = VQ.validate(cfg_b, best + ".pt", test_records, list(OFFLINE_VARIANTS),
                                 seq_len, T_infer, r,
                                 tokenizer=load_tokenizer(cfg_b.data.tokenizer_path),
                                 encoder_state_dict=encoder, on_variant=count)
    torch.cuda.synchronize()
    vq_s = time.time() - t0
    per_variant["end"] = _counts_since_reset(wrappers)
    names = list(OFFLINE_VARIANTS)
    launches = {n: {k: c for k, c in per_variant[nxt].items() if c}
                for n, nxt in zip(names, names[1:] + ["end"])}
    batch_e, lengths, _ = VQ.load_batch(test_records)
    pipe = FDDMPipeline.from_config(cfg_b, ckpt_path=best + ".pt", encoder_state_dict=encoder,
                                    tokenizer=load_tokenizer(cfg_b.data.tokenizer_path))
    texts = pipe.transcribe(batch_e, lengths, seq_len=seq_len, T_infer=T_infer, r=r, greedy=True)
    del pipe
    result["e"] = {"seconds": vq_s, "launches": launches,
                   "fp_texts_equal_in_process": texts == variants["fp"]["texts"],
                   # the gate's report, its disagreements counted (their texts
                   # are 128-id transcripts)
                   "report": {**{k: v for k, v in gate.items() if k != "disagreements"},
                              "disagreements_listed": len(gate["disagreements"])}}
    print(json.dumps({"offline_e": result["e"]}), flush=True)
    for n in names:
        want = {"fwd": 24, **({"int8_matmul_fused": 144} if n == "int8_fused" else {})}
        if launches[n] != want:
            fail(f"(e) {n}: kernel launches {launches[n]}, expected {want}")
    if texts != variants["fp"]["texts"] or gate["n"] != len(test_records):
        fail("(e) validate_quant's fp texts differ from the in-process pipeline's")

    # (f) a sweep of two trials over phase 18 (a)'s config and feature cache
    # (evaluated on 4 validation clips, no test set: one decode batch a trial)
    val4 = os.path.join(d, "validation4.json")
    with open(val4, "w", encoding="utf-8") as f:
        json.dump(trained["corpus"]["records"]["validation"][:4], f, ensure_ascii=False)
    sweep = os.path.join(d, "sweep.yaml")
    with open(sweep, "w", encoding="utf-8") as f:
        json.dump({"base_config": cfg_a,
                   "data": {"val_json": val4, "test_json": os.path.join(d, "no_test_set.json")},
                   "optim": {"lr": {"distribution": "log_uniform", "min": 1e-4, "max": 1e-3}}},
                  f)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        SWEEP.main(["--sweep", sweep, "--trials", str(OFFLINE_SWEEP_TRIALS), "--epochs", "1",
                    "--max-steps-per-epoch", str(OFFLINE_SWEEP_STEPS), "--out",
                    os.path.join(d, "sweep")])
    logging.getLogger().handlers.clear()
    sweep_s = time.time() - t0
    with open(os.path.join(d, "sweep", "summary.json")) as f:
        summary = json.load(f)
    trials = []
    for i in range(OFFLINE_SWEEP_TRIALS):
        records = _metrics(os.path.join(d, "sweep", f"trial_{i:03d}", "ckpts"))
        steps = [x["step"] for x in records if x["kind"] == "step"]
        cache = [x for x in records if x["kind"] == "feature_cache"]
        trials.append({"steps": steps, "cache_built": [x["built"] for x in cache]})
    result["f"] = {"seconds": sweep_s, "trials": trials,
                   "ranked": [(s["trial"], s.get("best_val_cer"), s.get("error"))
                              for s in summary]}
    print(json.dumps({"offline_f": result["f"]}), flush=True)
    if (len(summary) != OFFLINE_SWEEP_TRIALS or any(s.get("error") for s in summary)
            or any(s.get("best_val_cer") is None for s in summary)
            or any(t["steps"] != list(range(1, OFFLINE_SWEEP_STEPS + 1))
                   or t["cache_built"] != [False] for t in trials)):
        fail(f"(f) the sweep's trials: {result['f']}")
    result["seconds"] = time.time() - t_phase
    print(json.dumps({"offline": {"card": card, "seconds": result["seconds"]}}), flush=True)
    return result


# ------------------------------------------ phase 23: host tools and profilers
HOST_TOOLS_TOP = 10
# (d): bench_train's three runs (--no-dropout: with WavLM's attention_dropout
# 0.1 a training step takes the plain attention, as the JAX package's does,
# and launches no kernel)
BENCH_TRAIN_RUNS = (("base_lfd", ["--lfd"]), ("finetune", ["--finetune", "--no-dropout"]),
                    ("paper_lfd", ["--model", "paper", "--lfd"]))
STREAM_CLIENT_SECONDS, STREAM_CLIENT_WINDOW_S = 20.0, 5.0
# WavLM-large's attention layers: B1 a transcribe; B3/B4/B5 a fine-tune step
# (the backward's remat recomputes 23 of the 24 forwards)
WAVLM_LARGE_LAYERS = 24
FINETUNE_STEP_LAUNCHES = {"fwd_lse": 2 * WAVLM_LARGE_LAYERS - 1, "bwd_dq": WAVLM_LARGE_LAYERS,
                          "bwd_dkv": WAVLM_LARGE_LAYERS}


def stream_client_work(d: str):
    """(f)'s `work(url)` for phase 16 (e)'s serve process: a 20 s clip,
    written into `d`, streamed by `stream_client.main` in this process at
    --pace 0 in 5 s windows; its seconds, NDJSON lines, timing summary and
    final."""
    from fddm_asr_tpu_torch.data.audio_io import save_wav
    from fddm_asr_tpu_torch.scripts import stream_client

    clip = os.path.join(d, "stream20.wav")
    save_wav(clip, synthetic_audio(1, STREAM_CLIENT_SECONDS, seed=2300)[0], 16000)

    def stream(url):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            final = stream_client.main(["--url", url, "--wav", clip, "--pace", "0",
                                        "--window-seconds", str(STREAM_CLIENT_WINDOW_S)])
        lines = [json.loads(x) for x in out.getvalue().splitlines()]
        return {"seconds": time.time() - t0, "lines": len(lines),
                "summary": json.loads(err.getvalue().strip().splitlines()[-1]),
                "final_is_last_line": lines[-1] == final, "final_chunks": len(final.get(
                    "chunks", [])), "final_text": final.get("text", "")[:16]}

    return stream


def _json_line(stdout: str, key: str = None) -> dict:
    """The last line of `stdout` that is a JSON object (holding `key`)."""
    for line in reversed(stdout.splitlines()):
        if line.startswith("{") and (key is None or f'"{key}"' in line):
            return json.loads(line)
    fail(f"no JSON line{f' with {key}' if key else ''} in:\n{stdout[-2000:]}")


def _listing(stdout: str) -> list:
    """The track headers and op lines of `profiling.print_listing`."""
    return [ln for ln in stdout.splitlines() if ln.startswith("== track") or " ms  " in ln]


def host_tools_full_width(d: str, card: str, served: dict, trained: dict) -> dict:
    """Phase 23 (module docstring): the host tools and profilers
    (`fddm_asr_tpu_torch.scripts`) at full width.  `d` holds phase 15's
    decoder `.pt`, tokenizer and HF WavLM-large and phase 18's corpus,
    checkpoints and log; `served` is phase 16's result (its (e) ran (f)'s
    stream), `trained` phase 18's."""
    from fddm_asr_tpu_torch.scripts import (convergence_report, inspect_transcripts,
                                            make_longform, sanity_check_scheduler,
                                            sanity_forward)

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.time()
    wrappers = port_kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()  # the subprocesses need the memory this process has cached
    result, seconds = {"card": card}, {}

    def module(tag, args):
        proc, s = _module_process([f"fddm_asr_tpu_torch.scripts.{args[0]}", *args[1:]], root,
                                  f"23 {tag}")
        seconds[tag] = s
        return proc

    # (a) profile_step at 8 x 20 s, one transcribe traced
    proc = module("a_profile_step", ["profile_step", "--batch", "8", "--iters", "1", "--top",
                                     str(HOST_TOOLS_TOP), "--out", os.path.join(d, "trace_step")])
    a = _json_line(proc.stdout, "profile_step")["profile_step"]
    if a["launches"] != {"fwd": WAVLM_LARGE_LAYERS}:
        fail(f"(a) kernel launches a transcribe {a['launches']}, expected "
             f"{{'fwd': {WAVLM_LARGE_LAYERS}}}")
    if "device_busy_ms" not in a:
        fail("(a) the profiler saw no device event")
    a["listing"] = _listing(proc.stdout)
    result["a"] = a
    print(json.dumps({"host_tools_a": a}), flush=True)

    # (b) profile_finetune: B3 47, B4 24, B5 24 a step
    proc = module("b_profile_finetune", ["profile_finetune", "--batch", "8", "--iters", "1",
                                         "--no-dropout", "--top", str(HOST_TOOLS_TOP),
                                         "--out", os.path.join(d, "trace_ft")])
    b = _json_line(proc.stdout, "profile_finetune")["profile_finetune"]
    if b["launches"] != FINETUNE_STEP_LAUNCHES:
        fail(f"(b) kernel launches a step {b['launches']}, expected {FINETUNE_STEP_LAUNCHES}")
    b["losses"] = [float(ln.split()[1]) for ln in proc.stdout.splitlines()
                   if ln.startswith("loss ")]
    if not b["losses"] or not all(np.isfinite(b["losses"])):
        fail(f"(b) fine-tune losses {b['losses']}")
    b["listing"] = _listing(proc.stdout)
    result["b"] = b
    print(json.dumps({"host_tools_b": b}), flush=True)

    # (c) profile_frontend --per-layer at its defaults (16 x 20 s)
    proc = module("c_profile_frontend", ["profile_frontend", "--per-layer"])
    c = {}
    for ln in proc.stdout.splitlines():
        m = re.match(r"^(\S.*?)\s+([\d.]+) ms(?:  max\|Δ\|=(\S+) mean\|Δ\|=(\S+))?$", ln)
        if m:
            c[m.group(1)] = {"ms": float(m.group(2)), **(
                {"max_abs_diff": float(m.group(3)), "mean_abs_diff": float(m.group(4))}
                if m.group(3) else {})}
    c["per_layer"] = [ln.strip() for ln in proc.stdout.splitlines() if ln.startswith("  conv")]
    missing = {"dispatch_overhead", "mm_frontend_erf", "mm_frontend_tanh", "conv_only",
               "conv_gelu_only", "f32stats_erf (current)", "f32stats_tanh", "bf16stats_erf",
               "bf16stats_tanh"} - set(c)
    if missing or len(c["per_layer"]) != 7:
        fail(f"(c) profile_frontend printed no {sorted(missing)} or not 7 layers:\n"
             f"{proc.stdout[-2000:]}")
    result["c"] = c
    print(json.dumps({"host_tools_c": c}, ensure_ascii=False), flush=True)

    # (d) bench_train: base frozen, fine-tune, the 253 M scanned decoder
    result["d"] = {}
    for tag, flags in BENCH_TRAIN_RUNS:
        proc = module(f"d_bench_train_{tag}", ["bench_train", *flags])
        line = _json_line(proc.stdout, "metric")
        want = FINETUNE_STEP_LAUNCHES if "--finetune" in flags else {"fwd": WAVLM_LARGE_LAYERS}
        if line["kernel_launches_per_step"] != want:
            fail(f"(d) bench_train {flags}: kernel launches a step "
                 f"{line['kernel_launches_per_step']}, expected {want}")
        if not (line["mfu_pct"] is not None and 0 < line["mfu_pct"] < 100):
            fail(f"(d) bench_train {flags}: mfu_pct {line['mfu_pct']}, expected in (0, 100)")
        if line["platform"] != "cuda" or not line["value"] > 0:
            fail(f"(d) bench_train {flags}: {line}")
        result["d"][tag] = line
        print(json.dumps({f"host_tools_d_{tag}": line}), flush=True)
    if not 240e6 < result["d"]["paper_lfd"]["decoder_params"] < 270e6:
        fail(f"(d) the paper decoder has {result['d']['paper_lfd']['decoder_params']} parameters")

    # (e) bench_serve on phase 15's decoder, then its streaming mode
    serve_args = ["--config", os.path.join(root, CLI_MAIN_CONFIG),
                  "--ckpt", os.path.join(d, "decoder.pt"),
                  "--tokenizer", os.path.join(d, "spm_synth.vocab")]
    result["e"] = {}
    for tag, flags in (("http", ["--concurrency", "8", "--duration-s", "2", "--audio-seconds",
                                 "10"]),
                       ("stream", ["--stream", "--duration-s", "2"])):
        proc = module(f"e_bench_serve_{tag}", ["bench_serve", *serve_args, *flags])
        line = _json_line(proc.stdout, "metric")
        answered = line["streams"] if tag == "stream" else line["requests"]
        if line["errors"] != 0 or not answered > 0 or line["platform"] != "cuda":
            fail(f"(e) bench_serve {flags}: {line}")
        result["e"][tag] = line
        print(json.dumps({f"host_tools_e_{tag}": line}), flush=True)

    # (f) stream_client, run against phase 16 (e)'s serve process
    f = served["process"]["work"]
    seconds["f_stream_client"] = f["seconds"]
    if not (f["summary"]["partials"] >= 1 and f["final_is_last_line"]
            and f["final_chunks"] == f["summary"]["partials"]):
        fail(f"(f) stream_client: {f}")
    result["f"] = f
    print(json.dumps({"host_tools_f": f}, ensure_ascii=False), flush=True)

    # (g) the host tools in this process
    g, t0 = {}, time.time()
    manifests = trained["corpus"]["manifests"]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        g["make_longform"] = make_longform.main(["--manifest", manifests["test"], "--out",
                                                 os.path.join(d, "long1min.wav"),
                                                 "--minutes", "1"])
    seconds["g_make_longform"] = time.time() - t0
    if not (0 < g["make_longform"]["seconds"] <= 60 and g["make_longform"]["clips"] >= 1):
        fail(f"(g) make_longform: {g['make_longform']}")
    b_dir = trained["b"]["ckpt_dir"]
    _reset(wrappers)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        summary = inspect_transcripts.main([
            "--config", trained["b"]["config"], "--ckpt", os.path.join(b_dir, "best_model.pt"),
            "--encoder-ckpt", os.path.join(b_dir, "best_model.encoder.pt"), "--n", "8",
            "--json", os.path.join(d, "inspect.json")])
        torch.cuda.synchronize()
    seconds["g_inspect_transcripts"] = time.time() - t0
    launches = {k: n for k, n in _counts_since_reset(wrappers).items() if n}
    if launches != {"fwd": WAVLM_LARGE_LAYERS} or summary["n"] != 8:
        fail(f"(g) inspect_transcripts: launches {launches}, summary {summary}")
    g["inspect_transcripts"] = {"summary": summary, "launches": launches,
                                "rows_printed": buf.getvalue().count("| hyp:")}
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        g["convergence_report"] = convergence_report.main([
            "--log", trained["b"]["log_file"], "--out", os.path.join(d, "convergence.json"),
            "--config", trained["b"]["config"]])
    seconds["g_convergence_report"] = time.time() - t0
    if g["convergence_report"]["epochs"] != 1:
        fail(f"(g) convergence_report: {g['convergence_report']}")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        sanity_check_scheduler.main([os.path.join(root, CLI_MAIN_CONFIG)])
    seconds["g_sanity_check_scheduler"] = time.time() - t0
    g["sanity_check_scheduler"] = buf.getvalue().strip()
    _reset(wrappers)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        logits, loss_fd = sanity_forward.main([])
        torch.cuda.synchronize()
    seconds["g_sanity_forward"] = time.time() - t0
    launches = {k: n for k, n in _counts_since_reset(wrappers).items() if n}
    g["sanity_forward"] = {"printed": buf.getvalue().strip().splitlines(),
                           "logits": list(logits.shape), "loss_fd": float(loss_fd),
                           "launches": launches}
    if launches != {"fwd": WAVLM_LARGE_LAYERS} or "Sanity check passed." not in buf.getvalue():
        fail(f"(g) sanity_forward: {g['sanity_forward']}")
    del logits, loss_fd
    result["g"] = g
    print(json.dumps({"host_tools_g": g}, ensure_ascii=False), flush=True)
    result["seconds_by_script"] = seconds
    result["seconds"] = time.time() - t_phase
    print(json.dumps({"host_tools": {"seconds": result["seconds"],
                                     "seconds_by_script": seconds}}), flush=True)
    return result


def _wav_rate(path: str) -> int:
    with wave.open(path) as w:
        return w.getframerate()


def b7_times(root: str) -> int:
    """`--b7-times ROOT`: the fused int8 kernel of the port in the checkout
    at ROOT (this one or another, to compare two trees on one card), timed
    alone at phase 8's bfloat16 shapes with bias: CUDA events over
    back-to-back calls (as phase 8's `ms`), device time per launch by
    torch.profiler and the wrapper's host time a call, one JSON line a
    shape, then the card line."""
    sys.path.insert(0, os.path.abspath(root))
    from fddm_asr_tpu_torch.ops import _build
    from fddm_asr_tpu_torch.ops import quant as Q

    _build.build_libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M in (8192, 1024):
        for din, dout in WAVLM_DENSE_SHAPES:
            x = torch.randn(M, din, device="cuda", generator=gen).bfloat16()
            weight = (torch.rand(dout, din, device="cuda", generator=gen) * 2 - 1) / din ** 0.5
            bias = torch.randn(dout, device="cuda", generator=gen)
            wq, sw = Q.quantized_weight({}, "w", weight)
            call = lambda: Q.int8_matmul_fused_cuda(x, wq, sw, bias, torch.bfloat16)  # noqa: E731
            ms = time_ms(call, 20)
            dev_ms = device_ms(call, 20, "int8_matmul_fused_kernel")
            host_us = float("inf")
            for _ in range(5):  # the host's time a call, the least of five runs of 100
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    call()
                host_us = min(host_us, (time.perf_counter() - t0) / 100 * 1e6)
            torch.cuda.synchronize()
            print(json.dumps({"b7_times": {"root": root, "M": M, "din": din, "dout": dout,
                                               "ms": ms, "device_ms": dev_ms,
                                               "host_us": host_us}}), flush=True)
    print(card_line())
    return 0


def b8_times(root: str, dtype=torch.bfloat16) -> int:
    """`--b8-times ROOT` (bfloat16) and `--b8-f32-times ROOT` (float32): the
    fused conv layer of the port in the checkout at ROOT (this one or
    another, to compare two trees on one card), timed alone at phase 9's
    six layer shapes, in bfloat16 with tanh GELU, in float32 with erf and
    with tanh: its `models/wavlm.ConvLayer` (fused, float32 parameters, as
    the transcribe runs it), so each tree's weight handling is in the time.
    CUDA events over back-to-back calls (five runs of 20: each run and
    their median), device time per launch by torch.profiler of whichever
    B8 kernel the tree launched (named) and the host's time a call (the
    least of five runs of 20), one JSON line a shape, then the card
    line."""
    sys.path.insert(0, os.path.abspath(root))
    from fddm_asr_tpu_torch.models.wavlm import ConvLayer
    from fddm_asr_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = dtype == torch.float32
    tag = "b8_f32_times" if f32 else "b8_times"
    for (T, k, s), gelu_tanh in [(shape, tanh) for shape in FRONTEND_LAYERS
                                 for tanh in ((False, True) if f32 else (True,))]:
        x, weight, b, ln_scale, ln_bias = conv_inputs(T, k, dtype, gen)
        layer = ConvLayer(512, 512, k, s, True, "layer", 1e-5, gelu_tanh, fused=True).cuda()
        with torch.no_grad():
            for p, v in ((layer.conv.weight, weight), (layer.conv.bias, b),
                         (layer.layer_norm.weight, ln_scale), (layer.layer_norm.bias, ln_bias)):
                p.copy_(v)
            call = lambda: layer(x, dtype, channels_last=True)  # noqa: E731
            runs = [time_ms(call, 20) for _ in range(5)]
            names = list(device_ms_by_kernel(call, 20, "conv_ln_gelu"))
            if len(names) != 1:
                fail(f"{tag}: expected one B8 kernel in the profile, got {names}")
            kernel_name = names[0]
            dev_ms = device_ms(call, 20, kernel_name)
            host_us = float("inf")
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    call()
                host_us = min(host_us, (time.perf_counter() - t0) / 20 * 1e6)
            torch.cuda.synchronize()
        print(json.dumps({tag: {"root": root, "T": T, "k": k, "s": s,
                                "gelu": "tanh" if gelu_tanh else "erf",
                                "ms": statistics.median(runs), "ms_runs": runs,
                                "kernel": kernel_name, "device_ms": dev_ms,
                                "host_us": host_us}}), flush=True)
        del x, layer
        torch.cuda.empty_cache()
    print(card_line())
    return 0


def b1_f32_times(root: str) -> int:
    """`--b1-f32-times ROOT`: the float32 forward of the port in the checkout
    at ROOT (this one or another, to compare two trees on one card), timed
    alone at phase 2's float32 shapes (B=8, L=1024 and 4224 with ragged
    masks; B=1, L=5120, 4999 valid keys; phase 16's two served batches) and
    at a transcribe's (B=8, L=1024, 999 valid keys in every row),
    inputs from a seeded generator, the same in every tree: CUDA events
    over back-to-back calls (five runs, each and their median), one JSON
    line a shape, then the card line."""
    sys.path.insert(0, os.path.abspath(root))
    from fddm_asr_tpu_torch.ops import _build
    from fddm_asr_tpu_torch.ops import flash_attention as FA

    _build.build_libraries()
    shapes = [(8, 1024, None), (8, 4224, None), (1, WHOLE_FILE_L, WHOLE_FILE_FRAMES),
              (8, 1024, 999)]  # the last: phase 4's transcribe (8 x 20 s, 999 frames)
    shapes += [(B, L, valid) for (B, L), valid in served_valid_frames().items()]
    for B, L, valid in shapes:
        gen = torch.Generator(device="cuda").manual_seed(L + B)
        q, k, v, bias, gate, mask = attention_inputs(B, L, 16, torch.float32, gen, valid=valid)
        call = lambda: FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, 16)  # noqa: E731
        reps = 20 if L <= 1024 else 5
        runs = [time_ms(call, reps) for _ in range(5)]
        print(json.dumps({"b1_f32_times": {"root": root, "B": B, "L": L, "valid": valid,
                                           "ms": statistics.median(runs), "ms_runs": runs}}),
              flush=True)
        del q, k, v, bias, gate, mask
        torch.cuda.empty_cache()
    print(card_line())
    return 0


def backward_f32_times(root: str, which: str) -> int:
    """`--b5-f32-times ROOT` (`which` "bwd_dkv": dk, dv, dbias) and
    `--b4-f32-times ROOT` ("bwd_dq": dq, dgate): that float32 backward
    kernel of the port in the checkout at ROOT (this one or another, to
    compare two trees on one card), timed alone at phase 5's float32 shape
    (B=8, L=1024, ragged masks), the fine-tune's (B=32, L=1024, 999 valid
    keys in every row) and B=3, L=203 (ragged), on lse from the tree's own
    B3 and the plain delta; inputs from a seeded generator, the same in
    every tree: CUDA events over back-to-back calls (five runs, each and
    their median) and each kernel's device time a call (torch.profiler),
    one JSON line a shape, then the card line."""
    sys.path.insert(0, os.path.abspath(root))
    from fddm_asr_tpu_torch.ops import _build
    from fddm_asr_tpu_torch.ops import flash_attention as FA

    _build.build_libraries()
    H = 16
    kernel = getattr(FA, f"wavlm_gated_attention_{which}_cuda")
    tag, name = {"bwd_dkv": ("b5_f32_times", "bwd_d"), "bwd_dq": ("b4_f32_times", "bwd_dq")}[which]
    for B, L, valid in ((8, 1024, None), (FINETUNE_B, 1024, 999), (3, 203, None)):
        gen = torch.Generator(device="cuda").manual_seed(L + B)
        q, k, v, bias, gate, mask = attention_inputs(B, L, H, torch.float32, gen, valid=valid)
        dout = torch.randn(B, L, H * 64, device="cuda", generator=gen)
        out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, H)
        delta = (dout * out).view(B, L, H, 64).sum(-1).transpose(1, 2).contiguous()
        call = lambda: kernel(q, k, v, bias, gate, mask, lse, delta, dout, H)  # noqa: E731
        reps = 20 if B * L <= 8 * 1024 else 5
        runs = [time_ms(call, reps) for _ in range(5)]
        print(json.dumps({tag: {"root": root, "B": B, "L": L, "valid": valid,
                                "ms": statistics.median(runs), "ms_runs": runs,
                                "device_ms_by_kernel": device_ms_by_kernel(call, reps, name)}}),
              flush=True)
        del q, k, v, bias, gate, mask, dout, out, lse, delta
        torch.cuda.empty_cache()
    print(card_line())
    return 0


def _ffma_between_hgmma(function_sass: str) -> int:
    lines = function_sass.splitlines()
    at = [i for i, ln in enumerate(lines) if "HGMMA" in ln]
    return sum(" FFMA " in ln for ln in lines[at[0]:at[-1]]) if at else 0


def sass_hgmma(lib: str, kernel: str) -> dict:
    """The HGMMA instructions of `kernel` in the library's SASS
    (`cuobjdump -sass`): their count, how many name TF32, one example; and
    the FFMA instructions (scalar f32 FMAs): all, and those between a
    function's first and last HGMMA (its tensor-core main loop)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    body = [f for f in sass.split("Function : ") if kernel in f.splitlines()[0]]
    lines = [ln.strip() for f in body for ln in f.splitlines() if "HGMMA" in ln]
    return {"kernel": kernel, "functions": len(body), "hgmma": len(lines),
            "hgmma_tf32": sum("TF32" in ln for ln in lines),
            "ffma": sum(" FFMA " in ln for f in body for ln in f.splitlines()),
            "ffma_between_hgmma": sum(_ffma_between_hgmma(f) for f in body),
            "example": lines[0][:160] if lines else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--b7-times":
        return b7_times(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--b8-times":
        return b8_times(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--b8-f32-times":
        return b8_times(sys.argv[2], torch.float32)
    if len(sys.argv) == 3 and sys.argv[1] == "--b1-f32-times":
        return b1_f32_times(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--b5-f32-times":
        return backward_f32_times(sys.argv[2], "bwd_dkv")
    if len(sys.argv) == 3 and sys.argv[1] == "--b4-f32-times":
        return backward_f32_times(sys.argv[2], "bwd_dq")
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":
        return parallel_rank(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--ring-artifact-rank":
        return ring_artifact_rank(sys.argv[2])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fddm_asr_tpu_torch.ops import _build
    from fddm_asr_tpu_torch.ops import conv_frontend as CF
    from fddm_asr_tpu_torch.ops import flash_attention as FA
    from fddm_asr_tpu_torch.ops import quant as Q

    card = card_line()
    print(f"card: {card}", flush=True)
    t_start, phase_end_s = time.time(), {}

    def mark(phases: str):
        """Seconds from the start to the end of `phases`."""
        phase_end_s[phases] = time.time() - t_start

    t0 = time.time()
    libs = _build.build_libraries(verbose=True)
    print(json.dumps({"build": {"libraries": [os.path.relpath(p) for p in libs.values()],
                                "seconds": time.time() - t0}}), flush=True)
    # the float32 forward is on the tensor cores: tf32 HGMMA in its SASS
    sass = sass_hgmma(libs["gated_attention"], "gated_attention_tf32x3_kernel")
    print(json.dumps({"sass_f32_forward": sass}), flush=True)
    if not (sass["functions"] == 1 and sass["hgmma"] > 0 and sass["hgmma_tf32"] == sass["hgmma"]):
        fail(f"the float32 forward's SASS holds no tf32 HGMMA: {sass}")
    # so is float32 B4
    sass_b4 = sass_hgmma(libs["gated_attention_bwd"], "bwd_dq_tf32x3_kernel")
    print(json.dumps({"sass_f32_b4": sass_b4}), flush=True)
    if not (sass_b4["functions"] == 1 and sass_b4["hgmma"] > 0
            and sass_b4["hgmma_tf32"] == sass_b4["hgmma"]):
        fail(f"float32 B4's SASS holds no tf32 HGMMA only: {sass_b4}")
    # and float32 B5, as two kernels: (a) dk/dv, (b) dbias
    sass_b5 = [sass_hgmma(libs["gated_attention_bwd"], kernel)
               for kernel in ("bwd_dkv_tf32x3_kernel", "bwd_dbias_tf32x3_kernel")]
    print(json.dumps({"sass_f32_b5": sass_b5}), flush=True)
    for sass in sass_b5:
        if not (sass["functions"] == 1 and sass["hgmma"] > 0
                and sass["hgmma_tf32"] == sass["hgmma"]):
            fail(f"float32 B5's SASS holds no tf32 HGMMA only: {sass}")
    # and float32 B8 (erf and tanh builds); the scalar kernel it replaced is
    # gone, and no FFMA lies among its HGMMAs (its FFMAs are the epilogue's;
    # the scalar kernel's unrolled K loop held 1024)
    sass_b8 = sass_hgmma(libs["conv_ln_gelu"], "conv_ln_gelu_tf32x3_kernel")
    sass_b8["scalar_kernel_functions"] = sass_hgmma(libs["conv_ln_gelu"],
                                                    "conv_ln_gelu_f32_kernel")["functions"]
    print(json.dumps({"sass_f32_b8": sass_b8}), flush=True)
    if not (sass_b8["functions"] == 2 and sass_b8["hgmma"] > 0
            and sass_b8["hgmma_tf32"] == sass_b8["hgmma"]
            and sass_b8["scalar_kernel_functions"] == 0 and sass_b8["ffma_between_hgmma"] == 0):
        fail(f"float32 B8's SASS holds no tf32 HGMMA only, or a scalar FMA loop: {sass_b8}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for L in (1024, 4224):
        for dtype in (torch.float32, torch.bfloat16):
            rows[(L, dtype)] = kernel_vs_plain(FA, L, dtype, gen)
    for dtype in (torch.float32, torch.bfloat16):  # phase 15 (c): 100 s whole, 4999 frames
        rows[(WHOLE_FILE_L, dtype)] = kernel_vs_plain(FA, WHOLE_FILE_L, dtype, gen, B=1,
                                                      valid=WHOLE_FILE_FRAMES)
    # phase 16's batches ((c)'s load, (d)'s 30 s windows), from a generator
    # of their own: the inputs of every other check stay as they were
    serve_valid = served_valid_frames()
    serve_gen = torch.Generator(device="cuda").manual_seed(16)
    for (B, L), valid in serve_valid.items():
        for dtype in (torch.float32, torch.bfloat16):
            rows[("serve", B, L, dtype)] = kernel_vs_plain(FA, L, dtype, serve_gen, B=B,
                                                           valid=valid)
    edge_lengths_match_plain(FA, gen)
    mark("1-2")

    with tempfile.TemporaryDirectory() as tmp:
        small_pipeline_matches_cpu(FA, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        result = transcribe_full_width(FA, tmp, card)
    with tempfile.TemporaryDirectory() as tmp:
        transcribe_f32 = transcribe_f32_full_width(tmp, card, result)
    with tempfile.TemporaryDirectory() as tmp:
        transcribe_f32_fused = transcribe_f32_full_width(tmp, card, result,
                                                         unfused=transcribe_f32)
    del transcribe_f32["feats"], transcribe_f32_fused["feats"]
    mark("3-4")

    # the shape phase 7's fine-tune gives the training kernels: B=32
    # utterances of 20 s, 999 frames each, padded to a multiple of 128
    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig

    frames = WavLMConfig.large().feat_extract_output_length(int(16000 * FINETUNE_SECONDS))
    step_L = -(-frames // 128) * 128
    step_row = training_kernels_vs_plain(FA, step_L, torch.bfloat16, gen, timed=True,
                                         B=FINETUNE_B, valid=frames)
    f32_train_rows = {}
    for L in (1024, 384, 203):
        for dtype in (torch.float32, torch.bfloat16):
            row = training_kernels_vs_plain(FA, L, dtype, gen, timed=L == 1024)
            if L == 1024 and dtype == torch.float32:
                f32_train_rows = row
    for L in B4_B5_EDGE_LENGTHS:  # untimed: B4's and B5's tile edges, one batch row and three
        for dtype in (torch.bfloat16, torch.float32):
            training_kernels_vs_plain(FA, L, dtype, gen, timed=False, B=1, valid=L - 3)
            training_kernels_vs_plain(FA, L, dtype, gen, timed=False, B=3)
    with tempfile.TemporaryDirectory() as tmp:
        small_finetune_step_matches_cpu(FA, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        finetune = finetune_full_width(FA, tmp, card, isolated=step_row)
    mark("5-7")

    # phases 8-12: the int8 encoder and the fused conv front-end
    int8_rows = {}
    for din, dout in WAVLM_DENSE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for with_bias in (True, False):
                int8_rows[(din, dout, dtype, with_bias)] = int8_matmul_vs_plain(
                    Q, 8192, din, dout, dtype, with_bias, gen, timed=with_bias)
    # one 20 s utterance: 1024 rows, a fraction of the card's SMs busy
    int8_rows_1024 = {(din, dout): int8_matmul_vs_plain(Q, 1024, din, dout, torch.bfloat16,
                                                        True, gen, timed=True)
                      for din, dout in WAVLM_DENSE_SHAPES}
    for dtype in (torch.bfloat16, torch.float32):
        int8_matmul_vs_plain(Q, 51, 64, 136, dtype, False, gen, timed=False)
    conv_rows = {}
    for T, k, s in FRONTEND_LAYERS:  # as the fused configuration runs them
        conv_rows[(T, torch.bfloat16, True)] = conv_vs_plain(
            CF, T, k, s, torch.bfloat16, True, gen, timed=True)
    for T, k, s in (FRONTEND_LAYERS[0], FRONTEND_LAYERS[-1]):
        for dtype, gelu_tanh in ((torch.bfloat16, False), (torch.float32, True),
                                 (torch.float32, False)):
            conv_rows[(T, dtype, gelu_tanh)] = conv_vs_plain(
                CF, T, k, s, dtype, gelu_tanh, gen, timed=True)
    for T in (2, 3):  # no output row, one output row
        for dtype in (torch.bfloat16, torch.float32):
            conv_vs_plain(CF, T, 3, 2, dtype, True, gen, timed=False)
    bhld_rows = {dtype: bhld_attention_vs_plain(FA, dtype, gen)
                 for dtype in (torch.float32, torch.bfloat16)}
    with tempfile.TemporaryDirectory() as tmp:
        small_quant_pipeline_matches_cpu(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        quantized = transcribe_quantized_full_width(FA, tmp, card, result["feats"])
    mark("8-12")

    # phases 13-15: best-of-N, the evaluators, the CLI from a YAML config
    with tempfile.TemporaryDirectory() as tmp:
        nbest = nbest_full_width(tmp, card, result, quantized["transcribe_repeat"])
    with tempfile.TemporaryDirectory() as tmp:
        evaluators_full_width(tmp, card)
    mark("13-14")
    with tempfile.TemporaryDirectory() as tmp:
        cli_runs = cli_full_width(tmp, card)
        mark("15")
        # phase 16: the server, on the decoder .pt and tokenizer phase 15 wrote
        served = serve_full_width(tmp, card)
        mark("16")
        # phase 17: the AOT artifacts from the same files, replayed as CUDA graphs
        exported = exported_full_width(tmp, card, served)
        mark("17")
        # phase 18: the training entry point, on phase 15's tokenizer and HF WavLM
        trained = train_full_width(tmp, card, finetune)
        mark("18")
        # phase 19: the rest of the recipe, on phase 18's corpus
        recipe = train_recipe_full_width(tmp, card, finetune, trained)
        mark("19")
        # phase 20: several GPUs (one card: two ranks share it over gloo)
        parallel = parallel_full_width(FA, tmp, card, trained["cli_c"])
        mark("20")
        # phase 22: the offline workflow and the user scripts, on phase 18's
        # files, while phase 21's servers start; then phase 21: tensor
        # parallelism (phase 20's ranks' results, then the servers)
        servers = tp_servers_start(tmp, parallel)
        try:
            offline = offline_full_width(tmp, card, trained)
            mark("22")
            tensor_parallel = tensor_parallel_full_width(FA, Q, tmp, card, parallel, servers)
            mark("21")
        finally:
            tp_servers_stop(servers)
        # phase 23: the host tools and profilers, on phase 15's and phase 18's files
        host_tools = host_tools_full_width(tmp, card, served, trained)
    mark("23")
    print(json.dumps({"phase_end_s": phase_end_s}), flush=True)

    main_row = rows[(1024, torch.bfloat16)]  # the transcribe's shape and type
    kernels = [{
        "name": "wavlm_gated_attention",
        "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/gated_attention.cu",
        "replaces": "fddm_asr_tpu/ops/flash_attention.py:164 (_kernel_packed), "
                    "fddm_asr_tpu/ops/flash_attention.py:255 (_kernel_packed_flash)",
        "launches": result["kernel_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B=8 L=1024 H=16 bf16, ragged key masks",
        "launches_by_path": {
            "transcribe": result["kernel_launches"], "nbest": nbest["launches"]["fwd"],
            **{f"cli_{n}": cli_runs[n]["launches"]["fwd"] for n in CLI_RUNS},
            "serve_load": served["load"]["launches"]["fwd"],
            "serve_per_batch": served["load"]["launches_per_batch"],
            # replays of CUDA graphs, each counting the launches its capture recorded
            "exported_transcribe": exported["phase4_shape"]["graph"]["launches"]["fwd"],
            "exported_int8_fused": exported["int8_fused"]["launches"]["fwd"],
            "exported_serve_load": exported["serve"]["launches"]["fwd"],
            "exported_serve_per_batch": exported["serve"]["launches_per_batch"],
            "train_finetune_loop": trained["b"]["launches"]["fwd"],
            "train_lora_recipe_loop": recipe["a"]["launches"]["fwd"],
            "train_eval_per_decode_batch": [e["fwd"] // e["batches"]
                                            for e in trained["b"]["eval"]],
            # phase 20: rank 0 of the data=2 CLI, and B2 as the ring's one-rank
            # reference at L = 5120 (the ring itself launches none)
            "parallel_dp2_cli_rank0": parallel["b3"]["infer_launches_rank0"]["fwd"],
            "parallel_ring_one_rank_reference": parallel["b"]["rank0"]["ring"][
                "transcribe_float32_one_rank_launches"]["fwd"],
            "parallel_ring_transcribe": parallel["b"]["rank0"]["ring"][
                "transcribe_float32_ring_launches"]["fwd"],
            # phase 21: a rank's transcribe at model=2 (H = 8 heads a launch)
            "tensor_parallel_transcribe_per_rank": tensor_parallel["rank0"]["float32"][
                "launches"]["fwd"],
            "tensor_parallel_int8_fused_per_rank": tensor_parallel["rank0"]["int8_fused"][
                "launches"]["fwd"],
            # phase 21 (e1): a call of the model=2 sharded artifact, a rank (eager, gloo)
            "sharded_artifact_model2_per_rank_call": tensor_parallel["e"]["e1"]["rank0"][
                "launches"]["fwd"],
            # phase 22: a transcribe from the random-init .pt, the feature cache of
            # phase 18's 96 clips (6 batches), one validate_quant transcribe
            "offline_init_random_ckpt_transcribe": offline["b"]["launches"]["fwd"],
            "offline_precompute_features": offline["c"]["launches"]["fwd"],
            "offline_validate_quant_per_transcribe": offline["e"]["launches"]["fp"]["fwd"],
            # phase 23: profile_step a transcribe (16 x 20 s), bench_train a frozen
            # step (base and the 253 M decoder), inspect_transcripts, sanity_forward
            "host_tools_profile_step_per_transcribe": host_tools["a"]["launches"]["fwd"],
            "host_tools_bench_train_base_per_step":
                host_tools["d"]["base_lfd"]["kernel_launches_per_step"]["fwd"],
            "host_tools_bench_train_paper_per_step":
                host_tools["d"]["paper_lfd"]["kernel_launches_per_step"]["fwd"],
            "host_tools_inspect_transcripts":
                host_tools["g"]["inspect_transcripts"]["launches"]["fwd"],
            "host_tools_sanity_forward": host_tools["g"]["sanity_forward"]["launches"]["fwd"]},
        # phase 21: B1 at a model=2 rank's heads, B=8 L=1024, 999 valid keys a row
        "tensor_parallel_H8": [{k: tensor_parallel["kernels_h8"]["b1"][dt].get(k) for k in (
            "B", "L", "H", "valid", "dtype", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_tc_ms")} for dt in ("float32", "bfloat16")],
        "cli_c_100s_whole_file_L5120": {
            **{k: cli_runs["c_100s_whole_file"][k] for k in (
                "attention_L", "gated_attention_device_ms", "gated_attention_ms_per_launch")},
            **{k: rows[(WHOLE_FILE_L, torch.bfloat16)][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        "serve_batches": [{k: rows[("serve", B, L, dtype)].get(k) for k in (
            "B", "L", "valid", "dtype", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_tc_ms", "library_ms")}
            for B, L in serve_valid for dtype in (torch.float32, torch.bfloat16)],
        # the float32 kernel (3xTF32 on wgmma): phase 2's shapes, and a
        # float32 transcribe (launches and device time)
        "float32": {
            "kernel": "gated_attention_tf32x3_kernel",
            "launches_transcribe_f32": transcribe_f32["launches"]["fwd"],
            "transcribe_f32_device_ms": transcribe_f32["b1_f32_device_ms"],
            "launches_transcribe_f32_fused_frontend": transcribe_f32_fused["launches"]["fwd"],
            "by_shape": [{k: rows[key][k] for k in (
                "B", "L", "valid", "max_abs_err", "ms", "plain_ms", "library_ms",
                "library_kernel", "bound_ms", "bound_by", "bound_tc_ms", "bound_tc_by")}
                for key in ((1024, torch.float32), (4224, torch.float32),
                            (WHOLE_FILE_L, torch.float32))]},
    }]
    for key, kernel, source, replaces in (
            ("fwd_lse", "wavlm_gated_attention_fwd_lse", "gated_attention.cu",
             "fddm_asr_tpu/ops/flash_attention.py:412 (_kernel_packed_fwd_lse)"),
            ("bwd_dq", "wavlm_gated_attention_bwd_dq", "gated_attention_bwd.cu",
             "fddm_asr_tpu/ops/flash_attention.py:441 (_kernel_packed_bwd_dq)"),
            ("bwd_dkv", "wavlm_gated_attention_bwd_dkv", "gated_attention_bwd.cu",
             "fddm_asr_tpu/ops/flash_attention.py:476 (_kernel_packed_bwd_dkv)")):
        row = step_row[key]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": f"fddm_asr_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": finetune["kernel_launches_per_step"][key],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"B={FINETUNE_B} L={step_L} H=16 bf16, {frames} valid keys per row",
            "launches_by_path": {"finetune_step": finetune["kernel_launches_per_step"][key],
                                 "train_loop_step": trained["b"]["kernel_launches_per_step"][key],
                                 "train_loop": trained["b"]["launches"][key],
                                 "lora_recipe_micro_step":
                                     recipe["a"]["kernel_launches_per_micro_step"][key],
                                 "lora_recipe_loop": recipe["a"]["launches"][key],
                                 "remat_dots_step": recipe["c"]["remat"]["dots"]["launches"][key],
                                 # phase 20, float32: world size 1 over NCCL, and a
                                 # rank a step of data=2 (two ranks on the card)
                                 "parallel_nccl_world1_step":
                                     parallel["a"]["launches_per_step"][key],
                                 "parallel_dp2_step_per_rank":
                                     parallel["b"]["rank0"]["launches_per_step"][key],
                                 # phase 21: a rank's step at model=2 (H = 8)
                                 "tensor_parallel_step_per_rank":
                                     tensor_parallel["rank0"]["step"]["launches"][1][key],
                                 # phase 23: profile_finetune and bench_train --finetune
                                 "host_tools_profile_finetune_step":
                                     host_tools["b"]["launches"][key],
                                 "host_tools_bench_train_finetune_step":
                                     host_tools["d"]["finetune"]["kernel_launches_per_step"][
                                         key]},
            # phase 21: at a model=2 rank's heads, B=8 L=1024, 999 valid keys a row
            "tensor_parallel_H8": {dt: {"H": TP_H, **{
                k: tensor_parallel["kernels_h8"]["training"][dt][key].get(k) for k in (
                    "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "bound_tc_ms")}} for dt in ("float32", "bfloat16")},
            # phase 5's float32 row at B=8, L=1024, ragged masks
            "float32_L1024": {"kernels": F32_TRAINING_KERNELS[key], **{
                k: f32_train_rows[key].get(k) for k in (
                    "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "bound_tc_ms", "bound_tc_by")}},
            **({"plain_and_library_cover": "B4+B5"} if key != "fwd_lse" else {}),
        })
    bhld = bhld_rows[torch.bfloat16]
    kernels.append({
        "name": "wavlm_gated_attention_bhld", "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/gated_attention.cu",
        "replaces": "fddm_asr_tpu/ops/flash_attention.py:80 (_kernel)",
        "launches": bhld["launches"], "max_abs_err": bhld["max_abs_err"], "ms": bhld["ms"],
        "plain_ms": bhld["plain_ms"], "bound_ms": bhld["bound_ms"],
        "bound_by": bhld["bound_by"], "library_ms": bhld["library_ms"],
        "shape": "B=8 L=1024 H=16 dh=64 bf16, ragged key masks",
        "path": "the wavlm_gated_attention dispatcher, driven once: no model path reaches "
                "this kernel's entry point, in the JAX package or here",
    })
    ffn = int8_rows[(1024, 4096, torch.bfloat16, True)]  # the largest of the path's shapes
    kernels.append({
        "name": "int8_matmul_fused", "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/int8_matmul_fused.cu",
        "replaces": "fddm_asr_tpu/ops/quant.py:92 (_fused_kernel)",
        "launches": quantized["launches"]["int8_matmul_fused"],
        "launches_by_path": {
            "transcribe_int8_fused": quantized["launches"]["int8_matmul_fused"],
            "exported_int8_fused": exported["int8_fused"]["launches"]["int8_matmul_fused"],
            # phase 21: a model=2 rank launches it on its column slices only
            "tensor_parallel_int8_fused_per_rank": tensor_parallel["rank0"]["int8_fused"][
                "launches"]["int8_matmul_fused"],
            # phase 22: validate_quant's int8_fused transcribe of 16 x 20 s
            "offline_validate_quant_int8_fused": offline["e"]["launches"]["int8_fused"][
                "int8_matmul_fused"]},
        # phase 21: the column slices of a model=2 rank (q: 512, FFN: 2048 outputs), f32
        "tensor_parallel_column_slices": [{k: row[k] for k in (
            "M", "din", "dout", "dtype", "max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for row in tensor_parallel["b7_column_slices"].values()],
        "max_abs_err": ffn["max_abs_err"], "ms": ffn["ms"], "plain_ms": ffn["plain_ms"],
        "bound_ms": ffn["bound_ms"], "bound_by": ffn["bound_by"],
        "library_ms": ffn["library_ms"],
        "shape": "M=8192 din=1024 dout=4096 bf16 in and out, with bias",
        "ms_is": "CUDA events over back-to-back calls of the wrapper, as every kernel's ms; "
                 "device_ms: the kernel's device time per launch (torch.profiler)",
        "by_shape": [{"launches_per_layer": 4 if row["din"] == row["dout"] else 1,
                      **{k: row[k] for k in (
                          "M", "din", "dout", "ms", "device_ms", "plain_ms", "library_ms",
                          "bf16_matmul_ms", "bf16_matmul_device_ms", "bound_ms", "bound_by",
                          "max_abs_err", "workspace_bytes")}}
                     for row in [int8_rows[(din, dout, torch.bfloat16, True)]
                                 for din, dout in WAVLM_DENSE_SHAPES]
                     + list(int8_rows_1024.values())],
        # phase 8's float32 rows at the full shapes (f32 in and out, with bias);
        # bound_ms: the int8 product it runs; bound_f32_fma_ms / bound_tc_ms:
        # the same product as a float32 GEMM in FMAs and in 3xTF32
        "float32": {"by_shape": [{k: row[k] for k in (
            "M", "din", "dout", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_f32_fma_ms", "bound_f32_fma_by", "bound_tc_ms", "bound_tc_by",
            "max_abs_err", "workspace_bytes")}
            for row in [int8_rows[(din, dout, torch.float32, True)]
                        for din, dout in WAVLM_DENSE_SHAPES]]},
    })
    layers = [conv_rows[(T, torch.bfloat16, True)] for T, _, _ in FRONTEND_LAYERS]
    conv = layers[0]  # layer 1, the largest
    per_transcribe = {"ms_sum": sum(r["ms"] for r in layers),
                      "device_ms_sum": sum(r["device_ms"] for r in layers),
                      "bound_ms_sum": sum(r["bound_ms"] for r in layers),
                      "profiled_ms_in_transcribe_int8_fused":
                          quantized["port_kernels_ms"]["conv_ln_gelu"]}
    print(json.dumps({"conv_ln_gelu_per_transcribe": per_transcribe}), flush=True)
    kernels.append({
        "name": "conv_ln_gelu", "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/conv_ln_gelu.cu",
        "replaces": "fddm_asr_tpu/ops/conv_frontend.py:108 (kernel, made by _make_kernel :98)",
        "launches": quantized["launches"]["conv_ln_gelu"],
        "launches_by_path": {
            "transcribe_int8_fused": quantized["launches"]["conv_ln_gelu"],
            "exported_int8_fused": exported["int8_fused"]["launches"]["conv_ln_gelu"]},
        "max_abs_err": max(r["max_abs_err"] for r in layers),
        "ms": conv["ms"], "device_ms": conv["device_ms"], "plain_ms": conv["plain_ms"],
        "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
        "library_ms": conv["library_ms"],
        "shape": "B=8 T=63999 Cin=Cout=512 k=3 s=2 bf16, tanh GELU (layer 1); max_abs_err: "
                 "the largest over the six layers",
        "by_shape": [{k: r[k] for k in ("T", "T_out", "k", "s", "ms", "device_ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                     for r in layers],
        "per_transcribe": per_transcribe,
        # conv_ln_gelu_tf32x3_kernel at layers 1 and 6, erf and tanh GELU (phase
        # 8); bound_ms: f32 FMA's, bound_tc_ms: 3xTF32's; its launches in phase
        # 4's float32 transcribe under the fused front-end
        "float32": {
            "kernel": "conv_ln_gelu_tf32x3_kernel",
            "launches_by_path": {"transcribe_f32_fused_frontend":
                                 transcribe_f32_fused["launches"]["conv_ln_gelu"]},
            "device_ms_in_transcribe_f32_fused_frontend": transcribe_f32_fused["b8_f32_device_ms"],
            "by_shape": [
            {"gelu": "tanh" if tanh else "erf", **{k: conv_rows[(T, torch.float32, tanh)][k]
                                                   for k in (
                "T", "T_out", "k", "s", "ms", "device_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "bound_tc_ms", "bound_tc_by", "max_abs_err")}}
            for T, _, _ in (FRONTEND_LAYERS[0], FRONTEND_LAYERS[-1]) for tanh in (False, True)]},
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
