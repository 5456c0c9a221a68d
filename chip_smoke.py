#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``infinisst_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; no phase carries on past its own):
  1. device   -- require CUDA; print the card's name and power limit.
  2. build    -- build every kernel source (csrc/*.cu) for sm_90a, one
                 nvcc per source, all started together, in a thread
                 while the training phases (12. below: they launch no
                 kernel of the port) run.
  3. kernels  -- each kernel against its plain PyTorch version on the card
                 at every main-path shape: row_quant_int8, w8a8_gemm (on
                 its K-major (O, D) weight, in bf16 and float32),
                 group_quant_int8 and w8a8_grouped_gemm (on the same
                 K-major weight; also at other group sizes, split and
                 not, GROUPED_EXTRA, and on their simple route at groups
                 of 4-16 and O not a multiple of 4, GROUPED_SIMPLE)
                 bitwise, w8_bf16_gemm (on the same
                 K-major weight) within
                 W8_BF16_RTOL * max|plain| in bf16 and 1e-5 * max|plain|
                 in float32; kernel, plain and library times (median of 3
                 timed replays, with the kernel's min-max) and the bound;
                 w8a8_gemm's plan (row tiles, persistent blocks, ring,
                 split tiles) and w8_bf16_gemm's split-K plan (one row
                 tile at every M) beside their times, the grouped GEMM's
                 plan and w8a8_gemm's time on the same bytes beside its
                 own; w8a8_gemm_many (one launch) bitwise at q|k|v and
                 gate|up for M = 1, 4, 32, 79, 384 (MANY_M), timed beside
                 the same weights one launch each and torch._int_mm +
                 epilogue over the concatenated weight, and
                 w8a8_grouped_gemm_many likewise on the same weights
                 grouped by 128 (bf16 and float32), beside one grouped
                 launch a weight;
                 row_quant_int8 and group_quant_int8 beside an empty
                 kernel of their launch geometry (the launch floor).
                 rms_norm_quant_int8 (the residual add, RMSNorm and the
                 quantizer, D = 4096: with and without the residual,
                 bf16 and float32 rows and scales) and silu_mul_quant_int8
                 (the SwiGLU product and the quantizer, D = 14336) against
                 their plain versions at every path shape (FUSED_M), one
                 scale a row and in groups of 128, under every plan of
                 blocks a row: bitwise (any difference fails, with the
                 count of what differs); timed beside an empty kernel
                 of their geometry, the eager composition they replaced
                 and the standalone quantizer.
                 The library yardsticks,
                 timed here and never called by the port: torch._int_mm
                 and the scale epilogue in PyTorch ops (with the kernel /
                 library ratio; at M <= 16, which _int_mm refuses, on
                 the activations zero-padded to 17 rows, the epilogue on
                 the M real rows) beside w8a8_gemm,
                 torch._weight_int8pack_mm (on the same (O, D) weight)
                 beside w8_bf16_gemm; none for the grouped pair (no single
                 PyTorch call computes it).
                 The serving pool's shapes, M = 32 (a beam step of 8
                 slots x 4 beams) and M = 384 / 512 / 640 (its prefill at
                 m = 1, mixed (1, 2) and (1, 2, 4)) and 768, and the
                 offline agents' prefills, M = 192 / 320 (StreamAtt's
                 prompt buckets; AlignAtt's is 384) and 448 (AlignAtt at
                 the 28.8 s cap with 64 target ids, which the bench's
                 random weights do not reach), take row_quant_int8 and
                 w8a8_gemm only, with the _int_mm yardstick.  The offline
                 phases fail if a call's prompt bucket is not held here.
  4. attention -- decode_attention against its plain version at the beam
                 step's two blocks apart, at decode_attention_batched's
                 pooled shapes, at the serving pool's two blocks (its
                 prefix: 8 caches, each read by its slot's 4 beams) and at
                 an AlignAtt call with 64 target ids (a prefix of 447
                 valid in 512 slots; the per-beam block of 64 slots at key
                 offset 447, valid 1-64); beam_attention (the two blocks
                 in one launch, the beam step's kernel) against
                 beam_attention_plain at the stream's, the pool's,
                 AlignAtt's, StreamAtt's (183 of 256) and beam 1's two
                 blocks; output and lse within ATT_RTOL, bf16 and
                 float32; times as in phase 3, with
                 F.scaled_dot_product_attention (enable_gqa) over keys
                 rotated beforehand as the library yardstick (for
                 beam_attention each row's prefix and per-beam keys
                 concatenated).  Then the AlignAtt probe (llama.span_probe
                 over the 360 speech keys) from beam_attention's lse
                 equal to the probe from the plain version's, at three
                 gen_lens.  The shapes the offline benches' calls really
                 run are held where those run (hold_offline_attention in
                 streamatt, alignatt and streamatt bench).
     spec kernels -- the speculative stack's shapes: row_quant_int8 and
                 w8a8_gemm bitwise at M = 1 (a stream's draft and
                 sampling steps), 5 (its verify at k = 4), 8 and 40 (the
                 pool's draft and verify) and 20 (spec beam's tree of 5
                 levels x 4 beams) on every projection, the lm_head and a
                 16384-column shortlist head, timed, the plain version and
                 torch._int_mm + epilogue at M = 20 and 40;
                 decode_attention at beam 1's two blocks and at the tree
                 verify's prefix (20 rows against one cache, with lse),
                 within ATT_RTOL.
  5. tiny     -- a tiny speech-LLM on the card against the same model on
                 the CPU (plain versions): float32 and W8A8 prefill logits
                 within 1e-4 * max|logits|, and the W8A8 agent's tokens
                 equal in every chunk.
  6. flagship -- wav2vec2-large + Llama-3.1-8B, W8A8 projections and
                 lm_head, m=1, beam 4: streams until the encoder ring has
                 wrapped and the LLM cache was evicted; per-chunk wall
                 time, RTF and valid_len; launch counts checked per
                 forward pass (a8_forward_launches: w8a8_gemm 4L + 1,
                 rms_norm_quant_int8 2L + 1, silu_mul_quant_int8 L,
                 row_quant_int8 L: q/k/v and gate/up share one quantized
                 input and one w8a8_gemm launch, three of a layer's four
                 quantizations fused into the kernel that makes the
                 input; a captured
                 replay counts what its graph holds), printed beside what
                 the wrappers did besides launching (split-K calls, fills
                 of the kernels' tile counters); then one chunk with a
                 synchronise around each replayed piece of the captured
                 chunk program (A prologue, B beam select, C beam
                 forward, F finish: wall ms per piece, a beam step's B +
                 C) and one under torch.profiler (device time by kernel
                 and by piece, idle share; the other device ops by op,
                 with no mean reduction beyond the encoder step's own,
                 counted on an eager pass of it; the kernels of
                 each row the profiler saw run, counted by name, equal
                 the launches the replayed graphs recorded at capture).
                 Then [graph], on the same weights: the chunk program
                 captured as CUDA graphs against the same functions
                 uncaptured on the card (the agent's private
                 ``_graphs_on``), m=1, beam 4, GRAPH_CHUNKS chunks with an
                 applied eviction (max_llm_cache_size GRAPH_CACHE), then
                 m=2 with a tail chunk at GRAPH_M2_DEPTH layers: target ids
                 equal every chunk, every chunk's launches equal the
                 uncaptured chunk's and its forwards (llama's counters)
                 those its beam steps ran, every replay under sync debug mode
                 "error" (``graphs.strict_syncs``: lifted only around the
                 reads of ``done`` and of the packed result), at most beam
                 steps + 1 host reads a chunk; the captured chunk's wall
                 (median, p95) beside the uncaptured one's, one chunk's
                 device time by piece (CUDA events around each replay) and
                 idle share, a beam step's wall against its device time.
                 Then [multiplier]: update_multiplier(2) and (4) on the
                 same stream, one chunk at each (encoder frames +96, +192;
                 beam_attention launches = beam forwards x L).
                 Then [serve profile]: the same weights in a ServingEngine
                 (pool 8, beam 4, m=1): tick walls, one tick with a
                 synchronise around each stage and one under
                 torch.profiler.
                 Then [alignatt profile]: the same weights in the bench's
                 AlignAtt agent (every call at the 28.8 s audio shape,
                 one captured program per (n_units, prompt bucket)): its
                 first call (24 beam steps; the key's warm-up pass and
                 capture) and its second (a replay) timed, a third,
                 replayed, under torch.profiler (device time by piece,
                 idle share, the kernels counted by name equal to the
                 recorded launches); a call at 64 beam steps with a
                 synchronise around each replayed piece.
     alignatt graph -- (after graph and pool graph, on the flagship's
                 weights at ALIGNATT_GRAPH_DEPTH layers) the bench's
                 AlignAtt (parity, with a caller committing target ids
                 so that a key replays at another prompt length, and
                 --early-stop) and StreamAtt agents, their calls captured
                 against the same programs uncaptured
                 (``_graphs_on``): target ids, most-attended indices,
                 attention traces and kept source equal every call,
                 launches equal, forwards those the beam steps ran,
                 replays under sync debug mode "error", at most beam
                 steps + 1 host reads; a replayed call's and its
                 uncaptured twin's kernels by name (the profiler) the
                 launches both recorded (the libraries' kernels
                 reported: cuDNN picks a convolution's algorithm by the
                 workspace it gets); per key the capture's wall, the
                 graph pool's bytes and the key's static bytes.
     sample graph -- the flagship sampling stream (m = 1, top-k 50,
                 top-p 0.9) at two seeds, its chunk program (pieces A,
                 S, D, F, its generator registered with S's graph)
                 captured against uncaptured: tokens and launches equal
                 every chunk, at most draws + 1 host reads, replays under
                 strict syncs; then a speculative sampling stream whose
                 guard trips and whose later chunks replay the sampling
                 program, token-equal to its uncaptured twin.
     mesh     -- (after streamatt, on the flagship's weights) the mesh path
                 at world size 1 (one card; the multi-rank paths are held
                 on the CPU under gloo, tests/test_torch_parallel.py): in
                 this process a world-1 NCCL group, the flagship W8A8
                 agent through shard_params (zero's spec tree, FSDP's
                 code path) and tensor_parallel at (1, 1), 4 chunks, its
                 target ids those of the agent without a mesh after every
                 chunk, w8a8_gemm, row_quant_int8, rms_norm_quant_int8,
                 silu_mul_quant_int8 and beam_attention launched; the
                 flagship W8A8 pool of 8 at beam 4 through
                 the split engine's path at (1, 1), 2 ticks, every slot's
                 tokens those of the pool without a mesh (one data rank:
                 NCCL refuses two ranks on one card, so the split itself
                 runs on four cards, parallel.mesh_check); the sharded
                 train step at (1, 1) on the dryrun preset, zero's spec
                 tree, bitwise make_train_step's (deterministic
                 algorithms on); and under ``torchrun
                 --standalone --nproc_per_node 1``, started in the
                 background before [alignatt graph], the dryrun
                 (``parallel.dryrun``: the stage 2 step, the TP prefill,
                 the pooled, speculative and sampling pool ticks) with its
                 summary line and launches, and ``train.main --n_data 1
                 --max_steps 3`` (metrics.jsonl, the checkpoint).
     streamatt -- (after flagship, on its weights) the bench's StreamAtt
                 agent driven directly for 16 chunks through the bench's
                 run_offline: each chunk's wall, beam steps, prompt
                 bucket, prompt length and kept source, a JSON line over
                 chunks 2-15 under its own metric name
                 (streamatt_direct16_...), launches checked per call as in
                 [alignatt]; after every push the kept source equal to the
                 attended-frame rule's (StreamAttRule), recomputed from the
                 agent's target and most-attended samples, and a cut by
                 that rule at least once; then beam_attention and the
                 probe held at each (prompt length, cache slots) its calls
                 ran (hold_offline_attention, untimed).
  7. weight-only -- four chunks of the 8B model (the first and the
                 steady key captured, two replays) with
                 {'q_kmajor','scale'} projections through w8_bf16_gemm,
                 then one chunk under torch.profiler.
  8. group128 -- four chunks of the 8B model as ``bench.py --group128``
                 makes it: grouped (128-wide) W8A8 projections, packed
                 K-major, through w8a8_grouped_gemm (a8_forward_launches
                 grouped: w8a8_grouped_gemm 4L, q|k|v and gate|up one
                 launch each, rms_norm_quant_int8 2L + 1 and
                 silu_mul_quant_int8 L grouped by 128 but the head's norm,
                 group_quant_int8 L before o), per-channel W8A8 lm_head;
                 then one chunk under torch.profiler.
  9. bench    -- ``python -m infinisst_tpu_torch.bench`` (flagship W8A8,
                 m=1, beam 4, 12 chunks, 3 untimed) in this process
                 (``run_main``), which holds no other 8B weights then:
                 exit 0 and its JSON line
                 with metric streaming_rtf_m1_beam4_8b_int8, re-printed.
     serve    -- ``python -m infinisst_tpu_torch.bench --mode serve``
                 (pool 8, beam 4, m=1, 12 timed ticks) in this process
                 (``run_main``: its ``main`` with its output captured):
                 exit 0, metric serve_decode_tok_per_s_pool8_beam4_m1_8b_int8,
                 launches beam_attention = token forwards x L (at B=32
                 over Bc=8 prefix caches), the GEMMs and quantizers
                 forwards x a8_forward_launches(L); then a mixed
                 --multipliers 1,2 pool of 2 chunks.
     alignatt -- ``python -m infinisst_tpu_torch.bench --mode alignatt``
                 (12 chunks, 3 untimed) and ``--early-stop``: exit 0, the
                 JSON line, each chunk's wall, beam steps, prompt bucket
                 and prompt length; launches of the GEMMs and quantizers
                 = steps x a8_forward_launches(L), beam_attention =
                 (steps - calls) x L, summed over the calls, each > 0 in
                 parity (the early stop may stop every call at its first
                 step, with no beam forward; its RTF then times a prefill
                 a call).  beam_attention (prefix of pbucket + 64 slots
                 with the prompt length valid, per-beam block of 64 slots
                 at that key offset) and the probe held at every shape the
                 parity calls ran, timed at the one with the most beam
                 forwards (the kernels line's alignatt entries).
     streamatt bench -- ``python -m infinisst_tpu_torch.bench --mode
                 streamatt`` (40 chunks, timed from 32): as alignatt, its
                 shapes held and timed (the kernels line's streamatt
                 entries).
 10. cli ckpt -- a synthetic reference pytorch_model.bin at the dryrun
                 preset, loaded by ``agents.cli.main`` through
                 convert/from_torch.py and streamed over two wav files, on
                 the card and on the CPU: equal predictions and delays;
                 then ``--agent streamatt`` on the card: both talks in a
                 non-empty instances file.
 11. cli flagship -- ``agents.cli.main`` at the flagship preset, m=2, with
                 no paths (random bf16 weights on the card, plain
                 torch.matmul projections, beam_attention in the beam
                 step) and the stub tokenizer over the same two files:
                 finite RTF and StreamLAAL, the scores printed.
     alignatt tiny -- (after serve tiny) the tiny AlignAtt (parity and
                 early stop) and StreamAtt agents with float32 weights on
                 the card against the CPU: target ids, most-attended
                 indices and source lengths equal after every push, the
                 StreamAtt source equal to the attended-frame rule's after
                 every push and cut at an attended sample at least once;
                 the same with W8A8 weights, reported (the first push
                 that differs).
     spec tiny -- (after tiny) the tiny float32 agent in every
                 speculative and sampling mode, on the card and on the CPU:
                 speculative greedy and top_k 1 sampling (plain and
                 speculative) equal to beam 1 greedy, speculative beam 4
                 equal to plain beam 4, chunk by chunk on each device, and
                 card = CPU; a seeded sampling run (plain and speculative)
                 equal to its repeat on each device.
     spec bench -- (after serve) the bench's --speculative (the guard
                 trips on the random draft), --speculative
                 --spec-resid-scale 0 --spec-no-guard (accept_rate > 0),
                 --speculative --spec-beam, --do-sample and --speculative
                 --do-sample at the flagship W8A8, 8 chunks each, in
                 this process; each run's launches held to its model
                 forwards (a8_forward_launches(n) a forward of n layers,
                 beam_attention n a beam step,
                 decode_attention n a tree verify, none in a decode_step).
     spec serve -- the bench's --mode serve --speculative and
                 --speculative --do-sample (pool 8, beam 1), launches held
                 to the forwards as in spec bench.
     serve tiny -- (after tiny) a tiny float32 ServingEngine on the card
                 against the CPU: pool 2, beam 2, multipliers (1, 2), a
                 multiplier switch and a trim; every slot's tokens equal
                 every tick.  Then the same pool with W8A8 weights,
                 reported, not held: the first tick whose tokens differ
                 and the gap of its prefill logits (an activation within
                 float32 noise of an int8 rounding boundary quantizes one
                 step apart; the int8 kernels are bitwise in [kernels]).
     server   -- ``python -m infinisst_tpu_torch.serve.server`` at the dryrun
                 preset on the card (started in the background before cli
                 ckpt) and two ``serve.client`` processes (m=1
                 and m=2) over localhost streaming the CLI's two talks:
                 both streams finish.
 12. the training path (plain torch: JAX's training forward calls no
     Pallas kernel, so every kernel's launches there are 0); train
     flagship, its stage 2 and train tiny run first, beside the build:
     train tiny -- the dryrun preset in float32: stage 1, stage 2 with
                 grad_acc_steps 2 and stage 0 with cpo_beta 0.5, 4 steps
                 each of make_train_step on the same batches on the card
                 and on the CPU: per-step loss and grad norm within
                 TINY_RTOL, the parameters after the last step within the
                 CPU test's tolerance, frozen leaves bitwise unchanged.
     train flagship -- Trainer.fit on the flagship preset in bfloat16
                 (its Llama cut to TRAIN_FLAGSHIP_LAYERS layers: frozen at
                 stage 1, it sets only the checkpoint's bytes and the
                 frozen forward), stage 1, remat, encoder dropout 0.1, over
                 synthetic TSV
                 + wav rows of 28.8 s under build/ (two rows a batch,
                 collator 4 at m = 1), 3 steps: finite losses, every LLM
                 leaf bitwise unchanged, w2v2 and adapter moved, no kernel
                 launched; step walls, peak memory, the final save's size
                 and wall (after checking the free space); then a second
                 Trainer with max_steps=4 restores step 3 and takes one
                 step.  The run directory is removed.
     train flagship stage 2 -- Trainer.fit on the same rows at stage 2
                 (the adapter and the 8B LLM trained, the encoder frozen),
                 bfloat16, remat, 3 steps, captured, no checkpoint: finite losses,
                 every w2v2 leaf bitwise unchanged, the adapter and every
                 LLM matrix moved, no kernel launched; the step walls, the
                 peak memory and the bytes of the parameters, gradients
                 and AdamW moments, counted from the leaves.
     train graph -- the train step as a captured program
                 (``TrainProgram``) against its uncaptured twin
                 (``_graphs_on = False``) from the same state, with
                 deterministic algorithms: the flagship stage 1 at
                 TRAIN_FLAGSHIP_LAYERS layers, bf16, remat, dropout 0.1,
                 TRAIN_GRAPH_STEPS steps, then [train tiny]'s three cases
                 on the dryrun preset (stage 1 with dropout 0.1): loss,
                 norm, every parameter and moment bitwise after every
                 step; replays under ``graphs.strict_syncs``, the packed
                 [loss, norm] read at every TRAIN_GRAPH_LOG-th step only;
                 a replayed flagship step's device kernels by name, its
                 copies and memsets equal the uncaptured step's (plus the
                 generator's replay prologue), both dispatches, the
                 replay under the profiler (idle share).
     train main -- ``python -m infinisst_tpu_torch.train.main
                 --model_preset dryrun --max_steps 3`` on the card in
                 this process: metrics.jsonl and the checkpoint.
     train bench -- ``python -m infinisst_tpu_torch.bench --mode train``
                 and ``--mode train-io`` in this process: their JSON lines
                 (bench.py's keys), values finite and positive; then the
                 bench's step in this process, captured (and uncaptured,
                 on the same state): synced walls, the host's dispatch
                 time, one replayed step under the profiler.
 13. the tools:
     fidelity -- ``tools.quant_fidelity.main --steps 600`` in this process:
                 the probe's Llama (D=256, L=4, V=512) trained on the card,
                 every variant's flip rates, greedy divergence and beam-4
                 winner changes beside docs/quant_fidelity.json (the JAX
                 tool's); each variant's kernels launched (w8:
                 w8_bf16_gemm; w8a8: rms_norm_quant_int8,
                 silu_mul_quant_int8, row_quant_int8 + w8a8_gemm; grouped:
                 the fused pair, group_quant_int8 + w8a8_grouped_gemm;
                 beam_attention in
                 every beam step; the two groups-of-8 variants through
                 the grouped pair's simple route); then every int8 kernel
                 bitwise against its plain version on the trained weights
                 at the prefill's 512 rows and a beam step's 4
                 (w8_bf16_gemm within 1e-5; the fused quantizers at groups
                 of 256 / 512, 128, 32 and 8), timed at the prefill's shape,
                 and beam_attention at the beam step's two blocks.
     distill tiny -- the probe's Llama trained 150 steps on the 64 x 64
                 corpus, 8 prompts rolled out, an adapter distilled at
                 d = 1; speculative greedy with and without it in float32
                 and W8A8: KL and agreement, tokens unchanged, float32
                 acceptance doubled, w8a8_gemm launched; then the
                 distillation's programs captured against uncaptured on
                 that model (``distill_graph``, below).
     distill graph -- ``distill_graph`` on a float32 Llama at the
                 flagship's width and depth (random, D 4096, V 128256,
                 rank 2048, d = 8): ``train/draft.py``'s programs
                 captured against the same programs uncaptured, from the
                 same weights and inputs, deterministic algorithms on:
                 greedy rollouts on two keys (tokens equal, no host
                 read), a beam rollout (records equal, one read),
                 ``distill`` over the two keys' rollouts with a cache of
                 one (teacher passes replayed), ``distill_on_features``
                 and ``beam_selection_distill``: adapter, moments and
                 history bitwise, a host read a log step, every program
                 replayed, under ``graphs.strict_syncs``; a replayed
                 step's device kernels, copies and memsets those of the
                 uncaptured step; rollout tokens/s, a step's wall and
                 host dispatch, captured and uncaptured, and a replayed
                 step's idle share (printed, no claim).
     distill flagship -- ``python -m infinisst_tpu_torch.tools.
                 distill_adapter --model-preset flagship`` (8B float32,
                 rank 2048, d = 8, 20 steps) in this process, its split
                 (rollout, teacher pass, mean step) from its stderr: the
                 KL falls, the .npz loads at d = 8 only; then the flagship W8A8
                 agent, speculative d = 8 with the guard off, 4 chunks with
                 and without the adapter: the same tokens, the int8
                 kernels launched, both acceptance rates.
     profiling -- ``core.profiling``: timed and StepTimer around w8a8_gemm
                 with ``sync_on``, device_trace over one W8A8 prefill of
                 the probe's model (the Chrome trace names the kernels).
     trained tools -- ``tools.alignatt_quality``, ``trained_e2e``,
                 ``spec_trained_teacher`` and ``phrase_e2e`` through their
                 ``main``s at TRAINED_STEPS on 4 held-out utterances: each
                 trained model's TER below its random twin's; the trained
                 weights (read back from the tools' pickles) through the
                 AlignAtt agent (both modes), the beam-4 InfiniSST agent
                 and the speculative agent on the card and on the CPU,
                 tokens equal; the AlignAtt probe's share in the
                 zero-padded audio bucket, push by push; spec_acceptance's
                 ``run_spec``/``run_beam`` rows card against CPU on the
                 fidelity probe's trained Llama; beam_attention held at
                 every shape these paths launched, on their own inputs.
     demos    -- ``examples.stream_demo`` (3 chunks) and
                 ``examples.serve_demo`` (3 ticks, a pool of 4 caches at
                 beam 2: beam_attention over Bc > 1, kernel row 5) on
                 the card; beam_attention held at their shapes.
 14. one JSON ``kernels`` line (the launches of one replayed chunk of the
     captured program under ``graph``; the speculative paths' launches and times
     under ``spec`` and ``spec_serve`` of w8a8_gemm, row_quant_int8,
     rms_norm_quant_int8, silu_mul_quant_int8, beam_attention (beam 1)
     and decode_attention (the tree verify's prefix); the fused
     kernels' grouped form under ``group128``; the training path's
     launches, 0, under
     ``train``; the mesh path's, by the agent and the dryrun, under
     ``mesh``; the tools' launches by phase and the times at the
     probe's shapes under ``tools``, the grouped GEMM's simple route at
     groups of 8 under ``tools.simple_route_gs8``; the trained tools' and
     the demos' launches under ``trained_tools`` and ``demos``), then the
     card line, then the result line.

Each phase prints its wall seconds.  Weights are random, made on the card
from seeded torch.Generators.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

# (D, O) of every W8A8 projection and the padded lm_head at the flagship
# geometry; M = 1, 4 beam rows, 61 / 79 prefill rows
TABLE_DO = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
            (4096, 128512)]
TABLE_M = [1, 4, 61, 79]
# the serving pool's rows: a beam step of 8 slots x 4 beams; the prefill of
# 8 prompts padded to 48 tokens at m=1, 64 in a mixed (1, 2) pool and 80
# in a (1, 2, 4) pool (the stub tokenizer's prompts); and 8 x 96
SERVE_M = [32, 384, 512, 640, 768]
# the offline agents' prefills: StreamAtt's prompt buckets 192 and 320
# (the bench's calls; AlignAtt's 384 is the pool's), and AlignAtt at the
# 28.8 s cap with 64 target ids (448), which the bench's random weights do
# not reach; every bucket a bench call ran must be among the rows held
OFFLINE_M = [192, 320, 448]
DECODE_BUF_TOKENS = 64  # the offline agents' G (AlignAttOptions)
# the speculative stack's rows at the bench's d = 8, k = 4: a stream's
# draft and plain-sampling steps (1), its verify (k + 1 = 5), the pool's
# draft (8) and verify (40), and spec beam's tree ((k + 1) x 4 beams = 20)
SPEC_M = [1, 5, 8, 20, 40]
SHORTLIST_DO = (4096, 16384)  # a --spec-head-vocab 16384 draft head
SPEC_SHAPE = (5, 4096, 14336)  # the kernels line: a verify's gate/up
SPEC_BENCH_CHUNKS = 8  # 3 untimed: the guard trips after chunk 2
REPORT_SHAPE = (4, 4096, 14336)  # the kernels line: a beam-step gate/up
GROUP = 128  # bench.py --group128
W8_BF16_RTOL = 1e-2  # of max|plain|: f32 summation order, then bf16 rounding
# decode attention, of max|plain|: the kernel sums in f32 in another order
# (key splits merged by their lse, other cos/sin and FMA contractions), so
# a bf16 output may round one bf16 step (<= 2**-7 of its value) apart;
# float32 outputs and the f32 lse agree to 1e-5
ATT_RTOL = {"bf16": 2.0 ** -7, "f32": 1e-5}
# tiny prefill logits, card against CPU, as a share of max|logits|: the
# card sums float32 in another order (readings on the H100: 2.6e-6 with
# float32 weights, 1.3e-6 with W8A8); TF32 is off (see main)
TINY_RTOL = 1e-4
TIMED_TRIALS = 3
# w8a8_gemm launches a Llama layer makes: q|k|v and gate|up one launch each
# (w8a8_gemm_many), o and down one each; a forward adds the head's
GEMMS_PER_LAYER = 4


def a8_forward_launches(n: int, grouped: bool = False) -> dict:
    """The quantizer and GEMM launches of one W8A8 forward of n layers
    with a per-channel W8A8 head: rms_norm_quant_int8 after each layer's
    two residual adds and before the head (2n + 1), silu_mul_quant_int8
    before each down projection (n), the attention output's own quantizer
    before each o projection (n: row_quant_int8, or group_quant_int8 with
    ``grouped`` projections); w8a8_gemm 4n + 1 (the grouped projections:
    w8a8_grouped_gemm 4n, q|k|v and gate|up one launch each as for
    w8a8_gemm, w8a8_gemm the head's 1)."""
    fused = {"rms_norm_quant_int8": 2 * n + 1, "silu_mul_quant_int8": n}
    if grouped:
        return {"w8a8_grouped_gemm": GEMMS_PER_LAYER * n,
                "group_quant_int8": n,
                "w8a8_gemm": 1, "row_quant_int8": 0, **fused}
    return {"w8a8_gemm": GEMMS_PER_LAYER * n + 1, "row_quant_int8": n,
            "group_quant_int8": 0, "w8a8_grouped_gemm": 0, **fused}


# a8_forward_launches(n) as text
A8_TEXT = ("w8a8_gemm 4n + 1, rms_norm_quant_int8 2n + 1, "
           "silu_mul_quant_int8 n, row_quant_int8 n")


ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_METRIC = "streaming_rtf_m1_beam4_8b_int8"
SERVE_METRIC = "serve_decode_tok_per_s_pool8_beam4_m1_8b_int8"
SERVE_MIXED_METRIC = "serve_decode_tok_per_s_pool8_beam4_mixedm1x2_8b_int8"
# the keys of bench.py's serve JSON line (bench.py:761-787)
SERVE_KEYS = ("metric", "value", "unit", "vs_baseline", "slot_chunk_p50_ms",
              "slot_chunk_p95_ms", "slot_chunk_p99_ms", "slot_chunks_timed")
# the keys of bench.py's single-stream JSON line (bench.py:492-502)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "outliers_dropped",
              "dropped_s", "rtf_untrimmed_mean", "rtf_median", "rtf_p95")
# the CLI phases' two talks: seconds of 16 kHz audio, and their references
CLI_TALKS = ((4.8, "ein kleiner test satz\tnoch einer"),
             (7.7, "zweiter talk text"))


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


@contextlib.contextmanager
def phase(label: str):
    """Print the wall seconds of a phase when it ends."""
    t0 = time.perf_counter()
    yield
    print(f"[{label}] phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> list:
    """Device milliseconds per call of ``fn(i)``, sorted, one per timed
    replay: ``reps`` calls are captured in one CUDA graph and each of
    ``TIMED_TRIALS`` replays is timed with CUDA events, so the host's cost
    of launching (Python, ctypes) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)


def int_mm_ms(yq, ys, ws, s) -> list:
    """The library yardstick of ``w8a8_gemm``: ``torch._int_mm`` over the
    (D, O) weights ``ws`` (cycled) and the scale epilogue in
    PyTorch ops.  ``_int_mm`` refuses M <= 16, so there it takes the
    activations zero-padded to 17 rows (padded once, outside the timing)
    and the epilogue keeps the M real rows."""
    import torch

    M = yq.shape[0]
    n_w = len(ws)
    if M > 16:
        return cuda_time_ms(lambda i: (torch._int_mm(yq, ws[i % n_w]).float()
                                       * ys * s).to(torch.bfloat16), 20)
    yp = torch.nn.functional.pad(yq, (0, 0, 0, 17 - M))
    return cuda_time_ms(lambda i: (torch._int_mm(yp, ws[i % n_w])[:M].float()
                                   * ys * s).to(torch.bfloat16), 20)


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def plan_line(K, M, D, Os, sms):
    """Print and return w8a8_gemm's plan for weights of (O, D), O in
    ``Os``, in one launch."""
    p = K.w8a8_plan(M, D, tuple(Os), sms)
    print(f"  {'':17s} plan: {p.rows} rows a tile x {p.n_mtiles} row "
          f"tile(s), {p.tile0[-1]} tiles x {p.n_k} stages over {p.blocks} "
          f"persistent blocks ({p.n_iters / p.blocks:.2f} stages each), "
          f"{p.stages}-stage ring, {p.split_tiles} tile(s) split",
          flush=True)
    return p


def grouped_plan_line(K, M, D, Os, sms):
    """Print and return the grouped GEMM's plan for weights of (O, D), O
    in ``Os``, in groups of GROUP, in one launch."""
    p = K.grouped_plan(M, D, D // GROUP, tuple(Os), sms)
    how = (f"stream-K, {p.split_tiles} tile(s) split, {p.parked_bytes} "
           f"bytes parked" if p.cut == 1 else "whole tiles a block")
    print(f"  {'':17s} grouped plan: {p.rows} rows a tile x {p.n_mtiles} "
          f"row tile(s), {p.tile0[-1]} tiles x {p.n_k} stages over "
          f"{p.blocks} persistent blocks ({how}), {p.stages}-stage ring",
          flush=True)
    return p


def _kernel_modules():
    from infinisst_tpu_torch.kernels import decode_attention as A
    from infinisst_tpu_torch.kernels import quant_matmul as K

    return K, A


def reset_counts():
    for m in _kernel_modules():
        m.reset_launch_counts()


def launch_counts() -> dict:
    out = {}
    for m in _kernel_modules():
        out.update(m.launch_counts)
    return out


def internal_counts() -> dict:
    """What the wrappers did besides their one launch a call: split-K
    calls of w8a8_gemm and fills of the kernels' tile counters."""
    K, _ = _kernel_modules()
    return dict(K.internal_counts)


def forward_counts() -> dict:
    """llama's forward passes so far by function and depth (replays of a
    captured program count what they hold)."""
    from infinisst_tpu_torch.models import llama

    return dict(llama.forward_counts)


def forwards_since(before: dict) -> dict:
    after = forward_counts()
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def check_forwards(before: dict, steps: int, n_layers: int, label: str):
    """The forwards that llama's counters recorded since ``before`` (a
    replay adds what its graph holds) against what the chunk's beam steps
    say it ran, counted on the device by the decoder itself: one prefill
    and steps - 1 beam forwards."""
    want = {f"decode_step L={n_layers}": 1}
    if steps > 1:
        want[f"beam_token_step L={n_layers}"] = steps - 1
    got = forwards_since(before)
    if got != want:
        fail(f"[{label}] the forward counters recorded {got}; {steps} beam "
             f"steps ran {want}")


class Notes:
    """Per kernel: the largest error against the plain version, and the
    timings and bound of each shape."""

    def __init__(self):
        self.rows = {}

    def note(self, name, shape, err, ms, plain_ms, lib_ms, bms, by,
             label=None, floor_ms=None):
        """``ms``, ``plain_ms``, ``lib_ms`` and ``floor_ms`` (an empty
        kernel's launch, where given) are cuda_time_ms lists (or None: no
        library call, or the plain version not timed at this shape); the
        medians are kept."""
        med = statistics.median
        lib = None if lib_ms is None else med(lib_ms)
        plain = None if plain_ms is None else med(plain_ms)
        r = self.rows.setdefault(name, {"err": 0.0, "shapes": {}})
        r["err"] = max(r["err"], err)
        r["shapes"][shape] = dict(ms=med(ms), plain_ms=plain,
                                  library_ms=lib, bound_ms=bms, bound_by=by)
        floor = ""
        if floor_ms is not None:
            r["shapes"][shape]["launch_floor_ms"] = med(floor_ms)
            floor = (f" launch_floor_ms={med(floor_ms):.5f} (kernel / floor "
                     f"{med(ms) / med(floor_ms):.3f})")
        lib = "null" if lib is None else f"{lib:.5f}"
        plain = "not_timed" if plain is None else f"{plain:.5f}"
        label = label or (f"M={shape[0]:3d} D={shape[1]:5d} "
                          f"O={shape[2]:6d}")
        print(f"  {name:17s} {label} max_abs_err={err:.3e} ms={med(ms):.5f} "
              f"[{ms[0]:.5f}-{ms[-1]:.5f}] plain_ms={plain} "
              f"library_ms={lib} bound_ms={bms:.5f} ({by}){floor}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 3

# (M, D, O, gs) checked besides the main-path shapes, in bf16 and float32:
# split-K (M <= gs / 32) and not, gs 32, 64 and 96, O not a multiple of 128
GROUPED_EXTRA = [(3, 256, 200, 32), (1, 4096, 1024, 32), (2, 4096, 4096, 64),
                 (79, 4096, 1024, 64), (1, 3072, 512, 96), (61, 768, 256, 96),
                 (5, 4096, 1024, 256), (8, 4096, 4096, 128)]
# the simple route's shapes: groups of 8 and 16 (the fidelity probe's 32
# groups of its 256- and 512-wide inputs), 12 (__dp4a) and 6 (scalar), bf16
# groups of 4 and 12 (not whole 16-byte vectors), O not a multiple of 4
GROUPED_SIMPLE = [(5, 256, 100, 8), (512, 256, 256, 8), (4, 512, 256, 16),
                  (3, 256, 30, 8), (7, 96, 129, 12), (3, 96, 40, 6),
                  (2, 64, 64, 4)]


def check_grouped(K, y, w_t, sg, gs, label, out_dtypes):
    """group_quant_int8 and w8a8_grouped_gemm (on the K-major weight w_t,
    with each of ``out_dtypes`` out) bitwise against their plain
    versions."""
    import torch

    gq, gs_ = K.group_quant_int8(y, gs)
    pq, ps = K.group_quant_int8_plain(y, gs)
    if not (torch.equal(gq, pq) and torch.equal(gs_, ps)):
        fail(f"group_quant_int8 differs from its plain version at {label}")
    for dt in out_dtypes:
        out = K.w8a8_grouped_gemm(gq, gs_, w_t, sg, dt)
        ref = K.w8a8_grouped_gemm_plain(gq, gs_, w_t, sg, dt)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = (out.float() - ref.float()).abs().max().item()
            fail(f"w8a8_grouped_gemm differs from its plain version at "
                 f"{label} {dt}: max_abs_err={err}")


def check_kernels(dev, notes):
    import torch

    from infinisst_tpu_torch.kernels import quant_matmul as K

    gen = torch.Generator(device=dev).manual_seed(1)
    note = notes.note
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    for D, O in TABLE_DO:
        wbytes = D * O
        # enough weight copies to exceed the 50 MB L2: the main path reads
        # each layer's weight cold
        n_w = max(1, math.ceil(120e6 / wbytes))
        ws = [torch.randint(-127, 128, (D, O), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(n_w)]
        # K-major (O, D) copies, packed once: w8a8_gemm's layout, and the
        # one the library's weight-only int8 matmul takes
        wts = [w.t().contiguous() for w in ws]
        s = torch.rand((O,), generator=gen, device=dev) * 1e-3 + 1e-4
        G = D // GROUP
        sg = torch.rand((G, O), generator=gen, device=dev) * 1e-3 + 1e-4
        for M in TABLE_M + SERVE_M + OFFLINE_M:
            y = (torch.randn((M, D), generator=gen, device=dev) * 2.0
                 ).to(torch.bfloat16)
            # row_quant_int8 (one D per row count; time at O's first visit)
            yq, ys = K.row_quant_int8(y)
            pq, ps = K.row_quant_int8_plain(y)
            if not (torch.equal(yq, pq) and torch.equal(ys, ps)):
                fail(f"row_quant_int8 differs from its plain version at "
                     f"M={M} D={D}")
            if O == TABLE_DO[0][1] or D == 14336:
                ms = cuda_time_ms(lambda i: K.row_quant_int8(y), 50)
                pms = cuda_time_ms(lambda i: K.row_quant_int8_plain(y), 20)
                # the launch floor: an empty kernel of the same geometry
                rp = K.row_quant_plan(M, D, 2)
                fms = cuda_time_ms(
                    lambda i: K.launch_empty(dev, rp.vpt * M, rp.threads),
                    50)
                bms, by = bound_ms(M * D * 2 + M * D + M * 4, 0, 1.0)
                note("row_quant_int8", (M, D, 0), 0.0, ms, pms, None, bms, by,
                     floor_ms=fms)

            # w8a8_gemm on the K-major weight: bitwise against the plain
            # version
            out = K.w8a8_gemm(yq, ys, wts[0], s, torch.bfloat16)
            ref = K.w8a8_gemm_plain(yq, ys, wts[0], s, torch.bfloat16)
            out32 = K.w8a8_gemm(yq, ys, wts[0], s, torch.float32)
            ref32 = K.w8a8_gemm_plain(yq, ys, wts[0], s, torch.float32)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref) and torch.equal(out32, ref32)):
                err = max((out.float() - ref.float()).abs().max().item(),
                          (out32 - ref32).abs().max().item())
                fail(f"w8a8_gemm differs from its plain version at "
                     f"M={M} D={D} O={O}: max_abs_err={err}")
            del out32, ref32
            ms = cuda_time_ms(
                lambda i: K.w8a8_gemm(yq, ys, wts[i % n_w], s,
                                      torch.bfloat16), 20,
            )
            pms = cuda_time_ms(
                lambda i: K.w8a8_gemm_plain(yq, ys, wts[i % n_w], s,
                                            torch.bfloat16), 3, warmup=1,
            )
            lib = int_mm_ms(yq, ys, ws, s)
            bms, by = bound_ms(M * D + M * 4 + D * O + O * 4 + M * O * 2,
                               2.0 * M * D * O, INT8_OPS_PER_S)
            note("w8a8_gemm", (M, D, O), 0.0, ms, pms, lib, bms, by)
            plan_line(K, M, D, (O,), sms)
            print(f"  {'':17s} kernel / (torch._int_mm + epilogue"
                  f"{'' if M > 16 else ', 17 padded rows'}) "
                  f"{statistics.median(ms) / statistics.median(lib):.3f}",
                  flush=True)
            if M in SERVE_M + OFFLINE_M:
                continue  # the pool and AlignAtt run only the W8A8 pair

            # w8_bf16_gemm on the K-major weight: within W8_BF16_RTOL of
            # the plain version in bf16, 1e-5 in float32 (f32 summation
            # order only)
            y32 = torch.randn((M, D), generator=gen, device=dev) * 2.0
            for yy, rtol in ((y, W8_BF16_RTOL), (y32, 1e-5)):
                out = K.w8_bf16_gemm(yy, wts[0], s)
                ref = K.w8_bf16_gemm_plain(yy, wts[0], s)
                e = (out.float() - ref.float()).abs().max().item()
                lim = rtol * ref.float().abs().max().item()
                if not (e <= lim and torch.isfinite(out).all()):
                    fail(f"w8_bf16_gemm {yy.dtype} at M={M} D={D} O={O}: "
                         f"max_abs_err {e} > {lim}")
                if yy is y:
                    err = e
            ms = cuda_time_ms(lambda i: K.w8_bf16_gemm(y, wts[i % n_w], s),
                              20)
            pms = cuda_time_ms(
                lambda i: K.w8_bf16_gemm_plain(y, wts[i % n_w], s), 3,
                warmup=1,
            )
            lib = cuda_time_ms(
                lambda i: torch._weight_int8pack_mm(y, wts[i % n_w], s), 20
            )
            bms, by = bound_ms(M * D * 2 + D * O + O * 4 + M * O * 2,
                               2.0 * M * D * O, BF16_FLOPS_PER_S)
            note("w8_bf16_gemm", (M, D, O), err, ms, pms, lib, bms, by)
            plan = K.gemm_plan(M, D, O, sms)
            print(f"  {'':17s} plan: {plan.rows} rows a tile, "
                  f"{plan.n_split} split(s) of {plan.k_split} values of D, "
                  f"{plan.n_mtiles * plan.n_otiles * plan.n_split} blocks; "
                  f"kernel / _weight_int8pack_mm "
                  f"{statistics.median(ms) / statistics.median(lib):.3f}",
                  flush=True)
            if plan.n_mtiles != 1:
                fail(f"w8_bf16_gemm at M={M} takes {plan.n_mtiles} row "
                     "tiles: the weight would cross memory more than once")

            # the grouped pair on the same K-major weight (the lm_head
            # shape only under --group-head)
            w8_ms = notes.rows["w8a8_gemm"]["shapes"][(M, D, O)]["ms"]
            check_grouped(K, y, wts[0], sg, GROUP, f"M={M} D={D} O={O}",
                          (torch.bfloat16,))
            gq, gs_ = K.group_quant_int8(y, GROUP)
            if O == TABLE_DO[0][1] or D == 14336:
                ms = cuda_time_ms(lambda i: K.group_quant_int8(y, GROUP), 50)
                pms = cuda_time_ms(
                    lambda i: K.group_quant_int8_plain(y, GROUP), 20)
                # the launch floor: an empty kernel of the same geometry
                qp = K.group_quant_plan(M, D, G, 2)
                fms = cuda_time_ms(
                    lambda i: K.launch_empty(dev, qp.blocks, qp.threads), 50)
                bms, by = bound_ms(M * D * 2 + M * D + M * G * 4, 0, 1.0)
                note("group_quant_int8", (M, D, 0), 0.0, ms, pms, None, bms,
                     by, floor_ms=fms)
                print(f"  {'':17s} plan: {qp.lanes} lanes a group, "
                      f"{qp.blocks} blocks of {qp.threads} threads",
                      flush=True)
            ms = cuda_time_ms(
                lambda i: K.w8a8_grouped_gemm(gq, gs_, wts[i % n_w], sg,
                                              torch.bfloat16), 20)
            pms = None  # the plain version is slow: timed at M = 4, 61
            if M in (4, 61):
                pms = cuda_time_ms(
                    lambda i: K.w8a8_grouped_gemm_plain(
                        gq, gs_, wts[i % n_w], sg, torch.bfloat16), 1,
                    warmup=1)
            bms, by = bound_ms(M * D + M * G * 4 + D * O + G * O * 4
                               + M * O * 2, 2.0 * M * D * O, INT8_OPS_PER_S)
            note("w8a8_grouped_gemm", (M, D, O), 0.0, ms, pms, None, bms, by)
            grouped_plan_line(K, M, D, (O,), sms)
            print(f"  {'':17s} w8a8_gemm on the same bytes {w8_ms:.5f} ms "
                  f"(grouped / w8a8_gemm "
                  f"{statistics.median(ms) / w8_ms:.3f})", flush=True)
        del ws, wts
        torch.cuda.empty_cache()

    check_many(dev, gen, notes, sms)

    # float32 inputs/outputs once per kernel (the tests' dtype)
    y = torch.randn((61, 4096), generator=gen, device=dev)
    w = torch.randint(-127, 128, (4096, 1024), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1024,), generator=gen, device=dev) * 1e-3
    yq, ys = K.row_quant_int8(y)
    pq, ps = K.row_quant_int8_plain(y)
    if not (torch.equal(yq, pq) and torch.equal(ys, ps)):
        fail("row_quant_int8 differs from its plain version in float32")
    wt = w.t().contiguous()
    if not torch.equal(K.w8a8_gemm(yq, ys, wt, s, torch.float32),
                       K.w8a8_gemm_plain(yq, ys, wt, s, torch.float32)):
        fail("w8a8_gemm differs from its plain version in float32")
    sg = torch.rand((4096 // GROUP, 1024), generator=gen, device=dev) * 1e-3
    check_grouped(K, y, wt, sg, GROUP, "float32", (torch.float32,))
    # other group sizes (whole k32 products: 32, 64, 96, whose groups
    # straddle the 128-byte stages, and 256, two stages a group), ragged
    # O and M, split and not, all on the wgmma route
    before = internal_counts()
    kinds = set()
    for M, D, O, gs in GROUPED_EXTRA:
        gp = K.grouped_plan(M, D, D // gs, (O,), sms)
        kinds.add("split" if gp.split_tiles else "whole")
        w = torch.randint(-127, 128, (O, D), generator=gen, device=dev,
                          dtype=torch.int8)
        sg = torch.rand((D // gs, O), generator=gen, device=dev) * 1e-3
        for dt in (torch.bfloat16, torch.float32):
            y = (torch.randn((M, D), generator=gen, device=dev) * 2.0).to(dt)
            check_grouped(K, y, w, sg, gs, f"M={M} D={D} O={O} gs={gs} {dt}",
                          {dt, torch.float32})
    if internal_counts()["w8a8_grouped_gemm_simple"] != \
            before["w8a8_grouped_gemm_simple"] or kinds != {"split", "whole"}:
        fail(f"GROUPED_EXTRA left the wgmma route or did not run both a "
             f"split and a whole-tile plan: {sorted(kinds)}")
    print(f"  the grouped GEMM's wgmma route bitwise at GROUPED_EXTRA "
          f"{GROUPED_EXTRA} (M, D, O, gs), split and whole-tile plans",
          flush=True)
    check_grouped_simple(dev, gen)
    print("  float32 inputs: all five matmul kernels agree with their plain "
          "versions (w8_bf16_gemm at every shape above)", flush=True)
    check_fused(dev, notes)


# the rows the fused quantizers are held and timed at: every path shape
# (a stream's draft and sampling steps 1, the beam step 4, a verify 5, the
# pool's draft 8, spec beam's tree 20, the pool's beam step 32 and verify
# 40, the stream's prefills 61 and 79, StreamAtt's prompt buckets 192 and
# 320, the pool's and AlignAtt's prefills 384 and 448); the norm's width
# (the hidden size) and the SwiGLU product's (the intermediate size)
FUSED_M = [1, 4, 5, 8, 20, 32, 40, 61, 79, 192, 320, 384, 448]
NORM_D, SILU_D = 4096, 14336
NORM_EPS = 1e-5  # Llama-3.1's rms_norm_eps
# the blocks a row of the other plan whose bits are held to the plain
# version's (``_plan_for_test``): a row of D = 4096 over a cluster of 2
# blocks (the path's plan is one block), one of D = 14336 over 2 (the
# path's is 8)
FUSED_OTHER_BLOCKS = 2


def fused_plans(K, D):
    """The path's plan of the fused kernels for rows of D values and the
    other plan checked beside it."""
    return {K.norm_quant_plan(D), K._plan_for_test(D, FUSED_OTHER_BLOCKS)}


def hold_fused(label, got, ref):
    """A fused kernel's outputs against its plain version's, bitwise: h +
    delta (where given), y_q and y_s.  Any difference fails, after the
    count of the codes and scales that differ is printed."""
    import torch

    *gh, gq, gs_ = got
    *rh, rq, rs = ref
    if gh and not torch.equal(gh[0], rh[0]):
        fail(f"{label}: h + delta differs from the plain version's")
    if torch.equal(gq, rq) and torch.equal(gs_, rs):
        return
    dq = (gq.int() - rq.int()).abs()
    rel = ((gs_ - rs).abs() / rs.abs()).max().item()
    nq, ns = int((dq != 0).sum()), int((gs_ != rs).sum())
    fail(f"{label}: not bitwise the plain version's: {nq} of {dq.numel()} "
         f"codes (max {int(dq.max())}) and {ns} of {rs.numel()} scales (max "
         f"relative {rel:.3e}) differ")


def check_fused(dev, notes):
    """rms_norm_quant_int8 (D = NORM_D: with and without the residual
    delta, bf16 and float32 rows, bf16 and float32 norm scales) and
    silu_mul_quant_int8 (D = SILU_D, bf16 and float32) against their plain
    versions at FUSED_M rows, one scale a row and in groups of GROUP:
    bitwise (hold_fused), under the path's plan of the blocks a row and
    one other (fused_plans: a row's result does not depend on the
    launch).  Timed on the path's
    inputs (bf16 rows, the residual, bf16 scales) beside an empty kernel of
    the same geometry (the launch floor), the eager composition the kernel
    replaced (the residual add, llama._rms_norm's or torch's SwiGLU
    product's launches, then the quantizer) and the standalone quantizer
    at the same D."""
    import torch

    from infinisst_tpu_torch.kernels import quant_matmul as K
    from infinisst_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(17)
    med = statistics.median
    n = 0
    bf = torch.bfloat16

    def randn(M, D, dt, scale=1.0):
        return (torch.randn((M, D), generator=gen, device=dev) * scale
                ).to(dt)

    for M in FUSED_M:
        for dt in (bf, torch.float32):
            h, d = randn(M, NORM_D, dt, 3.0), randn(M, NORM_D, dt)
            g, u = randn(M, SILU_D, dt, 3.0), randn(M, SILU_D, dt)
            for sdt in (bf, torch.float32):
                sc = (torch.rand((NORM_D,), generator=gen, device=dev)
                      + 0.5).to(sdt)
                for delta in (d, None):
                    for gs in (NORM_D, GROUP):
                        ref = K.rms_norm_quant_int8_plain(h, delta, sc,
                                                          NORM_EPS, gs)
                        for plan in fused_plans(K, NORM_D):
                            got = K.rms_norm_quant_int8(h, delta, sc,
                                                        NORM_EPS, gs,
                                                        _plan=plan)
                            hold_fused(
                                f"rms_norm_quant_int8 M={M} {dt} scale "
                                f"{sdt} delta={delta is not None} gs={gs} "
                                f"blocks={plan.blocks}", got, ref)
                            n += 1
            for gs in (SILU_D, GROUP):
                ref = K.silu_mul_quant_int8_plain(g, u, gs)
                for plan in fused_plans(K, SILU_D):
                    got = K.silu_mul_quant_int8(g, u, gs, _plan=plan)
                    hold_fused(f"silu_mul_quant_int8 M={M} {dt} gs={gs} "
                               f"blocks={plan.blocks}", got, ref)
                    n += 1
    torch.cuda.synchronize()
    print(f"  rms_norm_quant_int8 and silu_mul_quant_int8: {n} calls at "
          f"M = {FUSED_M}, both plans, all bitwise their plain versions",
          flush=True)

    # times on the path's inputs
    for M in FUSED_M:
        h, d = randn(M, NORM_D, bf, 3.0), randn(M, NORM_D, bf)
        sc = (torch.rand((NORM_D,), generator=gen, device=dev) + 0.5).to(bf)
        g, u = randn(M, SILU_D, bf, 3.0), randn(M, SILU_D, bf)
        for gs in (NORM_D, GROUP):
            quant = (K.row_quant_int8 if gs == NORM_D else
                     lambda y: K.group_quant_int8(y, GROUP))
            plan = K.norm_quant_plan(NORM_D)
            G = NORM_D // gs
            ms = cuda_time_ms(lambda i: K.rms_norm_quant_int8(
                h, d, sc, NORM_EPS, gs), 50)
            pms = cuda_time_ms(lambda i: K.rms_norm_quant_int8_plain(
                h, d, sc, NORM_EPS, gs), 20)
            fms = cuda_time_ms(lambda i: K.launch_empty_rows(dev, plan, M),
                               50)
            eager = cuda_time_ms(lambda i: quant(llama._rms_norm(
                h + d, sc, NORM_EPS)), 20)
            qms = cuda_time_ms(lambda i: quant(h), 50)
            bms, by = bound_ms(3 * M * NORM_D * 2 + NORM_D * 2 + M * NORM_D
                               + M * G * 4, 0, 1.0)
            key = (M, NORM_D, 0) if gs == NORM_D else ("g128", M, NORM_D, 0)
            _note_fused(notes, "rms_norm_quant_int8", key, ms, pms, bms, by,
                        fms, eager, qms, M, NORM_D, gs, plan)
        for gs in (SILU_D, GROUP):
            quant = (K.row_quant_int8 if gs == SILU_D else
                     lambda y: K.group_quant_int8(y, GROUP))
            plan = K.norm_quant_plan(SILU_D)
            G = SILU_D // gs
            ms = cuda_time_ms(lambda i: K.silu_mul_quant_int8(g, u, gs), 50)
            pms = cuda_time_ms(lambda i: K.silu_mul_quant_int8_plain(
                g, u, gs), 20)
            fms = cuda_time_ms(lambda i: K.launch_empty_rows(dev, plan, M),
                               50)
            eager = cuda_time_ms(lambda i: quant(
                torch.nn.functional.silu(g) * u), 20)
            qms = cuda_time_ms(lambda i: quant(g), 50)
            bms, by = bound_ms(2 * M * SILU_D * 2 + M * SILU_D + M * G * 4,
                               0, 1.0)
            key = (M, SILU_D, 0) if gs == SILU_D else ("g128", M, SILU_D, 0)
            _note_fused(notes, "silu_mul_quant_int8", key, ms, pms, bms, by,
                        fms, eager, qms, M, SILU_D, gs, plan)


def _note_fused(notes, name, key, ms, pms, bms, by, fms, eager, qms, M, D,
                gs, plan):
    """Note a fused kernel's times with its launch floor, and print them
    beside the eager composition it replaced and the standalone
    quantizer (kept in the note as ``eager_ms`` and ``quantizer_ms``)."""
    med = statistics.median
    notes.note(name, key, 0.0, ms, pms, None, bms, by,
               label=f"M={M:3d} D={D:5d} gs={gs:5d}", floor_ms=fms)
    notes.rows[name]["shapes"][key].update(eager_ms=med(eager),
                                           quantizer_ms=med(qms))
    print(f"  {'':17s} {plan.blocks} block(s) of {plan.threads} threads a "
          f"row; the eager composition it replaced {med(eager):.5f} ms "
          f"(kernel / eager {med(ms) / med(eager):.3f}); the quantizer "
          f"alone {med(qms):.5f} ms (kernel / quantizer "
          f"{med(ms) / med(qms):.3f})", flush=True)


# the weights that share an input at the flagship (one w8a8_gemm_many
# launch each) and the rows they are held and timed at
MANY_WEIGHTS = (("q|k|v", 4096, (4096, 1024, 1024)),
                ("gate|up", 4096, (14336, 14336)))
MANY_M = [1, 4, 32, 79, 384]


def check_many(dev, gen, notes, sms):
    """w8a8_gemm_many (one launch) bitwise against w8a8_gemm_many_plain in
    bf16 and float32 at q|k|v and gate|up for MANY_M rows; timed beside
    the same weights one w8a8_gemm launch each and beside torch._int_mm +
    the scale epilogue over the concatenated (D, sum O) weight (the
    activations zero-padded to 17 rows at M <= 16).  The same for
    w8a8_grouped_gemm_many on the weights grouped by GROUP, timed beside
    one w8a8_grouped_gemm launch a weight."""
    import torch

    from infinisst_tpu_torch.kernels import quant_matmul as K

    for label, D, Os in MANY_WEIGHTS:
        O = sum(Os)
        n_w = max(2, math.ceil(120e6 / (D * O)))
        cat = [torch.randint(-127, 128, (D, O), generator=gen, device=dev,
                             dtype=torch.int8) for _ in range(n_w)]
        # the K-major leaves, packed once, as the model holds them
        edge = [sum(Os[:j]) for j in range(len(Os) + 1)]
        wts = [[c[:, edge[j]:edge[j + 1]].t().contiguous()
                for j in range(len(Os))] for c in cat]
        ss = [torch.rand((o,), generator=gen, device=dev) * 1e-3 + 1e-4
              for o in Os]
        s_cat = torch.cat(ss)
        for M in MANY_M:
            y = (torch.randn((M, D), generator=gen, device=dev) * 2.0
                 ).to(torch.bfloat16)
            yq, ys = K.row_quant_int8(y)
            for dt in (torch.bfloat16, torch.float32):
                got = K.w8a8_gemm_many(yq, ys, wts[0], ss, dt)
                want = K.w8a8_gemm_many_plain(yq, ys, wts[0], ss, dt)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"w8a8_gemm_many differs from its plain version at "
                         f"{label} M={M} {dt}")
            ms = cuda_time_ms(lambda i: K.w8a8_gemm_many(
                yq, ys, wts[i % n_w], ss, torch.bfloat16), 20)
            sep = cuda_time_ms(lambda i: [
                K.w8a8_gemm(yq, ys, w, s, torch.bfloat16)
                for w, s in zip(wts[i % n_w], ss)], 20)
            pms = cuda_time_ms(lambda i: K.w8a8_gemm_many_plain(
                yq, ys, wts[i % n_w], ss, torch.bfloat16), 3, warmup=1)
            lib = int_mm_ms(yq, ys, cat, s_cat)
            bms, by = bound_ms(M * D + M * 4 + D * O + O * 4 + M * O * 2,
                               2.0 * M * D * O, INT8_OPS_PER_S)
            notes.note("w8a8_gemm", (M, D, O), 0.0, ms, pms, lib, bms, by,
                       label=f"M={M:3d} {label:7s} D={D} O={O}")
            plan_line(K, M, D, Os, sms)
            print(f"  {'':17s} one launch / {len(Os)} launches "
                  f"{statistics.median(ms) / statistics.median(sep):.3f} "
                  f"({statistics.median(sep):.5f} ms); kernel / "
                  f"(torch._int_mm + epilogue"
                  f"{'' if M > 16 else ', 17 padded rows'}) "
                  f"{statistics.median(ms) / statistics.median(lib):.3f}",
                  flush=True)
            # the same weights grouped by GROUP, one w8a8_grouped_gemm_many
            # launch (the --group128 stream's q|k|v and gate|up)
            sgs = [torch.rand((D // GROUP, o), generator=gen, device=dev)
                   * 1e-3 + 1e-4 for o in Os]
            gq, gs_ = K.group_quant_int8(y, GROUP)
            for dt in (torch.bfloat16, torch.float32):
                got = K.w8a8_grouped_gemm_many(gq, gs_, wts[0], sgs, dt)
                want = K.w8a8_grouped_gemm_many_plain(gq, gs_, wts[0], sgs,
                                                      dt)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"w8a8_grouped_gemm_many differs from its plain "
                         f"version at {label} M={M} {dt}")
            gms = cuda_time_ms(lambda i: K.w8a8_grouped_gemm_many(
                gq, gs_, wts[i % n_w], sgs, torch.bfloat16), 20)
            gsep = cuda_time_ms(lambda i: [
                K.w8a8_grouped_gemm(gq, gs_, w, sg, torch.bfloat16)
                for w, sg in zip(wts[i % n_w], sgs)], 20)
            G = D // GROUP
            bms, by = bound_ms(M * D + M * G * 4 + D * O + G * O * 4
                               + M * O * 2, 2.0 * M * D * O, INT8_OPS_PER_S)
            notes.note("w8a8_grouped_gemm", (M, D, O), 0.0, gms, None, None,
                       bms, by, label=f"M={M:3d} {label:7s} D={D} O={O}")
            grouped_plan_line(K, M, D, Os, sms)
            print(f"  {'':17s} grouped: one launch / {len(Os)} launches "
                  f"{statistics.median(gms) / statistics.median(gsep):.3f} "
                  f"({statistics.median(gsep):.5f} ms); grouped / "
                  f"w8a8_gemm_many "
                  f"{statistics.median(gms) / statistics.median(ms):.3f}",
                  flush=True)
        del cat, wts
        torch.cuda.empty_cache()


def check_grouped_simple(dev, gen):
    """The grouped pair's simple route (every group size that divides D,
    any O) bitwise against the plain versions at GROUPED_SIMPLE, in bf16
    and float32, and taken by both wrappers."""
    import torch

    K, _ = _kernel_modules()
    before = internal_counts()
    for M, D, O, gs in GROUPED_SIMPLE:
        w = torch.randint(-127, 128, (O, D), generator=gen, device=dev,
                          dtype=torch.int8)
        sg = torch.rand((D // gs, O), generator=gen, device=dev) * 1e-3
        if K.grouped_on_wgmma(D, D // gs, O):
            fail(f"gs={gs} O={O} is on the wgmma route")
        for dt in (torch.bfloat16, torch.float32):
            y = (torch.randn((M, D), generator=gen, device=dev) * 2.0).to(dt)
            check_grouped(K, y, w, sg, gs, f"M={M} D={D} O={O} gs={gs} {dt}",
                          {dt, torch.float32})
    after = internal_counts()
    took = {k: after[k] - before[k] for k in ("group_quant_int8_simple",
                                              "w8a8_grouped_gemm_simple")}
    if not all(took.values()):
        fail(f"the grouped pair's simple route was not taken: {took}")
    print(f"  the grouped pair's simple route bitwise at {GROUPED_SIMPLE} "
          f"(M, D, O, gs): {json.dumps(took)} calls", flush=True)


# ---------------------------------------------------------------------------
# the speculative stack and sampling


def check_spec_kernels(dev, notes):
    """row_quant_int8 and w8a8_gemm bitwise against their plain versions
    at the speculative stack's rows (SPEC_M) on every projection, the
    padded lm_head and a 16384-column shortlist head; kernel times and
    bounds, the plain version and torch._int_mm + epilogue at M = 20 and
    40.  decode_attention at beam 1 (the sampler's and the greedy
    fallback's two blocks) and at the tree verify's prefix (20 node rows
    against one cache, with lse)."""
    import torch

    from infinisst_tpu_torch.kernels import quant_matmul as K

    gen = torch.Generator(device=dev).manual_seed(9)
    note = notes.note
    for D, O in TABLE_DO + [SHORTLIST_DO]:
        n_w = max(1, math.ceil(120e6 / (D * O)))
        ws = [torch.randint(-127, 128, (D, O), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(n_w)]
        wts = [w.t().contiguous() for w in ws]
        s = torch.rand((O,), generator=gen, device=dev) * 1e-3 + 1e-4
        for M in SPEC_M:
            y = (torch.randn((M, D), generator=gen, device=dev) * 2.0
                 ).to(torch.bfloat16)
            yq, ys = K.row_quant_int8(y)
            pq, ps = K.row_quant_int8_plain(y)
            if not (torch.equal(yq, pq) and torch.equal(ys, ps)):
                fail(f"row_quant_int8 differs from its plain version at "
                     f"M={M} D={D}")
            if O == TABLE_DO[0][1] or D == 14336:
                ms = cuda_time_ms(lambda i: K.row_quant_int8(y), 50)
                pms = cuda_time_ms(lambda i: K.row_quant_int8_plain(y), 20)
                bms, by = bound_ms(M * D * 2 + M * D + M * 4, 0, 1.0)
                note("row_quant_int8", (M, D, 0), 0.0, ms, pms, None, bms,
                     by)
            out = K.w8a8_gemm(yq, ys, wts[0], s, torch.bfloat16)
            ref = K.w8a8_gemm_plain(yq, ys, wts[0], s, torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                err = (out.float() - ref.float()).abs().max().item()
                fail(f"w8a8_gemm differs from its plain version at M={M} "
                     f"D={D} O={O}: max_abs_err={err}")
            ms = cuda_time_ms(lambda i: K.w8a8_gemm(
                yq, ys, wts[i % n_w], s, torch.bfloat16), 20)
            pms = lib = None
            if M > 16 or (M, D, O) == SPEC_SHAPE:
                pms = cuda_time_ms(lambda i: K.w8a8_gemm_plain(
                    yq, ys, wts[i % n_w], s, torch.bfloat16), 3, warmup=1)
            if M > 16:  # torch._int_mm's shape rule, then the epilogue
                lib = cuda_time_ms(
                    lambda i: (torch._int_mm(yq, ws[i % n_w]).float() * ys
                               * s).to(torch.bfloat16), 20)
            bms, by = bound_ms(M * D + M * 4 + D * O + O * 4 + M * O * 2,
                               2.0 * M * D * O, INT8_OPS_PER_S)
            note("w8a8_gemm", (M, D, O), 0.0, ms, pms, lib, bms, by)
            if lib is not None:
                print(f"  {'':17s} kernel / (torch._int_mm + epilogue) "
                      f"{statistics.median(ms) / statistics.median(lib):.3f}",
                      flush=True)
        del ws, wts
        torch.cuda.empty_cache()
    for case in SPEC_ATT_CASES:
        att_case(dev, gen, notes, *case, dtype=torch.bfloat16, timed=True)
        att_case(dev, gen, notes, *case, dtype=torch.float32, timed=False)


# (label, B, Bc, C, valid, key offset, lse) as in _att_cases: beam 1's two
# blocks, and the tree verify's prefix (spec beam, k = 4, 4 beams)
SPEC_ATT_CASES = [
    ("beam1 prefix", 1, 1, 1280, [1000], None, True),
    ("beam1 per-beam block", 1, 1, 10, [4], [1000], True),
    ("tree prefix", 20, 1, 1280, [1000], None, True),
]
SPEC_ATT_SHAPE = ("tree prefix", 20, 1280)  # the kernels line's spec entry


def _tokens_by_chunk(agent, n=3, seed=5):
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        before = len(agent.states.target_ids)
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1,
                   finished=(i == n - 1))
        out.append(list(agent.states.target_ids[before:]))
    return out


# the [spec tiny] agents (float32, the tiny model of check_tiny): each
# speculative or sampling mode beside the plain decoder it must equal
SPEC_TINY = {
    "greedy": dict(beam=1),
    "spec greedy": dict(beam=1, speculative=True, spec_draft_layers=1,
                        spec_k=3, spec_guard=False),
    "beam 4": dict(beam=4),
    "spec beam 4": dict(beam=4, speculative=True, spec_beam=True,
                        spec_draft_layers=1, spec_k=3, spec_guard=False),
    "sample top_k 1": dict(beam=1, do_sample=True, top_k=1),
    "spec sample top_k 1": dict(beam=1, do_sample=True, top_k=1,
                                speculative=True, spec_draft_layers=1,
                                spec_k=3, spec_guard=False),
    "sample": dict(do_sample=True, temperature=1.2, top_k=8, sample_seed=4),
    "spec sample": dict(do_sample=True, temperature=1.2, top_k=8,
                        sample_seed=4, speculative=True,
                        spec_draft_layers=1, spec_k=3, spec_guard=False),
}
SPEC_TINY_EQUAL = (("spec greedy", "greedy"), ("spec beam 4", "beam 4"),
                   ("sample top_k 1", "greedy"),
                   ("spec sample top_k 1", "greedy"))
SPEC_TINY_SEEDED = ("sample", "spec sample")


def check_spec_tiny(dev, f32_params):
    """The tiny float32 agent on the card and on the CPU in every
    speculative and sampling mode: speculative greedy, top_k 1 sampling
    (plain and speculative) equal to beam 1 greedy and speculative beam
    4 to plain beam 4, chunk by chunk, on each device; every such mode's
    tokens equal card against CPU; a seeded sampling run (plain and
    speculative) equal to its repeat on each device (the card's draws
    come from a CUDA generator, the CPU's from a CPU one, so the seeded
    runs are not compared across devices)."""
    outs = {}
    for device in ("cpu", dev):
        for name, kw in SPEC_TINY.items():
            agent, _ = tiny_agent(device, f32_params, **kw)
            outs[(str(device), name)] = _tokens_by_chunk(agent)
            if name in SPEC_TINY_SEEDED:
                again, _ = tiny_agent(device, f32_params, **kw)
                if _tokens_by_chunk(again) != outs[(str(device), name)]:
                    fail(f"[spec tiny] {name} on {device}: a seeded run "
                         "differs from its repeat")
        for a, b in SPEC_TINY_EQUAL:
            if outs[(str(device), a)] != outs[(str(device), b)]:
                fail(f"[spec tiny] {a} differs from {b} on {device}: "
                     f"{outs[(str(device), a)]} vs {outs[(str(device), b)]}")
    for name in SPEC_TINY:
        got, want = outs[(str(dev), name)], outs[("cpu", name)]
        print(f"  {name:20s} {dev}={got}", flush=True)
        if name not in SPEC_TINY_SEEDED and got != want:
            fail(f"[spec tiny] {name}: the card's tokens {got} differ from "
                 f"the CPU's {want}")
    if not any(outs[(str(dev), "greedy")]):
        fail("[spec tiny] the tiny agent emitted nothing")
    print("  equal on both devices: " + ", ".join(
        f"{a} = {b}" for a, b in SPEC_TINY_EQUAL) + "; card = CPU in every "
          "unseeded mode; seeded sampling = its repeat", flush=True)


# per forward by function: attention launches a layer (the beam step's two
# blocks in one beam_attention, the tree verify's prefix through
# decode_attention; a decode_step attends in plain torch), and which
ATT_PER_LAYER = {"decode_step": 0, "beam_token_step": 1, "beam_tree_step": 1}
ATT_KERNEL = {"beam_token_step": "beam_attention",
              "beam_tree_step": "decode_attention"}


def expected_launches(forwards) -> dict:
    """The kernel launches the bench's model forwards ({"fn L=n": count})
    must make at the flagship W8A8 with an int8 (full or shortlist) head:
    ``a8_forward_launches(n)`` a forward of n layers (w8a8_gemm 4n + 1,
    rms_norm_quant_int8 2n + 1, silu_mul_quant_int8 n, row_quant_int8 n),
    beam_attention and decode_attention by ATT_PER_LAYER and ATT_KERNEL,
    no other kernel."""
    want = dict.fromkeys(("w8a8_gemm", "row_quant_int8", "decode_attention",
                          "beam_attention", "w8_bf16_gemm",
                          "group_quant_int8", "w8a8_grouped_gemm",
                          "rms_norm_quant_int8", "silu_mul_quant_int8"), 0)
    for key, n in forwards.items():
        fn, L = key.split(" L=")
        L = int(L)
        for k, v in a8_forward_launches(L).items():
            want[k] += n * v
        if ATT_PER_LAYER[fn]:
            want[ATT_KERNEL[fn]] += n * L * ATT_PER_LAYER[fn]
    return want


def run_main(module: str, argv) -> subprocess.CompletedProcess:
    """``python -m module *argv`` in this process: ``module.main(argv)``
    with its standard output and error captured, as a process of its own
    would start it.  Before it, the kernels' launch counts, llama's forward
    counts and the peak memory statistic are zeroed (the module's reports
    count from its start); cuDNN's TF32 is at torch's default while it
    runs; after it, what it left is collected and the cache emptied.  A
    process of its own would spend ~10 s importing torch on the H100
    machine before its first line; the checks read the same lines."""
    import gc
    import importlib
    import io
    import traceback

    import torch

    from infinisst_tpu_torch.models import llama

    mod = importlib.import_module(module)
    reset_counts()
    llama.forward_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    rc = 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                mod.main(list(argv))
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else int(
                    e.code is not None)
            except Exception:  # the traceback is the process's last words
                traceback.print_exc()
                rc = 1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        gc.collect()
        torch.cuda.empty_cache()
    return subprocess.CompletedProcess([module] + list(argv), rc,
                                       out.getvalue(), err.getvalue())


def run_bench_line(extra, label, metric, keys):
    """``python -m infinisst_tpu_torch.bench`` + ``extra`` (``run_main``):
    exit 0, its last stdout line a JSON line with ``metric`` and
    ``keys``, its launches those its model forwards make
    (expected_launches).  Returns (result, launches, forwards)."""
    out = run_main("infinisst_tpu_torch.bench", extra)
    for line in out.stderr.strip().splitlines()[-8:]:
        print(f"[{label}]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[{label}] bench {' '.join(extra)} exited {out.returncode}")
    lines = out.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"[{label}] its last stdout line is not JSON: {lines[-1:]}")
    missing = [k for k in keys if k not in result]
    if result.get("metric") != metric or missing:
        fail(f"[{label}] metric {result.get('metric')!r} (expected "
             f"{metric!r}), missing keys {missing}")
    if not (math.isfinite(result["value"]) and result["value"] > 0):
        fail(f"[{label}] value {result['value']}")
    counts = _stderr_json(out.stderr, "kernel launches ")
    fwd = _stderr_json(out.stderr, "model forwards ")
    if counts is None or fwd is None:
        fail(f"[{label}] the bench did not report its launches and "
             "forwards")
    want = expected_launches(fwd)
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        fail(f"[{label}] launches {got} for forwards {fwd}; expected {want}")
    print(f"[{label}] {json.dumps(result)}", flush=True)
    print(f"[{label}] forwards {fwd}: launches {got} (a forward of n "
          f"layers: {A8_TEXT})", flush=True)
    return result, got, fwd


SPEC_KEYS = BENCH_KEYS + ("accept_rate", "rounds", "emitted",
                          "guard_fallback", "fallback_warmed",
                          "breakeven_tokens_per_round")
SAMPLE_METRIC = "streaming_rtf_m1_sample_8b_int8"
SPEC_SERVE_KEYS = SERVE_KEYS + ("accept_rate", "guard_fallback",
                                "fallback_warmed")


def check_spec_bench(paths):
    """The bench's speculative and sampling streams at the flagship W8A8
    (m = 1, d = 8, k = 4, SPEC_BENCH_CHUNKS chunks): --speculative (the
    random draft accepts ~nothing, so the guard trips and the stream
    runs beam 1 greedy), --spec-resid-scale 0 --spec-no-guard (the
    layers above the draft are identities: accept_rate > 0 through the
    real verify), --spec-beam, --do-sample and --speculative
    --do-sample.  Each holds its launches to its forwards."""
    n = ["--chunks", str(SPEC_BENCH_CHUNKS)]
    runs = [
        ("spec", ["--speculative"], "streaming_rtf_m1_spec_d8k4_8b_int8"),
        ("spec resid 0", ["--speculative", "--spec-resid-scale", "0",
                          "--spec-no-guard"],
         "streaming_rtf_m1_spec_d8k4_ra0_8b_int8"),
        ("spec beam", ["--speculative", "--spec-beam"],
         "streaming_rtf_m1_spec_beam4_d8k4_8b_int8"),
        ("sample", ["--do-sample"], SAMPLE_METRIC),
        ("spec sample", ["--speculative", "--do-sample"],
         "streaming_rtf_m1_spec_sample_d8k4_8b_int8"),
    ]
    total = {}
    for name, extra, metric in runs:
        keys = BENCH_KEYS if name == "sample" else SPEC_KEYS
        result, got, fwd = run_bench_line(extra + n, f"spec bench {name}",
                                          metric, keys)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        if name == "spec" and not result["guard_fallback"]:
            fail("[spec bench] --speculative: the guard did not trip on the "
                 f"random draft (accept_rate {result['accept_rate']})")
        if name == "spec resid 0" and not result["accept_rate"] > 0:
            fail("[spec bench] --spec-resid-scale 0: accept_rate "
                 f"{result['accept_rate']}")
        if name == "spec beam" and not fwd.get("beam_tree_step L=32"):
            fail("[spec bench] --spec-beam ran no tree verify")
        if name == "sample" and not fwd.get("beam_token_step L=32"):
            fail("[spec bench] --do-sample ran no sampling step")
        drafts = (fwd.get("decode_step L=8", 0)
                  + fwd.get("beam_token_step L=8", 0))
        if name.startswith("spec") and not drafts:
            fail(f"[spec bench] {name} ran no draft forward")
    paths["spec"] = ("bench --speculative, --spec-beam, --do-sample "
                     f"(5 runs of {SPEC_BENCH_CHUNKS} chunks)", total)


def check_spec_serve(paths):
    """The bench's serve mode with --speculative and with --speculative
    --do-sample at pool 8 (beam 1), 12 timed ticks; launches held to the
    forwards."""
    total = {}
    for extra, metric in (
            (["--speculative"],
             "serve_decode_tok_per_s_pool8_specd8k4_m1_8b_int8"),
            (["--speculative", "--do-sample"],
             "serve_decode_tok_per_s_pool8_specSd8k4_m1_8b_int8")):
        _, got, _ = run_bench_line(["--mode", "serve"] + extra,
                                   "spec serve", metric, SPEC_SERVE_KEYS)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    paths["spec serve"] = ("bench --mode serve --speculative [--do-sample]",
                           total)


# ---------------------------------------------------------------------------
# phase 4: decode attention

# (label, B, Bc, C, valid (Bc,), key offset (Bc,) or None, lse): the beam
# step's two blocks at the flagship geometry (a chunk's prefix of valid_len
# 1000 in a 1280-slot cache; the per-beam block of 10 slots at gen_len 3,
# keys at plen + j), the serving pool's two blocks (8 slots of 4 beams: 8
# prefix caches of valid_len 1000, each read by its slot's beams; the
# per-beam block of 32 rows), then decode_attention_batched at the pooled
# shapes of tools_ab_attention.py (valid_len spread over [C/2, C)).
ATT_HEADS = (32, 8, 128)  # H, KV, Dh


def _att_cases():
    cases = [("beam prefix", 4, 1, 1280, [1000], None, True),
             ("beam per-beam block", 4, 4, 10, [4] * 4, [1000] * 4, True),
             ("pool prefix", 32, 8, 1280, [1000] * 8, None, True),
             ("pool per-beam block", 32, 32, 10, [4] * 32, [1000] * 32,
              True),
             # an AlignAtt call at the 28.8 s cap with 64 target ids in its
             # prompt (447 valid in a 512-slot cache); the bench's random
             # weights emit no target, so its calls run the shapes that
             # hold_offline_attention takes from them
             ("alignatt 64-target prefix", 4, 1, 512, [447], None, True),
             ("alignatt 64-target per-beam", 4, 4, 64, [1, 22, 43, 64],
              [447] * 4, True)]
    for B in (4, 16):
        for C in (1280, 4096):
            valid = [C // 2 + (C // 2) * i // B for i in range(B)]
            cases.append((f"batched B={B} C={C}", B, B, C, valid, None,
                          False))
    return cases


def att_case(dev, gen, notes, label, B, Bc, C, valid, off, lse, dtype, timed,
             q_pos=None, heads=ATT_HEADS):
    """decode_attention at one shape against its plain version: output
    (and lse) within ATT_RTOL; timed, with the SDPA yardstick and the
    bound, into ``notes`` under (label, B, C).  The queries sit at
    ``q_pos`` (default: 3 past the last valid key); ``heads`` is (H, KV,
    Dh)."""
    import torch
    import torch.nn.functional as F

    from infinisst_tpu_torch.core import rope as R
    from infinisst_tpu_torch.kernels import decode_attention as A

    H, KV, Dh = heads
    inv = torch.tensor(R.llama_rope_freqs(Dh), dtype=torch.float32,
                       device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
    kv_bytes = 2 * Bc * C * KV * Dh * q.element_size()
    # enough cache copies to exceed the 50 MB L2: each layer's cache is
    # read cold on the main path
    n_c = max(1, math.ceil(120e6 / kv_bytes)) if timed else 1
    ks = [torch.randn((Bc, C, KV, Dh), generator=gen, device=dev).to(dtype)
          for _ in range(n_c)]
    vs = [torch.randn((Bc, C, KV, Dh), generator=gen, device=dev).to(dtype)
          for _ in range(n_c)]
    vl = torch.tensor(valid, **i32)
    base = 0 if off is None else off[0]
    qp = torch.tensor([base + max(valid) + 3 if q_pos is None else q_pos]
                      * B, **i32)
    ko = None if off is None else torch.tensor(off, **i32)

    def kernel(i):
        return A.decode_attention(q, ks[i % n_c], vs[i % n_c], vl, qp, inv,
                                  key_offset=ko, return_lse=lse)

    def plain(i):
        return A.decode_attention_plain(q, ks[i % n_c], vs[i % n_c], vl, qp,
                                        inv, ko, lse)

    got, ref = kernel(0), plain(0)
    torch.cuda.synchronize()
    pairs = list(zip(got, ref)) if lse else [(got, ref)]
    rtol = ATT_RTOL["bf16" if dtype == torch.bfloat16 else "f32"]
    err = 0.0
    for n, (g, r) in enumerate(pairs):
        e = (g.float() - r.float()).abs().max().item()
        lim = (rtol if n == 0 else ATT_RTOL["f32"]) * \
            r.float().abs().max().item()
        if not (e <= lim and torch.isfinite(g).all()):
            fail(f"decode_attention {label} {dtype}: "
                 f"{'lse' if n else 'out'} max_abs_err {e} > {lim}")
        err = max(err, e)
    if not timed:
        print(f"  decode_attention  {label} {dtype}: max_abs_err "
              f"{err:.3e} (within {rtol} x max|plain|)", flush=True)
        return
    ms = cuda_time_ms(kernel, 20)
    pms = cuda_time_ms(plain, 3, warmup=1)
    # library yardstick: SDPA over keys rotated beforehand (not timed: SDPA
    # has no rotate-on-read), the valid_len mask as a boolean mask; the
    # shared prefix folds the beams into its query length
    kpos = torch.arange(C, device=dev)[None] + (
        0 if ko is None else ko[:, None])
    krs = [R.apply_llama_rope(k.transpose(1, 2), kpos[:, None], inv)
           for k in ks]
    vts = [v.transpose(1, 2).contiguous() for v in vs]
    qr = R.apply_llama_rope(q[:, :, None], qp[:, None, None], inv)
    if B > Bc:  # a cache's rows as its query length: (Bc, H, B/Bc, Dh)
        qr = qr.reshape(Bc, B // Bc, H, Dh).permute(0, 2, 1, 3)
        qr = qr.contiguous()
    mask = (torch.arange(C, device=dev)[None] < vl[:, None])[
        :, None, None, :]
    lib = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qr, krs[i % n_c], vts[i % n_c], attn_mask=mask, enable_gqa=True), 20)
    c_eff = [min(v, C) if v > 0 else C for v in valid]
    nbytes = (sum(c_eff) * 2 * KV * Dh * q.element_size()
              + 2 * q.numel() * q.element_size() + Bc * 8
              + (B * H * 4 if lse else 0))
    rows_per_cache = B // Bc
    ops = sum(4.0 * rows_per_cache * H * c * Dh for c in c_eff)
    bms, by = bound_ms(nbytes, ops, BF16_FLOPS_PER_S)
    notes.note("decode_attention", (label, B, C), err, ms, pms, lib, bms, by,
               label=f"{label:21s} B={B:2d} Bc={Bc:2d} C={C:5d}")


# (label, B, P, C, plen (P,), G, g_valid (B,)): beam_attention, the beam
# step's two blocks in one launch, at its paths' shapes: the stream (a
# chunk's prefix of 1000 in 1280 slots, the per-beam block of 10 slots at
# gen_len 3, key j at plen + j), the serving pool (8 slots of 4 beams),
# an AlignAtt call with 64 target ids (447 of 512, the per-beam block of
# 64 slots at gen lens 1-64), a StreamAtt call (183 of 256), beam 1 (the
# sampler's and the greedy fallback's step)
BEAM_CASES = [
    ("stream", 4, 1, 1280, [1000], 10, [4] * 4),
    ("pool", 32, 8, 1280, [1000] * 8, 10, [4] * 32),
    ("alignatt 64-target", 4, 1, 512, [447], DECODE_BUF_TOKENS,
     [1, 22, 43, 64]),
    ("streamatt", 4, 1, 256, [183], DECODE_BUF_TOKENS, [1, 22, 43, 64]),
    ("beam 1", 1, 1, 1280, [1000], 10, [4]),
]
BEAM_REPORT = ("stream", 4, 1280)  # the kernels line's shape (Notes key)
BEAM_POOL = ("pool", 32, 1280)


def beam_case(dev, gen, notes, label, B, P, C, plen, G, g_valid, dtype,
              timed, q_pos=None, heads=ATT_HEADS):
    """beam_attention at one shape against beam_attention_plain: output
    and lse within ATT_RTOL; timed, with the SDPA yardstick (over every
    row's prefix and per-beam keys concatenated, rotated beforehand) and
    the bound, into ``notes`` under (label, B, C).  Row b's query sits at
    ``q_pos`` (default: its newest per-beam key's position)."""
    import torch
    import torch.nn.functional as F

    from infinisst_tpu_torch.core import rope as R
    from infinisst_tpu_torch.kernels import decode_attention as A

    H, KV, Dh = heads
    inv = torch.tensor(R.llama_rope_freqs(Dh), dtype=torch.float32,
                       device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    es = torch.empty((), dtype=dtype).element_size()
    kv_bytes = 2 * (P * C + B * G) * KV * Dh * es
    n_c = max(1, math.ceil(120e6 / kv_bytes)) if timed else 1

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q = rnd(B, H, Dh)
    pk, pv = [rnd(P, C, KV, Dh) for _ in range(n_c)], \
        [rnd(P, C, KV, Dh) for _ in range(n_c)]
    gk, gv = [rnd(B, G, KV, Dh) for _ in range(n_c)], \
        [rnd(B, G, KV, Dh) for _ in range(n_c)]
    pl = torch.tensor(plen, **i32)
    gvl = torch.tensor(g_valid, **i32)
    goff = pl.repeat_interleave(B // P).contiguous()
    qp = (goff + torch.clamp(gvl - 1, min=0)).contiguous() if q_pos is None \
        else torch.tensor([q_pos] * B, **i32)

    def kernel(i):
        k = i % n_c
        return A.beam_attention(q, pk[k], pv[k], pl, gk[k], gv[k], gvl, goff,
                                qp, inv)

    def plain(i):
        k = i % n_c
        return A.beam_attention_plain(q, pk[k], pv[k], pl, gk[k], gv[k], gvl,
                                      goff, qp, inv)

    got, ref = kernel(0), plain(0)
    torch.cuda.synchronize()
    rtol = ATT_RTOL["bf16" if dtype == torch.bfloat16 else "f32"]
    err = 0.0
    for n, (g, r) in enumerate(zip(got, ref)):
        e = (g.float() - r.float()).abs().max().item()
        lim = (rtol if n == 0 else ATT_RTOL["f32"]) * \
            r.float().abs().max().item()
        if not (e <= lim and torch.isfinite(g).all()):
            fail(f"beam_attention {label} {dtype}: "
                 f"{'lse' if n else 'out'} max_abs_err {e} > {lim}")
        err = max(err, e)
    if not timed:
        print(f"  beam_attention    {label} {dtype}: max_abs_err {err:.3e} "
              f"(within {rtol} x max|plain|)", flush=True)
        return
    ms = cuda_time_ms(kernel, 20)
    pms = cuda_time_ms(plain, 3, warmup=1)
    # library yardstick: SDPA over each row's prefix and per-beam keys
    # concatenated and rotated beforehand (not timed), the valid lengths
    # as a boolean mask
    rows = torch.arange(B, device=dev)
    slot = rows // (B // P)
    pos = torch.cat([torch.arange(C, device=dev)[None].expand(B, C),
                     goff[:, None].long() + torch.arange(G, device=dev)[None]],
                    1)
    sks, svs = [], []
    for k in range(n_c):
        kk = torch.cat([pk[k][slot], gk[k]], 1).transpose(1, 2)
        sks.append(R.apply_llama_rope(kk, pos[:, None], inv).contiguous())
        svs.append(torch.cat([pv[k][slot], gv[k]], 1).transpose(1, 2)
                   .contiguous())
    sq = R.apply_llama_rope(q[:, :, None], qp.long()[:, None, None], inv)
    j = torch.arange(C + G, device=dev)[None]
    mask = torch.where(j < C, j < pl[slot][:, None],
                       j - C < gvl[:, None])[:, None, None, :]
    lib = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        sq, sks[i % n_c], svs[i % n_c], attn_mask=mask, enable_gqa=True), 20)
    c_eff = [min(v, C) if v > 0 else C for v in plen]
    g_eff = [min(v, G) if v > 0 else G for v in g_valid]
    nbytes = ((sum(c_eff) + sum(g_eff)) * 2 * KV * Dh * es
              + 2 * q.numel() * es + (P + 3 * B) * 4 + B * H * 4)
    ops = (sum(4.0 * (B // P) * H * c * Dh for c in c_eff)
           + sum(4.0 * H * g * Dh for g in g_eff))
    bms, by = bound_ms(nbytes, ops, BF16_FLOPS_PER_S)
    notes.note("beam_attention", (label, B, C), err, ms, pms, lib, bms, by,
               label=f"{label:21s} B={B:2d} P={P:2d} C={C:5d} G={G:3d}")


def check_attention(dev, notes):
    import torch

    from infinisst_tpu_torch.core.presets import flagship_config

    gen = torch.Generator(device=dev).manual_seed(2)
    for case in _att_cases():
        att_case(dev, gen, notes, *case, dtype=torch.bfloat16, timed=True)
    for case in BEAM_CASES:
        beam_case(dev, gen, notes, *case, dtype=torch.bfloat16, timed=True)
    # float32 (the tiny model's and the tests' dtype), the beam step's,
    # the pool's and AlignAtt's blocks, apart and in one launch
    for case in _att_cases()[:6]:
        att_case(dev, gen, notes, *case, dtype=torch.float32, timed=False)
    for case in BEAM_CASES:
        beam_case(dev, gen, notes, *case, dtype=torch.float32, timed=False)
    a0, a1 = alignatt_span(flagship_config(), 360)
    check_probe(dev, "alignatt 64-target", 512, 447, a0, a1, (0, 20, 63))
    print("  library_ms: F.scaled_dot_product_attention(enable_gqa=True) over "
          "keys rotated beforehand (beam_attention: each row's prefix and "
          "per-beam keys concatenated) -- it leaves out the rotation the "
          "kernel does", flush=True)


def alignatt_span(cfg, n_speech):
    """(a0, a1): the speech span of the flagship's offline prompt (the stub
    tokenizer) over ``n_speech`` speech tokens, the probe's keys."""
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    b = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    start = b.offline_prompt(n_speech, []).patch_start
    return start, start + n_speech


def check_probe(dev, label, cap, plen, a0, a1, gen_lens):
    """The AlignAtt probe of a beam step (bf16, the flagship's heads, 4
    beams): ``span_probe`` over the speech keys a0..a1-1 from
    beam_attention's log-sum-exp (the prefix, ``plen`` valid of ``cap``
    slots, and the per-beam block of 64 slots at key offset ``plen``, one
    launch) equals the probe from beam_attention_plain's, at each
    generation length of ``gen_lens``."""
    import torch

    from infinisst_tpu_torch.core import rope as R
    from infinisst_tpu_torch.kernels import decode_attention as A
    from infinisst_tpu_torch.models import llama as L

    gen = torch.Generator(device=dev).manual_seed(9)
    H, KV, Dh = ATT_HEADS
    G = DECODE_BUF_TOKENS
    inv = torch.tensor(R.llama_rope_freqs(Dh), dtype=torch.float32,
                       device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    pk, pv = rand(1, cap, KV, Dh), rand(1, cap, KV, Dh)
    gk, gv = rand(4, G, KV, Dh), rand(4, G, KV, Dh)
    seen = []
    for g in gen_lens:
        q = rand(4, H, Dh)
        pl = torch.tensor([plen], **i32)
        qp = torch.tensor([plen + g] * 4, **i32)
        gvl = torch.tensor([g + 1] * 4, **i32)
        off = torch.tensor([plen] * 4, **i32)
        probes = {}
        for kind, fn in (("kernel", A.beam_attention),
                         ("plain", A.beam_attention_plain)):
            _, lse = fn(q, pk, pv, pl, gk, gv, gvl, off, qp, inv)
            probes[kind] = L.span_probe(q, pk, a0, a1, qp, inv, lse).tolist()
        if probes["kernel"] != probes["plain"]:
            fail(f"the {label} probe (span {a0}..{a1}, {plen} valid of "
                 f"{cap}) from beam_attention's lse differs from the "
                 f"plain version's at gen_len {g}: {probes['kernel']} "
                 f"against {probes['plain']}")
        seen.append((g, probes["kernel"]))
    print(f"  probe {label} (span {a0}..{a1}, {plen} valid of {cap}): "
          f"kernel lse = plain lse at gen_len " + ", ".join(
              f"{g} {p}" for g, p in seen), flush=True)


def offline_shapes(calls):
    """The decode_attention shapes of offline calls (bench.run_offline
    records): per (prompt bucket, prompt length, audio units), the most
    beam steps a call took and the beam forwards of all such calls."""
    shapes = {}
    for c in calls:
        key = (c[3], c[6], c[7])
        most, forwards = shapes.get(key, (0, 0))
        shapes[key] = (max(most, c[1]), forwards + c[1] - 1)
    return shapes


def hold_offline_attention(dev, notes, label, calls, timed, where=None):
    """beam_attention at the shapes the offline calls ``calls`` ran: for
    each (prompt bucket, prompt length) with a beam forward, the beam
    step's two blocks (4 beams over one cache of pbucket + G slots, prompt
    length valid; the per-beam block of G slots at key offset prompt
    length, valid 1..steps - 1), output and lse within ATT_RTOL, and the
    probe over the call's speech span at gen_len 0, the middle and the
    last; with ``timed``, the shape with the most beam forwards timed into
    ``notes``.  Returns that shape's Notes key, or None when no call ran a
    beam forward.  ``where`` names the phase in the printout (default
    ``label``)."""
    import torch

    from infinisst_tpu_torch.core.presets import flagship_config

    gen = torch.Generator(device=dev).manual_seed(11)
    G = DECODE_BUF_TOKENS
    cfg = flagship_config()
    shapes = offline_shapes(calls)
    run = {k: v for k, v in shapes.items() if v[0] > 1}
    where = where or label
    if not run:
        print(f"[{where}] no call ran a beam forward: no beam_attention "
              f"shape to hold", flush=True)
        return None
    top = max(run, key=lambda k: run[k][1])
    for key in sorted(run):
        (pbucket, plen, units), (steps, _) = key, run[key]
        last = steps - 2  # a call's beam forwards see gen_len 0..steps-2
        cap = pbucket + G
        spread = sorted({1 + last * i // 3 for i in range(4)})
        spread += [last + 1] * (4 - len(spread))
        tag = f"{label} {plen}/{cap}"  # valid / slots
        is_top = timed and key == top
        beam_case(dev, gen, notes, tag, 4, 1, cap, [plen], G, spread,
                  torch.bfloat16, is_top, q_pos=plen + last)
        a0, a1 = alignatt_span(cfg, 12 * units)
        check_probe(dev, tag, cap, plen, a0, a1,
                    sorted({0, last // 2, last}))
    print(f"[{where}] beam_attention held at the {len(run)} (prompt "
          f"length, cache slots) pairs its calls ran: "
          f"{[(k[1], k[0] + G) for k in sorted(run)]}"
          + (f"; timed at {top[1]} valid of {top[0] + G}" if timed else ""),
          flush=True)
    return (f"{label} {top[1]}/{top[0] + G}", 4, top[0] + G)


# ---------------------------------------------------------------------------
# phase 4: tiny W8A8 agent, card against CPU


def tiny_agent(device, params, **opt_kw):
    import torch

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import (
        SpecialTokens, StreamConfig, tiny_model_config,
    )
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    vocab = 512
    tokens = SpecialTokens(
        bos=500, eot=501, eos=501, start_header=502, end_header=503,
        pad=504, user=505, assistant=506, newline2=507, sp_patch=508,
        sp_start=509, sp_end=510, latency=(511, 511, 511, 511),
    )
    cfg = tiny_model_config(vocab_size=vocab).replace(tokens=tokens)
    stream = StreamConfig(max_cache_frames=96, max_llm_cache_tokens=120,
                          llm_cache_capacity=256)
    builder = PromptBuilder(StubTokenizer(vocab_size=vocab, lo=10, hi=400),
                            cfg.tokens)
    opts = InfiniSSTOptions(**dict(dict(beam=2, max_llm_cache_size=120,
                                        no_repeat_ngram_lookback=32),
                                   **opt_kw))
    p = None if params is None else _to(params, device)
    return InfiniSSTAgent(p, cfg, stream, builder, opts,
                          param_dtype=torch.float32, device=device), cfg


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def check_tiny(dev):
    """Tiny speech-LLM: the prefill logits on the card against the CPU
    (plain versions), with float32 and with W8A8 weights, and the W8A8
    agent's tokens equal in every chunk."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.core.config import CONV_LEFT_CONTEXT
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models import speech_llm
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.models.quant import init_quantized_llama
    from infinisst_tpu_torch.streaming.state import (
        init_decoder_state, init_encoder_state,
    )

    g = torch.Generator().manual_seed(3)
    agent, cfg = tiny_agent("cpu", None)
    speech = {
        "w2v2": W.init_params(cfg.w2v2, g, "cpu"),
        "adapter": A.init_params(cfg.adapter, g, "cpu"),
    }
    f32_params = dict(speech, llama=L.init_params(cfg.llama, g, "cpu"))
    params = dict(speech, llama=init_quantized_llama(
        cfg.llama, g, "cpu", embed_dtype=torch.float32, act_int8=True,
        lm_head_int8=True,
    ))
    prompt = agent.builder.chunk_prompt(1, True)
    window = torch.from_numpy(
        np.random.RandomState(4).randn(1, CONV_LEFT_CONTEXT + 2 * 15360)
        .astype(np.float32) * 0.1
    )

    def prefill(p, device):
        w, ll = cfg.w2v2, cfg.llama
        state = speech_llm.StreamState(
            encoder=init_encoder_state(w.encoder_layers, 1, 96,
                                       w.encoder_attention_heads, w.head_dim,
                                       torch.float32, device),
            decoder=init_decoder_state(ll.num_layers, 1, 256,
                                       ll.num_kv_heads, ll.head_dim,
                                       torch.float32, device),
        )
        ids = torch.as_tensor(prompt.ids.astype(np.int64), device=device)
        lg, _ = speech_llm.prefill_chunk(
            _to(p, device), cfg, state, window.to(device), ids[None],
            prompt.patch_start, 48, 96,
        )
        return lg.cpu()

    for label, p in (("float32", f32_params), ("W8A8", params)):
        ref, got = prefill(p, "cpu"), prefill(p, dev)
        err = (got - ref).abs().max().item()
        lim = TINY_RTOL * ref.abs().max().item()
        print(f"  tiny {label} prefill logits {tuple(ref.shape)}: max_abs_err "
              f"{err:.3e} (limit {lim:.3e})", flush=True)
        if not (err <= lim and torch.isfinite(got).all()):
            fail(f"tiny {label} prefill logits on the card disagree with "
                 "the CPU")

    outs = {}
    for device in ("cpu", dev):
        agent, _ = tiny_agent(device, params)
        rng = np.random.RandomState(5)
        per_chunk = []
        for i in range(3):
            before = len(agent.states.target_ids)
            agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1,
                       finished=(i == 2))
            per_chunk.append(list(agent.states.target_ids[before:]))
        outs[str(device)] = per_chunk
    a, b = outs["cpu"], outs[str(dev)]
    print(f"  tiny W8A8 agent tokens: cpu={a}", flush=True)
    print(f"                          {dev}={b}", flush=True)
    if a != b or not any(a):
        fail("tiny W8A8 agent's tokens on the card disagree with the CPU "
             "run")
    return f32_params, params


def tiny_engine(device, params):
    """The tiny serving pool of tests/test_torch_serve.py: pool 2, beam 2,
    multipliers (1, 2), a 120-token LLM cache of 256 slots."""
    import torch

    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.serve.engine import ServingEngine

    agent, cfg = tiny_agent("cpu", None)
    stream = StreamConfig(max_cache_frames=96, max_llm_cache_tokens=120,
                          llm_cache_capacity=256)
    return ServingEngine(
        _to(params, device), cfg, stream,
        {("English", "German"): agent.builder}, pool_size=2, multiplier=1,
        dtype=torch.float32, beam=2, multipliers=(1, 2), device=device,
    )


def _tiny_pool(dev, params, captured=True):
    """The tiny pool on the CPU and on the card (its tick captured, or
    the same functions uncaptured): an m=1 and an m=2 slot, slot 0
    switched to m=2 at tick 3, six ticks of one 960 ms unit each (the
    last finishes both streams).  Returns one record a tick, (the slots
    that ticked, {device: (tokens, valid_len, evictions)}, {device: the
    prefill's last logits, uncaptured engines only}), and the two
    engines."""
    import numpy as np

    from infinisst_tpu_torch.decode import beam as beam_mod

    engines = {d: tiny_engine(d, params) for d in ("cpu", dev)}
    engines[dev]._graphs_on = captured
    for e in engines.values():
        e.open_stream("a", multiplier=1)
        e.open_stream("b", multiplier=2)
    rng = np.random.RandomState(7)
    unit = engines["cpu"].stream.chunk_samples(1)
    start = beam_mod.start_loop
    records = []
    for t in range(6):
        audio = [rng.randn(unit).astype(np.float32) * 0.1 for _ in range(2)]
        state, last = {}, {}
        for d, e in engines.items():
            if t == 3:
                e.update_multiplier(0, 2)
            for slot in (0, 1):
                e.push_audio(slot, audio[slot], finished=(t == 5))

            def recorded(loop, spec, logits, *a, _d=d, **kw):
                last[_d] = logits.float().cpu()
                return start(loop, spec, logits, *a, **kw)

            if not e._graphs_on:  # a captured piece holds no Python
                beam_mod.start_loop = recorded
            try:
                e.tick()
            finally:
                beam_mod.start_loop = start
            state[d] = ([list(s.target_ids) for s in e.slots],
                        e.valid_len_host.tolist(), e.evictions)
        records.append((engines[dev].last_ticked, state, last))
    return records, engines


def check_serve_tiny(dev, f32_params, w8a8_params):
    """The tiny float32 pool (the weights of check_tiny) on the card, its
    tick captured, against the CPU through a trim: every slot's tokens
    and the host mirrors equal after every tick.  Then the W8A8 pool the
    same way (uncaptured on the card, to read its prefill logits),
    reported: the first tick whose tokens differ, with its largest
    relative gap of the last prefill logits."""
    reset_counts()
    records, engines = _tiny_pool(dev, f32_params)
    for t, (ticked, state, _) in enumerate(records):
        print(f"  [serve tiny] tick {t}: slots {ticked}, tokens "
              f"{[len(x) for x in state[dev][0]]}, valid_len "
              f"{state[dev][1]}, evictions {state[dev][2]}", flush=True)
        if state["cpu"] != state[dev]:
            fail(f"[serve tiny] tick {t}: the card's pool differs from the "
                 f"CPU's: {state[dev]} != {state['cpu']}")
    card = engines[dev]
    counts = launch_counts()
    print(f"  [serve tiny] tokens {card.slots[0].target_ids[:12]}..., "
          f"evictions {card.evictions}, forwards {card.forwards}; launches "
          f"{counts}, attention by shape "
          f"{dict(_kernel_modules()[1].launch_shapes)}", flush=True)
    if not (card.evictions and all(s.done for s in card.slots)):
        fail("[serve tiny] the streams did not trim and finish")
    if not card._programs["beam"].replays:
        fail("[serve tiny] the card's pool did not replay its tick")
    if _kernel_modules()[1].launch_shapes.get("beam B=4 Bc=2", 0) <= 0:
        fail("[serve tiny] the pool's beam step did not launch "
             "beam_attention over its 2 prefix caches")
    differ = None
    for t, (_, state, last) in enumerate(
            _tiny_pool(dev, w8a8_params, captured=False)[0]):
        if state["cpu"] != state[dev] and differ is None:
            a, b = last["cpu"], last[dev]
            gap = ((a - b).abs().amax(-1) / a.abs().amax(-1)).tolist()
            differ = (t, gap)
    print(f"  [serve tiny] the W8A8 pool, card against CPU: "
          + ("tokens equal every tick" if differ is None else
             f"tokens first differ at tick {differ[0]}, where the last "
             f"prefill logits of each row differ by "
             f"{[f'{x:.3e}' for x in differ[1]]} of their max (float32 "
             "noise across an int8 rounding boundary; ROADMAP §3)"),
          flush=True)


# the tiny AlignAtt / StreamAtt runs (tests/test_torch_alignatt.py's
# config): label -> (agent, options)
OFFLINE_TINY = {
    "alignatt": ("alignatt", {}),
    "alignatt early stop": ("alignatt", {"attn_early_stop": True}),
    "streamatt": ("streamatt", {"text_preserve_num": 2,
                                "min_speech_duration": 0.5,
                                "max_speech_duration": 1.5,
                                "target_lang": "Chinese"}),
}


def tiny_offline_agent(device, params, kind, **kw):
    """The tiny AlignAtt or StreamAtt agent of tests/test_alignatt.py:_mk
    (beam 2, layer 1, 2-unit audio buckets, a 16-token buffer)."""
    import torch

    from infinisst_tpu_torch.agents.alignatt import (
        AlignAttAgent, AlignAttOptions,
    )
    from infinisst_tpu_torch.agents.streamatt import (
        StreamAttAgent, StreamAttOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig

    base, cfg = tiny_agent("cpu", None)
    cls, opts_cls = ((AlignAttAgent, AlignAttOptions) if kind == "alignatt"
                     else (StreamAttAgent, StreamAttOptions))
    opts = opts_cls(latency_multiplier=1, beam=2, attn_layer=1, frame_num=1,
                    length_bucket_chunks=2, decode_buf_tokens=16,
                    no_repeat_ngram_lookback=16, **kw)
    return cls(_to(params, device), cfg,
               StreamConfig(max_cache_frames=96, llm_cache_capacity=256),
               base.builder, opts, param_dtype=torch.float32, device=device)


def _offline_tiny_run(device, params, kind, kw, on_push=None):
    """Four 960 ms pushes (the AlignAtt runs finish on the last): after
    each, (target ids, most-attended indices, source samples);
    ``on_push(agent, audio)`` after each push where given."""
    import numpy as np

    agent = tiny_offline_agent(device, params, kind, **kw)
    rng = np.random.RandomState(13)
    out = []
    for i in range(4):
        audio = rng.randn(agent.unit_samples).astype(np.float32) * 0.1
        agent.push(audio, finished=(kind == "alignatt" and i == 3))
        if on_push is not None:
            on_push(agent, audio)
        st = agent.states
        out.append((list(st.target_ids), list(st.most_attended_indices),
                    len(st.source)))
    return out


def check_alignatt_tiny(dev, f32_params, w8a8_params):
    """The tiny AlignAtt (parity and early stop) and StreamAtt agents with
    the float32 weights of check_tiny, on the card against the CPU: equal
    target ids, most-attended indices and source lengths after every push.
    Then with the W8A8 weights, reported: the first push that differs."""
    from types import SimpleNamespace

    reset_counts()
    for label, (kind, kw) in OFFLINE_TINY.items():
        rule = (StreamAttRule(SimpleNamespace(**kw), f"[alignatt tiny] {label}")
                if kind == "streamatt" else None)
        a = _offline_tiny_run("cpu", f32_params, kind, kw)
        b = _offline_tiny_run(dev, f32_params, kind, kw, on_push=rule)
        for i, (x, y) in enumerate(zip(a, b)):
            print(f"  [alignatt tiny] {label} push {i}: target {y[0][:10]}"
                  f"{'...' if len(y[0]) > 10 else ''} ({len(y[0])}), "
                  f"attended {y[1][:6]}{'...' if len(y[1]) > 6 else ''} "
                  f"({len(y[1])}), source {y[2]}", flush=True)
            if x != y:
                fail(f"[alignatt tiny] {label} push {i}: the card's agent "
                     f"differs from the CPU's: {y} != {x}")
        if not a[-1][0]:
            fail(f"[alignatt tiny] {label} emitted nothing")
        if rule is not None:
            print(f"  [alignatt tiny] {label}: the kept source equal to the "
                  f"rule's after every push; cut at the earliest attended "
                  f"sample after pushes {rule.at_frame}, clamped to "
                  f"min_speech_duration after {rule.clamped}", flush=True)
            if not rule.at_frame:
                fail("[alignatt tiny] StreamAtt never cut its source at "
                     "an attended frame")
    counts = launch_counts()
    print(f"  [alignatt tiny] launches on the card {counts}", flush=True)
    if counts["beam_attention"] <= 0:
        fail("[alignatt tiny] the beam step did not launch beam_attention")
    for label, (kind, kw) in OFFLINE_TINY.items():
        a = _offline_tiny_run("cpu", w8a8_params, kind, kw)
        b = _offline_tiny_run(dev, w8a8_params, kind, kw)
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        print(f"  [alignatt tiny] W8A8 {label}, card against CPU: "
              + ("equal every push" if first is None else
                 f"first differs at push {first} (float32 noise across an "
                 "int8 rounding boundary, ROADMAP §3)"), flush=True)


# ---------------------------------------------------------------------------
# phases 5 / 6: the 8B streams


def stream_8b(dev, cfg, params, min_chunks, max_chunks, need_evict, label):
    import numpy as np
    import torch

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    stream = StreamConfig()
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    agent = InfiniSSTAgent(params, cfg, stream, builder,
                           InfiniSSTOptions(latency_multiplier=1, beam=4),
                           param_dtype=torch.bfloat16, device=dev)
    rng = np.random.RandomState(0)
    chunk_sec = agent.chunk_samples / 16000.0
    n_layers = cfg.llama.num_layers
    times, forwards = [], 0
    evicted_at = None
    i = 0
    reset_counts()
    while True:
        audio = rng.randn(agent.chunk_samples).astype(np.float32) * 0.1
        before = launch_counts()
        before_int = internal_counts()
        before_fwd = forward_counts()
        _sync(dev)
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        _sync(dev)
        dt = time.perf_counter() - t0
        res = agent.last_result
        n_fwd = res.steps  # 1 prefill + (steps - 1) beam forwards
        check_forwards(before_fwd, n_fwd, n_layers, label)
        forwards += n_fwd
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in before if after[k] > before[k]}
        after_int = internal_counts()
        delta_int = {k: after_int[k] - before_int[k] for k in after_int}
        times.append(dt)
        vlen = int(agent.dec_state.valid_len[0])
        print(f"  [{label}] chunk {i:2d}: {dt * 1e3:9.2f} ms  RTF "
              f"{dt / chunk_sec:.4f}  valid_len {vlen:4d}  enc_frames "
              f"{int(agent.enc_state.n_frames[0]):5d}  emitted "
              f"{agent.pend_n_host}  forwards {n_fwd}  evictions "
              f"{agent.evictions}  launches {delta}  besides the launches "
              f"{delta_int}", flush=True)
        if evicted_at is None and agent.evictions:
            evicted_at = i
        if not all(0 <= t < cfg.llama.vocab_size for t in res.tokens):
            fail(f"[{label}] token out of vocabulary: {res.tokens}")
        i += 1
        ring_wrapped = i * 48 > stream.max_cache_frames
        evict_applied = evicted_at is not None and i > evicted_at + 1
        if i >= max_chunks or (
            i >= min_chunks and ring_wrapped
            and (not need_evict or evict_applied)
        ):
            break
    counts = launch_counts()
    print(f"  [{label}] besides the launches, over the stream: "
          f"{internal_counts()} (split-K calls are one launch each)",
          flush=True)
    agent.flush_pending_evict()
    if agent.llm_cache_len != int(agent.dec_state.valid_len[0]) + \
            agent.pend_n_host:
        fail(f"[{label}] cache mirror {agent.llm_cache_len} != physical "
             f"{int(agent.dec_state.valid_len[0])} + pending "
             f"{agent.pend_n_host}")
    if int(agent.enc_state.n_frames[0]) != 48 * i:
        fail(f"[{label}] encoder consumed {int(agent.enc_state.n_frames[0])} "
             f"frames, expected {48 * i}")
    if need_evict and evicted_at is None:
        fail(f"[{label}] no LLM cache eviction in {i} chunks")
    return dict(chunks=i, times=times, forwards=forwards, counts=counts,
                evicted_at=evicted_at, n_layers=n_layers,
                chunk_sec=chunk_sec, agent=agent, rng=rng)


# the pieces of the captured chunk program (agents/infinisst.py
# _generate_chunk_fn; the AlignAtt call's, agents/alignatt.py _offline_fn,
# has the same four), each a CUDA graph replayed as a whole: stages are
# timed and profiled around their replays
PIECES = (
    ("graph", "A", "A prologue"),  # trim, window, encoder, splice, prefill
    ("graph", "B", "B beam select"),  # one beam step's bookkeeping
    ("graph", "C", "C beam forward"),  # one beam_token_step
    ("graph", "F", "F finish"),  # finalize, pending (history) or the
    # winners' K/V committed (the pool), packed
)


def stage_label(stage) -> str:
    return stage[2] if len(stage) > 2 else stage[1]


@contextlib.contextmanager
def wrapped_pieces(wrap, stages=PIECES):
    """Route each piece's ``DeviceProgram.run`` through ``wrap(label,
    fn)`` for the duration."""
    from infinisst_tpu_torch.core import graphs

    labels = {stage[1]: stage_label(stage) for stage in stages}
    orig = graphs.DeviceProgram.run

    def run(self, name):
        return wrap(labels[name], lambda: orig(self, name))()

    graphs.DeviceProgram.run = run
    try:
        yield
    finally:
        graphs.DeviceProgram.run = orig


def _wrapper(stages):
    """The context that wraps ``stages``: the captured program's pieces
    or module functions."""
    if stages and stages[0][0] == "graph":
        return lambda wrap: wrapped_pieces(wrap, stages)
    return lambda wrap: wrapped_stages(wrap, stages)


@contextlib.contextmanager
def wrapped_stages(wrap, stages):
    """Replace each stage function by ``wrap(label, fn)`` for the duration
    (the port calls them through their modules), then restore them."""
    saved = []
    for stage in stages:
        mod_name, name = stage[:2]
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, wrap(stage_label(stage), fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _next_audio(r):
    import numpy as np

    return r["rng"].randn(r["agent"].chunk_samples).astype(np.float32) * 0.1


def timed_stages(dev, step, stages):
    """``step()`` with a synchronise before and after each stage: returns
    ({stage: (calls, seconds)}, wall seconds), host and device together."""
    spent = {}

    def wrap(name, fn):
        def timed(*args, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(dev)
            n, t = spent.get(name, (0, 0.0))
            spent[name] = (n + 1, t + time.perf_counter() - t0)
            return out
        return timed

    with _wrapper(stages)(wrap):
        _sync(dev)
        t0 = time.perf_counter()
        step()
        _sync(dev)
        wall = time.perf_counter() - t0
    return spent, wall


def stage_chunk(dev, r):
    """One more chunk with a synchronise before and after each replay of
    the captured program's pieces: the wall time of each piece, host and
    device together, and a beam step's (B + C)."""
    audio = _next_audio(r)
    spent, wall = timed_stages(
        dev, lambda: r["agent"].push(audio, finished=False), PIECES)
    print(f"[stages] one chunk with a synchronise around each replayed "
          f"piece: wall {wall * 1e3:.2f} ms", flush=True)
    for stage in PIECES:
        name = stage_label(stage)
        n, t = spent.get(name, (0, 0.0))
        print(f"[stages]   {name:16s} replays {n:2d}  {t * 1e3:9.2f} ms",
              flush=True)
    nb, tb = spent.get("B beam select", (0, 0.0))
    nc, tc = spent.get("C beam forward", (0, 0.0))
    top = sum(t for n, t in spent.values())
    print(f"[stages]   a beam step (B + C) {(tb / max(nb, 1) + tc / max(nc, 1)) * 1e3:.3f} "
          f"ms of wall ({nb} B, {nc} C); outside every piece (upload, "
          f"reads, host bookkeeping): {(wall - top) * 1e3:.2f} ms",
          flush=True)
    return spent, wall


def profile_chunk(dev, r, label="profile", keep=None):
    """One more chunk under torch.profiler: wall time, device kernel time
    by kernel name and by stage, and the device's idle share, both against
    the profiled wall and against the median unprofiled chunk wall; each
    line starts with ``[label]``."""
    audio = _next_audio(r)
    med = sorted(r["times"][1:])[(len(r["times"]) - 1) // 2] * 1e3
    programs = r["agent"]._programs.values()
    replays = sum(p.replays for p in programs)
    out = profile_run(dev, lambda: r["agent"].push(audio, finished=False),
                      PIECES, label, med, "chunk", hold_launches=True,
                      keep=keep)
    if sum(p.replays for p in programs) != replays + 1:
        fail(f"[{label}] the profiled chunk did not replay its program")
    return out


# idle host time inside a profiler's window before and after the step: the
# device's records are placed on the host's clock, and the profiler keeps
# only those inside its window (a [profile] run once saw 45 fewer of a
# chunk's 4116 port kernels than its counters recorded, every other run
# all of them)
PROFILE_MARGIN_S = 0.05


def profile_run(dev, step, stages, label, med, what, hold_launches=False,
                keep=None):
    """``step()`` under torch.profiler, as ``profile_chunk`` describes;
    ``med`` is the median unprofiled wall (ms) of such a step.  With
    ``hold_launches``: fails unless the kernels the profiler saw run,
    counted by name, equal the launches the wrappers' counters recorded
    over the step (on a replay, what the graphs recorded at capture).
    ``keep`` (a dict) receives the profile under "prof"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from infinisst_tpu_torch.tools.op_split import (
        PORT_KERNELS, port_kernel, tally,
    )

    def wrap(name, fn):
        def ranged(*args, **kw):
            with record_function(f"stage::{name}"):
                return fn(*args, **kw)
        return ranged

    _sync(dev)
    before = launch_counts()
    with _wrapper(stages)(wrap), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        step()
        _sync(dev)
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    if keep is not None:
        keep["prof"] = prof
    averages = prof.key_averages()  # computed once: it walks every event
    if hold_launches:
        recorded = {k: n - before[k] for k, n in launch_counts().items()}
        seen = dict.fromkeys(recorded, 0)
        for e in averages:
            if e.device_type == DeviceType.CUDA:
                g = port_kernel(e.key)
                if g is not None:
                    seen[g] += e.count
        if seen != recorded:
            fail(f"[{label}] kernels run on the device by name {seen}; the "
                 f"launch counters recorded {recorded}")
        print(f"[{label}] kernels run on the device, counted by name, equal "
              f"the launches recorded: "
              f"{ {k: n for k, n in seen.items() if n} }", flush=True)
    by_name = {}
    for e in averages:
        # device-side kernel events only: a CPU op also reports the device
        # time of the kernels it launched, which would count them twice;
        # the device side of the stage ranges is read below
        if e.device_type != DeviceType.CUDA or e.key.startswith("stage::"):
            continue
        t = e.self_device_time_total
        if t > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3  # ms
    busy = sum(by_name.values())
    print(f"[{label}] one {what} under the profiler: wall {wall * 1e3:.2f} "
          f"ms, device kernels {busy:.2f} ms, device idle share "
          f"{1.0 - busy / (wall * 1e3):.4f}; against the median unprofiled "
          f"{what} wall {med:.2f} ms: {1.0 - busy / med:.4f}", flush=True)
    # kernel time by stage: the device events that start inside the device
    # span of a stage's range.  A range's own device total would miss the
    # kernels launched through ctypes, which belong to no PyTorch op.
    spans, events = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith("stage::"):
            spans.setdefault(e.name[7:], []).append(
                (e.time_range.start, e.time_range.end))
        else:
            events.append((e.time_range.start, e.time_range.elapsed_us()))
    for stage in stages:
        name = stage_label(stage)
        ss = spans.get(name, [])
        span_ms = sum(b - a for a, b in ss) / 1e3
        dev_ms = sum(d for s, d in events
                     if any(a <= s < b for a, b in ss)) / 1e3
        print(f"[{label}]   stage {name:16s} ranges {len(ss):2d}  device span "
              f"{span_ms:9.2f} ms  device kernels {dev_ms:9.2f} ms",
              flush=True)
    port, ops = tally(averages)  # ops: the "other" kernels by op
    groups = {g: port.get(g, (0.0, 0))[0] for g in PORT_KERNELS}
    groups["other"] = sum(t for t, _ in ops.values())
    print(f"[{label}] device ms by kernel group: "
          f"{ {k: round(v, 3) for k, v in groups.items()} }", flush=True)
    if keep is not None:
        keep["ops"] = ops
    print(f"[{label}] other device ops by op (ms, launches): " + json.dumps(
        {k: [round(v[0], 3), v[1]] for k, v in
         sorted(ops.items(), key=lambda kv: -kv[1][0])}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for k, t in top:
        print(f"[{label}]   {t:9.3f} ms  {k[:90]}", flush=True)
    return busy, wall * 1e3


def check_flagship(dev, paths):
    """The flagship W8A8 stream (ring wrap + an applied eviction), a chunk
    stage by stage, a profiled chunk, the multiplier switch, the serving
    pool's and AlignAtt's profiles; returns (config, parameters) for the
    later 8B paths."""
    import torch

    from infinisst_tpu_torch.bench import flagship_params

    print("[flagship] 8B W8A8, m=1, beam 4", flush=True)
    cfg, params = flagship_params(dev, act_int8=True)
    r = stream_8b(dev, cfg, params, min_chunks=13, max_chunks=60,
                  need_evict=True, label="w8a8")
    L = r["n_layers"]
    # one GEMM per projection and the head (q|k|v and gate|up one launch
    # each); one quantization per distinct input (q/k/v share one, gate/up
    # another), three of the four a layer fused into the kernel that makes
    # the input
    per_fwd = a8_forward_launches(L)
    for name, n in per_fwd.items():
        if r["counts"][name] != r["forwards"] * n:
            fail(f"[flagship] {name} launched {r['counts'][name]} times, "
                 f"expected {r['forwards']} forwards x {n}")
    # each beam forward launches beam_attention once a layer: the shared
    # prefix block and the per-beam block in one softmax
    beam_fwd = r["forwards"] - r["chunks"]
    if (r["counts"]["beam_attention"] != beam_fwd * L
            or r["counts"]["decode_attention"]):
        fail(f"[flagship] beam_attention launched "
             f"{r['counts']['beam_attention']} times (decode_attention "
             f"{r['counts']['decode_attention']}), expected {beam_fwd} beam "
             f"forwards x {L} layers (and none)")
    unused = ("w8_bf16_gemm", "group_quant_int8", "w8a8_grouped_gemm")
    if any(r["counts"][k] for k in unused):
        fail(f"[flagship] {unused} ran on the per-channel W8A8 path")
    # the quantizations fused into the norm before them
    fused_away = r["counts"]["rms_norm_quant_int8"]
    # chunk 0 carries one-time set-up (cuBLAS handles, allocator)
    rtf = sorted(t / r["chunk_sec"] for t in r["times"][1:])
    n = len(rtf)
    print(f"[flagship] chunks {r['chunks']} (ring wrap after 12, first "
          f"eviction decided after chunk {r['evicted_at']}); forwards "
          f"{r['forwards']} ({beam_fwd} beam forwards); launches "
          f"{r['counts']} = forwards x ({', '.join(f'{v} {k}' for k, v in per_fwd.items() if v)}) "
          f"(one quantization per shared input, {fused_away} of them fused "
          f"into the norm before it) and beam forwards x {L} layers "
          f"beam_attention launches (the prefix block and the per-beam "
          f"block, one launch a layer)", flush=True)
    print(f"[flagship] RTF over chunks 1..{n} (bring-up reading, not a "
          f"benchmark): median {rtf[n // 2]:.4f}, "
          f"{100 * (n - 10) // n}th percentile {rtf[n - 11]:.4f} "
          f"(10 chunks above it), mean {sum(rtf) / n:.4f}, min "
          f"{rtf[0]:.4f}, max {rtf[-1]:.4f}; chunk 0 "
          f"{r['times'][0] / r['chunk_sec']:.4f}", flush=True)
    for name in ("w8a8_gemm", "row_quant_int8", "beam_attention",
                 "rms_norm_quant_int8", "silu_mul_quant_int8"):
        paths[name] = ("flagship W8A8 stream", r["counts"])
    stage_chunk(dev, r)
    keep = {}
    profile_chunk(dev, r, keep=keep)
    # the norms' float32 means went into rms_norm_quant_int8: the chunk's
    # mean reductions are the encoder's and the adapter's layer norms'
    # alone, counted on an eager pass of the same encoder step
    steps = r["agent"].last_result.steps
    mean_ms, n_mean = keep["ops"].get("mean reduce", (0.0, 0))
    n_enc = encoder_means(r["agent"])
    print(f"[profile] mean reductions in the replayed chunk: {n_mean} "
          f"({mean_ms:.3f} ms) for {steps} forwards; the encoder step's "
          f"own: {n_enc}", flush=True)
    if n_mean > n_enc:
        fail(f"[profile] a replayed W8A8 chunk of {steps} forwards ran "
             f"{n_mean} mean reductions, the encoder step {n_enc}: the "
             f"norms' are not all fused")
    check_multiplier(dev, r)
    del r
    torch.cuda.empty_cache()
    check_serve_profile(dev, cfg, params)
    check_alignatt_profile(dev, cfg, params)
    return cfg, params


def encoder_means(agent) -> int:
    """The mean reductions of one steady chunk's encoder and adapter
    (wav2vec2's and the adapter's layer norms): the aten.mean calls of an
    eager ``speech_llm.encode_chunk`` on the agent's state, counted by a
    dispatch mode.  The agent's state is not changed: the step returns
    the new one."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from infinisst_tpu_torch.models import speech_llm

    n = [0]

    class CountMeans(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n[0] += func.overloadpacket is torch.ops.aten.mean
            return func(*args, **(kwargs or {}))

    c = agent._geometry(agent.opts.latency_multiplier, False)
    with torch.no_grad(), CountMeans():
        speech_llm.encode_chunk(agent.params, agent.cfg, agent.enc_state,
                                agent.window[:, -c.conv_width:],
                                c.chunk_frames, agent.stream.max_cache_frames)
    return n[0]


GRAPH_CHUNKS = 14  # m=1: the first key, the steady key, one eviction
GRAPH_CACHE = 300  # max_llm_cache_size: an eviction within GRAPH_CHUNKS
GRAPH_M2_DEPTH = (8, 8)  # Llama and encoder layers of the m=2 run
GRAPH_M2_CHUNKS = 4  # then a tail of one unit


def _cut_depth(cfg, params, n_llama, n_enc):
    """The flagship config and parameters at the first n_llama Llama and
    n_enc encoder layers (views of the stacked leaves, no copy)."""
    def first(tree, n):
        if isinstance(tree, dict):
            return {k: first(v, n) for k, v in tree.items()}
        return tree[:n]

    ll = cfg.llama.__class__(**{**cfg.llama.__dict__, "num_layers": n_llama})
    w = cfg.w2v2.__class__(**{**cfg.w2v2.__dict__, "encoder_layers": n_enc})
    p = dict(params)
    p["llama"] = dict(params["llama"], layers=first(
        params["llama"]["layers"], n_llama))
    p["w2v2"] = dict(params["w2v2"], layers=first(params["w2v2"]["layers"],
                                                   n_enc))
    return cfg.replace(llama=ll, w2v2=w), p


def _graph_pair(dev, cfg, params, m, n_chunks, tail, max_cache, label):
    """The same audio through two agents on ``params``: the chunk program
    captured (every replay under sync debug mode "error", lifted only
    around the reads of ``done`` and of the packed result) and the same
    functions uncaptured on the card.  Fails unless the target ids are
    equal every chunk and a replayed chunk launches what the uncaptured
    chunk does.  Returns the captured run's per-chunk records."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core import graphs
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    runs = {}
    for name, on in (("captured", True), ("uncaptured", False)):
        builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size),
                                cfg.tokens)
        agent = InfiniSSTAgent(
            params, cfg, StreamConfig(), builder,
            InfiniSSTOptions(latency_multiplier=m, beam=4,
                             max_llm_cache_size=max_cache),
            param_dtype=torch.bfloat16, device=dev)
        agent._graphs_on = on  # the private hook: uncaptured on the card
        rng = np.random.RandomState(1)
        sizes = [agent.chunk_samples] * n_chunks + ([tail] if tail else [])
        recs = []
        for i, n in enumerate(sizes):
            audio = rng.randn(n).astype(np.float32) * 0.1
            before = len(agent.states.target_ids)
            replays = sum(p.replays for p in agent._programs.values())
            reset_counts()
            reads = graphs.host_reads
            before_fwd = forward_counts()
            _sync(dev)
            t0 = time.perf_counter()
            with graphs.strict_syncs():
                agent.push(audio, finished=bool(tail) and i == len(sizes) - 1)
            _sync(dev)
            dt = time.perf_counter() - t0
            check_forwards(before_fwd, agent.last_result.steps,
                           cfg.llama.num_layers, f"graph {label} {name}")
            recs.append(dict(
                ids=list(agent.states.target_ids[before:]), wall=dt,
                counts=launch_counts(), reads=graphs.host_reads - reads,
                steps=agent.last_result.steps, evictions=agent.evictions,
                replayed=sum(p.replays for p in agent._programs.values())
                > replays))
        runs[name] = (agent, recs)
    (cap, c), (_, u) = runs["captured"], runs["uncaptured"]
    for i, (a, b) in enumerate(zip(c, u)):
        if a["ids"] != b["ids"]:
            fail(f"[graph] {label} chunk {i}: captured {a['ids']} != "
                 f"uncaptured {b['ids']}")
        if a["counts"] != b["counts"]:
            fail(f"[graph] {label} chunk {i}: the captured chunk launched "
                 f"{a['counts']}, the uncaptured chunk {b['counts']}")
        if a["reads"] > a["steps"] + 1:
            fail(f"[graph] {label} chunk {i}: {a['reads']} host reads for "
                 f"{a['steps']} beam steps")
    if not all(a["replayed"] for a in c[2:-1]):
        fail(f"[graph] {label}: a steady chunk did not replay")
    keys = sorted(cap._programs)
    print(f"[graph] {label}: {len(c)} chunks, keys {keys}, evictions "
          f"{cap.evictions}; target ids equal captured / uncaptured every "
          f"chunk ({sum(len(a['ids']) for a in c)} ids); every chunk's "
          f"launches equal the uncaptured chunk's, its forwards those of "
          f"its beam steps; no synchronisation in a replay besides the "
          f"reads of done and packed", flush=True)
    for i, (a, b) in enumerate(zip(c, u)):
        print(f"[graph]   {label} chunk {i:2d}: captured "
              f"{a['wall'] * 1e3:8.2f} ms ({'replay' if a['replayed'] else 'warm-up + capture'}), "
              f"uncaptured {b['wall'] * 1e3:8.2f} ms; beam steps "
              f"{a['steps']}, host reads {a['reads']}, launches "
              f"{ {k: v for k, v in a['counts'].items() if v} }",
              flush=True)
    return cap, c, u


def check_graph(dev, cfg, params, paths):
    """The plain beam chunk step as captured CUDA graphs (JAX's execution
    model): the flagship W8A8 at m=1, beam 4, GRAPH_CHUNKS chunks with one
    applied eviction, and at m=2 with a tail chunk at GRAPH_M2_DEPTH
    layers, each against the same functions uncaptured on the card; the
    captured chunk's wall (median, p95), host reads, beam steps, the
    device time of each piece by CUDA events and its idle share."""
    import numpy as np
    import torch

    cap, c, u = _graph_pair(dev, cfg, params, 1, GRAPH_CHUNKS, 0,
                            GRAPH_CACHE, "m=1")
    decided = next((i for i, a in enumerate(c) if a["evictions"]), None)
    if decided is None or decided >= len(c) - 1:
        fail("[graph] m=1: no eviction was applied")
    steady = [a for a in c if a["replayed"]]
    walls = sorted(a["wall"] * 1e3 for a in steady)
    uwalls = sorted(b["wall"] * 1e3 for a, b in zip(c, u) if a["replayed"])
    n = len(walls)
    p95 = walls[min(n - 1, math.ceil(0.95 * n) - 1)]
    chunk_sec = cap.chunk_samples / 16000.0
    print(f"[graph] m=1 replayed chunks {n}: wall median "
          f"{statistics.median(walls):.2f} ms, p95 {p95:.2f} ms, RTF median "
          f"{statistics.median(walls) / 1e3 / chunk_sec:.4f}; the same "
          f"chunks uncaptured: median {statistics.median(uwalls):.2f} ms; "
          f"host reads a chunk {[a['reads'] for a in steady]} for beam steps "
          f"{[a['steps'] for a in steady]}", flush=True)
    # device time of the pieces by CUDA events around each replay (no
    # synchronise inside the chunk), against the chunk's wall
    spans = {}

    def wrap(name, fn):
        def timed():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            spans.setdefault(name, []).append((e0, e1))
            return out
        return timed

    audio = np.random.RandomState(2).randn(cap.chunk_samples).astype(
        np.float32) * 0.1
    with wrapped_pieces(wrap):
        _sync(dev)
        t0 = time.perf_counter()
        cap.push(audio, finished=False)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms = {k: sum(a.elapsed_time(b) for a, b in v)
              for k, v in spans.items()}
    busy = sum(dev_ms.values())
    steps = cap.last_result.steps
    step_dev = (dev_ms.get("B beam select", 0.0)
                + dev_ms.get("C beam forward", 0.0)) / max(steps, 1)
    print(f"[graph] one replayed chunk, CUDA events around each replay: "
          f"wall {wall:.2f} ms, device {busy:.2f} ms, idle share "
          f"{1.0 - busy / wall:.4f}; by piece "
          f"{ {k: round(v, 3) for k, v in dev_ms.items()} }; a beam step "
          f"{step_dev:.3f} ms of device time ({steps} steps)", flush=True)
    spent, swall = stage_chunk(dev, dict(agent=cap, rng=np.random.RandomState(3)))
    nb, tb = spent.get("B beam select", (0, 0.0))
    nc, tc = spent.get("C beam forward", (0, 0.0))
    print(f"[graph] a beam step: wall {(tb / max(nb, 1) + tc / max(nc, 1)) * 1e3:.3f} "
          f"ms (synchronised per piece) against {step_dev:.3f} ms of device "
          "time", flush=True)
    # the split-K tile counters reset themselves: zero between replays
    K, _ = _kernel_modules()
    _sync(dev)
    dirty = {str(k): int(torch.count_nonzero(b))
             for k, b in K._counters.items() if int(torch.count_nonzero(b))}
    if dirty:
        fail(f"[graph] split-K counters left non-zero after the replays: "
             f"{dirty}")
    print(f"[graph] the split-K tile counters ({len(K._counters)} buffers) "
          "are zero after the replays", flush=True)
    paths["graph"] = ("flagship W8A8 captured stream, m=1, a replayed chunk",
                      steady[-1]["counts"])
    del cap
    torch.cuda.empty_cache()
    cfg2, p2 = _cut_depth(cfg, params, *GRAPH_M2_DEPTH)
    _graph_pair(dev, cfg2, p2, 2, GRAPH_M2_CHUNKS, 12000, 1000,
                f"m=2 L={GRAPH_M2_DEPTH[0]}")
    torch.cuda.empty_cache()


# the offline agents' and the sampler's programs against their uncaptured
# twins ([alignatt graph], [sample graph])
ALIGNATT_GRAPH_DEPTH = (8, 8)  # Llama and encoder layers
# (label, bench mode, early stop, pushes, {push: target ids a caller
# commits before it}): the parity run's caller commits 2 ids before push
# 3 and 3 more before push 4, so that key (30, 448) replays at another
# prompt length (its first key, (30, 384), holds only the empty target's
# 383 ids)
ALIGNATT_GRAPH_RUNS = (
    ("parity", "alignatt", False, 5, {3: [300, 301], 4: [302, 303, 304]}),
    ("early stop", "alignatt", True, 5, {}),
    ("streamatt", "streamatt", True, 14, {}),
)
SAMPLE_GRAPH_CHUNKS = 4  # the first key, the steady key, two replays
SAMPLE_GRAPH_SEEDS = (0, 7)
# top-k and top-p on (the bench's --do-sample takes temperature and top-k)
SAMPLE_GRAPH_OPTS = dict(do_sample=True, temperature=1.0, top_k=50,
                         top_p=0.9)
SPEC_SAMPLE_GRAPH_CHUNKS = 7  # the guard trips after chunk 2


def graph_pool_bytes(pool) -> int:
    """The bytes the caching allocator holds in ``pool``'s segments (its
    graphs' temporaries), from the memory snapshot's segment pool ids."""
    import torch

    if pool is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", (0, 0))) == tuple(pool.handle))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _by_group(names: dict) -> dict:
    """Kernel counts by name (``device_kernel_names``) summed into the
    port's kernels (op_split.PORT_KERNELS, the launch counters' names)."""
    from infinisst_tpu_torch.tools.op_split import PORT_KERNELS, port_kernel

    out = dict.fromkeys(PORT_KERNELS, 0)
    for key, n in names.items():
        g = port_kernel(key)
        if g is not None:
            out[g] += n
    return out


def device_kernel_names(dev, step) -> dict:
    """``step()`` under torch.profiler: the device kernels it ran, counted
    by name (copies and memsets left out: the host's uploads and reads).
    Only the device's activity is traced: the host's ops, which an
    uncaptured call has by the thousand, would cost seconds to sort."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        step()
        _sync(dev)
        time.sleep(PROFILE_MARGIN_S)
    names = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.key.startswith(
                ("Memcpy", "Memset", "stage::")):
            names[e.key] = names.get(e.key, 0) + e.count
    return names


def _offline_graph_run(dev, cfg, params, mode, early, pushes, commits,
                       captured, label):
    """One offline agent of the bench (``bench.offline_agent``) on
    ``params``, its calls captured or the same programs uncaptured;
    every call of the captured agent under ``graphs.strict_syncs``.  One
    record a push, then the agent."""
    import numpy as np

    from infinisst_tpu_torch import bench
    from infinisst_tpu_torch.core import graphs

    agent = bench.offline_agent(mode, early, cfg, params, dev)
    agent._graphs_on = captured
    rng = np.random.RandomState(5)
    recs = []
    for i in range(pushes):
        audio = rng.randn(agent.unit_samples).astype(np.float32) * 0.1
        agent.states.target_ids.extend(commits.get(i, []))
        reset_counts()
        reads, before_fwd = graphs.host_reads, forward_counts()
        _sync(dev)
        t0 = time.perf_counter()
        with graphs.strict_syncs():
            agent.push(audio, finished=False)
        _sync(dev)
        dt = time.perf_counter() - t0
        check_forwards(before_fwd, agent.last_result.steps,
                       cfg.llama.num_layers, f"alignatt graph {label}")
        c, st = agent.last_call, agent.states
        key = (c["n_units"], c["prompt_bucket"])
        rec = dict(
            ids=list(st.target_ids), attended=list(st.most_attended_indices),
            trace=list(agent.last_result.attn_idx), source=len(st.source),
            counts=launch_counts(), reads=graphs.host_reads - reads,
            steps=agent.last_result.steps, key=key,
            plen=c["prompt_len"], graph=agent.last_graph, wall=dt)
        if agent.last_graph == "capture":
            prog = agent._programs[key]
            rec["pool_bytes"] = graph_pool_bytes(agent._graph_pool)
            rec["static_bytes"] = _nbytes(
                (*prog.inputs, prog.probes, prog.packed))
        recs.append(rec)
    return recs, agent


def check_alignatt_graph(dev, cfg, params):
    """The AlignAtt / StreamAtt call as one captured program per (n_units,
    prompt bucket): the bench's AlignAtt (parity and early stop) and
    StreamAtt agents on the flagship W8A8 at ALIGNATT_GRAPH_DEPTH layers,
    captured against the same programs uncaptured on the card, the same
    pushes.  Fails unless the target ids, most-attended indices,
    attention traces and kept source are equal at every call; a call's
    launches equal the uncaptured call's and its forwards those its beam
    steps ran; every replay runs under sync debug mode "error" with at
    most beam steps + 1 host reads; a key is replayed at another prompt
    length; and one more call, replayed and uncaptured, runs on the
    device the port's kernels, counted by name (the profiler), that both
    recorded (the libraries' kernels are reported).
    Prints, per key, the capture's wall, the graph pool's bytes after it
    and the key's static bytes."""
    import numpy as np
    import torch

    cfg8, p8 = _cut_depth(cfg, params, *ALIGNATT_GRAPH_DEPTH)
    other_plen = False
    for label, mode, early, pushes, commits in ALIGNATT_GRAPH_RUNS:
        c, cap = _offline_graph_run(dev, cfg8, p8, mode, early, pushes,
                                    commits, True, label)
        u, unc = _offline_graph_run(dev, cfg8, p8, mode, early, pushes,
                                    commits, False, label)
        seen = {}
        for i, (a, b) in enumerate(zip(c, u)):
            for k in ("ids", "attended", "trace", "source", "plen", "key"):
                if a[k] != b[k]:
                    fail(f"[alignatt graph] {label} call {i}: captured {k} "
                         f"{a[k]} != uncaptured {b[k]}")
            if a["counts"] != b["counts"]:
                fail(f"[alignatt graph] {label} call {i}: the captured call "
                     f"launched {a['counts']}, the uncaptured {b['counts']}")
            if a["reads"] > a["steps"] + 1:
                fail(f"[alignatt graph] {label} call {i}: {a['reads']} host "
                     f"reads for {a['steps']} beam steps")
            want = "replay" if a["key"] in seen else "capture"
            if a["graph"] != want or b["graph"] != "eager":
                fail(f"[alignatt graph] {label} call {i}: key {a['key']} "
                     f"{a['graph']} (expected {want}), its twin "
                     f"{b['graph']}")
            if want == "replay" and a["plen"] != seen[a["key"]]:
                other_plen = True
            seen.setdefault(a["key"], a["plen"])
            print(f"[alignatt graph]   {label} call {i:2d}: key {a['key']} "
                  f"prompt {a['plen']} {a['graph']:7s} "
                  f"{a['wall'] * 1e3:8.2f} ms, uncaptured "
                  f"{b['wall'] * 1e3:8.2f} ms; beam steps {a['steps']}, "
                  f"host reads {a['reads']}, target ids {len(a['ids'])}",
                  flush=True)
        for a in c:
            if a["graph"] == "capture":
                print(f"[alignatt graph]   {label} key {a['key']}: capture "
                      f"call {a['wall'] * 1e3:.1f} ms (warm-up pass + "
                      f"capture), the agent's graph pool "
                      f"{a['pool_bytes'] / 2**20:.1f} MiB after it, the "
                      f"key's static buffers {a['static_bytes'] / 2**20:.2f} "
                      f"MiB", flush=True)
        shared = cap._offline
        print(f"[alignatt graph] {label}: {len(c)} calls, keys "
              f"{sorted(cap._programs)}; equal captured / uncaptured every "
              f"call; the keys share {_nbytes(shared[:3]) / 2**20:.1f} "
              f"MiB of cache (prompt buckets up to {shared.pmax}) and "
              f"{_nbytes(shared.loop) / 2**20:.1f} MiB of beam loop",
              flush=True)
        if label == "parity":
            # one more call, replayed and uncaptured, under the profiler
            audio = np.random.RandomState(6).randn(
                cap.unit_samples).astype(np.float32) * 0.1
            names, recorded = {}, {}
            for name, agent in (("captured", cap), ("uncaptured", unc)):
                replays = sum(p.replays for p in agent._programs.values())
                reset_counts()
                names[name] = device_kernel_names(
                    dev, lambda: agent.push(audio, finished=False))
                recorded[name] = launch_counts()
                if name == "captured" and sum(
                        p.replays for p in agent._programs.values()) \
                        != replays + 1:
                    fail("[alignatt graph] the profiled call did not replay")
            # the port's kernels, counted by name, must be the launches
            # both calls recorded; the libraries' kernels (cuDNN picks a
            # convolution's algorithm by the workspace it can get at the
            # time) are reported
            ours = {k: _by_group(v) for k, v in names.items()}
            if not (ours["captured"] == ours["uncaptured"]
                    == recorded["captured"] == recorded["uncaptured"]):
                fail(f"[alignatt graph] the port's kernels by name, captured "
                     f"{ours['captured']}, uncaptured {ours['uncaptured']}; "
                     f"recorded {recorded}")
            c_n, u_n = names["captured"], names["uncaptured"]
            diff = {k[:60]: (c_n.get(k, 0), u_n.get(k, 0))
                    for k in set(c_n) | set(u_n)
                    if c_n.get(k, 0) != u_n.get(k, 0)}
            print(f"[alignatt graph] a replayed call and its uncaptured twin "
                  f"ran the port's kernels the launches recorded, by name and "
                  f"count (torch.profiler): "
                  f"{ {k: n for k, n in ours['captured'].items() if n} }; all "
                  f"device kernels {sum(c_n.values())} / {sum(u_n.values())} "
                  f"({len(c_n)} / {len(u_n)} names), the names whose counts "
                  f"differ (captured, uncaptured): {diff or 'none'}",
                  flush=True)
        del cap, unc
        torch.cuda.empty_cache()
    if not other_plen:
        fail("[alignatt graph] no key was replayed at another prompt length")


def check_sample_graph(dev, cfg, params):
    """The sampling chunk as one captured program per (m, n_units, first,
    "sample"): the flagship W8A8 sampling stream (m = 1, top-k 50, top-p
    0.9) at two seeds, captured against uncaptured on the card: tokens
    equal every chunk, launches equal, forwards those the draws ran, at
    most draws + 1 host reads a chunk, replays under strict syncs.  Then
    a speculative sampling stream whose guard trips: its chunks after the
    trip replay the captured sampling program, token for token its
    uncaptured twin."""
    import torch

    for seed in SAMPLE_GRAPH_SEEDS:
        opts = dict(SAMPLE_GRAPH_OPTS, sample_seed=seed)
        c, cap = _graph_run(dev, cfg, params, opts, SAMPLE_GRAPH_CHUNKS,
                            True, "sample graph")
        u, _ = _graph_run(dev, cfg, params, opts, SAMPLE_GRAPH_CHUNKS,
                          False, "sample graph")
        for i, (a, b) in enumerate(zip(c, u)):
            if a["ids"] != b["ids"] or a["counts"] != b["counts"]:
                fail(f"[sample graph] seed {seed} chunk {i}: captured "
                     f"{a['ids']} {a['counts']} != uncaptured {b['ids']} "
                     f"{b['counts']}")
            print(f"[sample graph]   seed {seed} chunk {i}: captured "
                  f"{a['wall'] * 1e3:8.2f} ms "
                  f"({'replay' if a['replayed'] else 'warm-up + capture'})"
                  f", uncaptured {b['wall'] * 1e3:8.2f} ms; draws "
                  f"{a['steps']}, host reads {a['reads']}, tokens {a['ids']}",
                  flush=True)
        if not all(a["replayed"] for a in c[2:]):
            fail(f"[sample graph] seed {seed}: a steady chunk did not replay")
        if not any(a["ids"] for a in c):
            fail(f"[sample graph] seed {seed}: nothing was sampled")
        walls = [a["wall"] * 1e3 for a in c[2:]]
        print(f"[sample graph] seed {seed}: keys {sorted(cap._programs)}, "
              f"equal captured / uncaptured every chunk; replayed chunk wall "
              f"median {statistics.median(walls):.2f} ms (RTF "
              f"{statistics.median(walls) / 1e3 / 0.96:.4f}), uncaptured "
              f"{statistics.median(b['wall'] * 1e3 for b in u[2:]):.2f} ms",
              flush=True)
        del cap
    opts = dict(SAMPLE_GRAPH_OPTS, sample_seed=SAMPLE_GRAPH_SEEDS[0],
                speculative=True)
    c, cap = _graph_run(dev, cfg, params, opts, SPEC_SAMPLE_GRAPH_CHUNKS,
                        True, "sample graph")
    u, _ = _graph_run(dev, cfg, params, opts, SPEC_SAMPLE_GRAPH_CHUNKS,
                      False, "sample graph")
    trip = next((i for i, a in enumerate(c) if a["sampled"]), None)
    if trip is None or not cap.spec_fallback_active:
        fail("[sample graph] the speculative sampling guard did not trip")
    after = c[trip:]
    if len(after) < 3 or not all(a["replayed"] for a in after[1:]):
        fail(f"[sample graph] after the trip (chunk {trip}) the chunks did "
             "not replay the captured sampling program")
    for i, (a, b) in enumerate(zip(c, u)):
        if a["ids"] != b["ids"] or a["sampled"] != b["sampled"]:
            fail(f"[sample graph] speculative chunk {i}: captured "
                 f"{a['ids']} != uncaptured {b['ids']}")
    print(f"[sample graph] speculative sampling: the guard tripped before "
          f"chunk {trip}; chunks {trip}..{len(c) - 1} ran the sampling "
          f"program {sorted(k for k in cap._programs)} (replayed from chunk "
          f"{trip + 1}), tokens equal to the uncaptured twin every chunk; "
          f"walls {[round(a['wall'] * 1e3, 1) for a in c]} ms", flush=True)
    del cap
    torch.cuda.empty_cache()


# the speculative decoders' programs against their uncaptured twins ([spec
# graph], [spec pool graph]) and a replayed round's split ([spec profile]):
# the stream at m = 1, d = 8, k = 4 on the flagship W8A8 with the layers
# above the draft made identities (``bench.scale_residuals(..., 0)``), so
# that rounds accept, and no guard
SPEC_GRAPH_D, SPEC_GRAPH_K = 8, 4
SPEC_GRAPH_BASE = dict(speculative=True, spec_draft_layers=SPEC_GRAPH_D,
                       spec_k=SPEC_GRAPH_K, spec_guard=False)
SPEC_GRAPH_CHUNKS = 4  # the first key, the steady key, two replays
# (label, the chunk program's kind, options)
SPEC_GRAPH_RUNS = (
    ("greedy", "spec", {}),
    ("sample seed 0", "spec_sample", dict(SAMPLE_GRAPH_OPTS, sample_seed=0)),
    ("sample seed 7", "spec_sample", dict(SAMPLE_GRAPH_OPTS, sample_seed=7)),
    ("beam 4", "spec_beam", dict(spec_beam=True, beam=4)),
)
SPEC_GUARD_CHUNKS = 6  # the random draft: the guard trips after chunk 2
SPEC_POOL_TICKS = 5
SPEC_PIECES = (
    ("graph", "A", "A prologue"),  # trim, window, encoder, splice,
    # prefill, the loop's start
    ("graph", "T", "T anchor"),  # spec beam: the anchor transition
    ("graph", "R", "R round"),  # the draft, the verify, the commit
    ("graph", "F", "F finish"),  # roll-back or finalize, epilogue, packed
)


def spec_forwards(kind, rounds: int, n_layers: int, d: int, k: int) -> dict:
    """The forwards a speculative chunk (or tick) of ``rounds`` verify
    rounds runs: one prefill; greedy and sampling k draft decode_steps
    of d layers and one verify decode_step a round; spec beam k draft
    beam_token_steps and one beam_tree_step a round."""
    if kind == "spec_beam":
        want = {f"decode_step L={n_layers}": 1,
                f"beam_token_step L={d}": k * rounds,
                f"beam_tree_step L={n_layers}": rounds}
    else:
        want = {f"decode_step L={n_layers}": 1 + rounds,
                f"decode_step L={d}": k * rounds}
    return {key: n for key, n in want.items() if n}


def _graph_run(dev, cfg, params, opts, n_chunks, captured, label):
    """The flagship stream (m = 1) with ``opts`` (sampling or speculative),
    its chunks captured or uncaptured; the captured agent's under strict
    syncs.  Each chunk's forwards are held to its rounds (a speculative
    chunk) or its steps (the sampler, a guard's fallback), its host reads
    to rounds + 2 (spec beam 2 x rounds + 2) or steps + 1.  One record a
    chunk, then the agent."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core import graphs
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    agent = InfiniSSTAgent(params, cfg, StreamConfig(), builder,
                           InfiniSSTOptions(**opts),
                           param_dtype=torch.bfloat16, device=dev)
    agent._graphs_on = captured
    L = cfg.llama.num_layers
    rng = np.random.RandomState(2)
    recs = []
    for i in range(n_chunks):
        audio = rng.randn(agent.chunk_samples).astype(np.float32) * 0.1
        before = len(agent.states.target_ids)
        kind = agent._chunk_kind()
        replays = sum(p.replays for p in agent._programs.values())
        reset_counts()
        reads, before_fwd = graphs.host_reads, forward_counts()
        _sync(dev)
        t0 = time.perf_counter()
        with graphs.strict_syncs():
            agent.push(audio, finished=False)
        _sync(dev)
        dt = time.perf_counter() - t0
        res = agent.last_result
        rounds = getattr(res, "rounds", 0)
        spec = kind in ("spec", "spec_sample", "spec_beam")
        if spec:
            want = spec_forwards(kind, rounds, L,
                                 agent.opts.spec_draft_layers,
                                 agent.opts.spec_k)
            got = forwards_since(before_fwd)
            if got != want:
                fail(f"[{label}] chunk {i} ({kind}): the forward counters "
                     f"recorded {got}; {rounds} rounds ran {want}")
            bound = 2 * rounds + 2 if kind == "spec_beam" else rounds + 2
        else:  # the sampler or a guard's fallback: one forward a step
            check_forwards(before_fwd, res.steps, L, label)
            bound = res.steps + 1
        reads = graphs.host_reads - reads
        if reads > bound:
            fail(f"[{label}] chunk {i} ({kind}): {reads} host reads, "
                 f"bound {bound}")
        recs.append(dict(
            ids=list(agent.states.target_ids[before:]), wall=dt,
            counts=launch_counts(), fwd=forwards_since(before_fwd),
            reads=reads, rounds=rounds, kind=kind, sampled=kind == "sample",
            steps=None if spec else res.steps,
            accepted=getattr(res, "accepted", 0),
            drafted=getattr(res, "drafted", 0),
            replayed=sum(p.replays for p in agent._programs.values())
            > replays))
    return recs, agent


def _spec_graph_pair(dev, cfg, params, opts, n_chunks, label):
    """The same audio through the speculative stream captured and
    uncaptured: fails unless every chunk's tokens, launches and forwards
    are equal.  Returns (the captured agent, its records, the uncaptured
    records)."""
    import torch

    c, cap = _graph_run(dev, cfg, params, opts, n_chunks, True,
                        "spec graph")
    u, twin = _graph_run(dev, cfg, params, opts, n_chunks, False,
                         "spec graph")
    del twin
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(c, u)):
        if (a["ids"], a["counts"], a["fwd"], a["kind"]) != (
                b["ids"], b["counts"], b["fwd"], b["kind"]):
            fail(f"[spec graph] {label} chunk {i}: captured {a['kind']} "
                 f"{a['ids']} {a['counts']} {a['fwd']} != uncaptured "
                 f"{b['kind']} {b['ids']} {b['counts']} {b['fwd']}")
        kind = "replay" if a["replayed"] else "warm-up + capture"
        print(f"[spec graph]   {label} chunk {i}: {a['kind']} captured "
              f"{a['wall'] * 1e3:8.2f} ms ({kind}), uncaptured "
              f"{b['wall'] * 1e3:8.2f} ms; rounds {a['rounds']}, accepted "
              f"{a['accepted']} of {a['drafted']}, host reads {a['reads']}, "
              f"forwards {a['fwd']}, tokens {a['ids']}", flush=True)
    return cap, c, u


def _replayed_walls(c, u):
    walls = [a["wall"] * 1e3 for a in c if a["replayed"]]
    uwalls = [b["wall"] * 1e3 for a, b in zip(c, u) if a["replayed"]]
    return statistics.median(walls), statistics.median(uwalls)


def check_spec_graph(dev, cfg, params, paths):
    """The speculative chunk programs, (m, n_units, first, "spec" /
    "spec_sample" / "spec_beam"), captured against uncaptured on the
    card: the flagship W8A8 stream at m = 1, d = 8, k = 4 with the layers
    above the draft made identities and no guard (greedy, sampling at
    two seeds, speculative beam 4), SPEC_GRAPH_CHUNKS chunks each: tokens,
    launches and forwards equal every chunk, forwards those the rounds
    ran, host reads within rounds + 2 (spec beam: 2 x rounds + 2), replays
    under strict syncs, the steady chunks replayed.  Then the random
    draft with the guard on: it trips and the fallback's beam-1 program
    replays."""
    import torch

    from infinisst_tpu_torch.bench import scale_residuals

    ident = scale_residuals(params, SPEC_GRAPH_D, 0.0)
    for label, kind, extra in SPEC_GRAPH_RUNS:
        opts = dict(SPEC_GRAPH_BASE, **extra)
        cap, c, u = _spec_graph_pair(dev, cfg, ident, opts,
                                     SPEC_GRAPH_CHUNKS, label)
        if {a["kind"] for a in c} != {kind}:
            fail(f"[spec graph] {label}: chunks ran {[a['kind'] for a in c]}")
        if not all(a["replayed"] for a in c[2:]):
            fail(f"[spec graph] {label}: a steady chunk did not replay")
        acc = sum(a["accepted"] for a in c) / max(sum(a["drafted"]
                                                      for a in c), 1)
        if not acc > 0 or not any(a["ids"] for a in c):
            fail(f"[spec graph] {label}: acceptance {acc}, tokens "
                 f"{[a['ids'] for a in c]}")
        med, umed = _replayed_walls(c, u)
        print(f"[spec graph] {label}: keys {sorted(cap._programs)}, equal "
              f"captured / uncaptured every chunk; acceptance {acc:.4f}; "
              f"replayed chunk wall median {med:.2f} ms (RTF "
              f"{med / 1e3 / 0.96:.4f}), uncaptured {umed:.2f} ms; rounds "
              f"{[a['rounds'] for a in c]}", flush=True)
        paths[f"spec graph {kind}"] = (
            f"flagship W8A8 captured speculative stream ({label}, d = "
            f"{SPEC_GRAPH_D}, k = {SPEC_GRAPH_K}), a replayed chunk of "
            f"{c[-1]['rounds']} rounds", c[-1]["counts"])
        del cap
        torch.cuda.empty_cache()
    opts = dict(SPEC_GRAPH_BASE, spec_guard=True)
    cap, c, u = _spec_graph_pair(dev, cfg, params, opts, SPEC_GUARD_CHUNKS,
                                 "guard")
    trip = next((i for i, a in enumerate(c) if a["kind"] == 1), None)
    if trip is None or not cap.spec_fallback_active:
        fail("[spec graph] the guard did not trip on the random draft")
    after = c[trip:]
    if len(after) < 2 or not all(a["replayed"] for a in after[1:]):
        fail(f"[spec graph] after the trip (chunk {trip}) the fallback's "
             "program did not replay")
    print(f"[spec graph] guard: tripped before chunk {trip}; chunks "
          f"{trip}..{len(c) - 1} ran the beam-1 program (replayed from "
          f"chunk {trip + 1}); keys {list(cap._programs)}", flush=True)
    del cap
    torch.cuda.empty_cache()


def check_spec_pool_graph(dev, cfg, params, paths):
    """The speculative pool's tick programs ("spec", "spec_sample"):
    the flagship W8A8 pool of 8 at d = 8, k = 4, multipliers (1, 2), the
    layers above the draft made identities and no guard, captured against
    uncaptured: every slot's tokens equal every tick, launches equal,
    forwards those the rounds ran, host reads within rounds + 2."""
    import torch

    from infinisst_tpu_torch.bench import scale_residuals

    ident = scale_residuals(params, SPEC_GRAPH_D, 0.0)
    for label, kind, extra in (("greedy", "spec", {}),
                               ("sampling", "spec_sample",
                                dict(do_sample=True, top_k=50, top_p=0.9))):
        kw = dict(speculative=True, spec_draft_layers=SPEC_GRAPH_D,
                  spec_k=SPEC_GRAPH_K, spec_guard=False, **extra)
        cap, c, u = _pool_pair(dev, cfg, ident, 1, SPEC_POOL_TICKS, None,
                               f"spec {label}", tag="spec pool graph", **kw)
        if list(cap._programs) != [kind]:
            fail(f"[spec pool graph] {label} ran {sorted(cap._programs)}")
        steady = [i for i, a in enumerate(c) if a["replayed"]]
        w = [c[i]["wall"] * 1e3 for i in steady]
        uw = [u[i]["wall"] * 1e3 for i in steady]
        print(f"[spec pool graph] {label}: replayed tick wall median "
              f"{statistics.median(w):.2f} ms, uncaptured "
              f"{statistics.median(uw):.2f} ms; rounds a tick "
              f"{[a['rounds'] for a in c]}; statistics {cap.spec_stats}",
              flush=True)
        paths[f"spec pool graph {kind}"] = (
            f"flagship W8A8 captured speculative pool of 8 ({label}), a "
            f"replayed tick of {c[-1]['rounds']} rounds", c[-1]["counts"])
        del cap
        torch.cuda.empty_cache()


def check_spec_profile(dev, cfg, params):
    """A replayed speculative greedy chunk of the flagship W8A8 stream
    (d = 8, k = 4, the layers above the draft identities) under the
    profiler: its kernels counted by name against the recorded launches,
    the device ms by piece (A, R, F) and, within R, the draft (from the
    round's start to the verify's first port kernel: the anchor, the k
    draft forwards and their processors) against the verify (the rest:
    the full forward, the acceptance, the commit); the torch counterpart
    of ``tools_spec_decompose.py``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.bench import scale_residuals
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.tools.op_split import port_kernel

    ident = scale_residuals(params, SPEC_GRAPH_D, 0.0)
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    agent = InfiniSSTAgent(ident, cfg, StreamConfig(), builder,
                           InfiniSSTOptions(**SPEC_GRAPH_BASE),
                           param_dtype=torch.bfloat16, device=dev)
    rng = np.random.RandomState(5)

    def push():
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1)

    walls = []
    for i in range(6):
        _sync(dev)
        t0 = time.perf_counter()
        push()
        _sync(dev)
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(walls)
    replays = sum(p.replays for p in agent._programs.values())
    keep = {}
    profile_run(dev, push, SPEC_PIECES, "spec profile", med, "chunk",
                hold_launches=True, keep=keep)
    if sum(p.replays for p in agent._programs.values()) != replays + 1:
        fail("[spec profile] the profiled chunk did not replay its program")
    rounds = agent.last_result.rounds
    # within R: the draft's port kernels come first (k forwards of d
    # layers, a8_forward_launches(d) each), then the verify's
    n_draft = SPEC_GRAPH_K * sum(a8_forward_launches(SPEC_GRAPH_D).values())
    spans, events = [], []
    for e in keep["prof"].events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name == "stage::R round":
            spans.append((e.time_range.start, e.time_range.end))
        else:
            port = port_kernel(e.name) is not None
            events.append((e.time_range.start, e.time_range.elapsed_us(),
                           port))
    events.sort()
    draft = verify = 0.0
    for a, b in spans:
        inside = [ev for ev in events if a <= ev[0] < b]
        port = [ev for ev in inside if ev[2]]
        if len(port) <= n_draft:
            fail(f"[spec profile] a round ran {len(port)} port kernels, "
                 f"the draft alone {n_draft}")
        cut = port[n_draft][0]
        draft += sum(d for s, d, _ in inside if s < cut) / 1e3
        verify += sum(d for s, d, _ in inside if s >= cut) / 1e3
    if len(spans) != rounds:
        fail(f"[spec profile] {len(spans)} R ranges for {rounds} rounds")
    print(f"[spec profile] the replayed chunk's {rounds} rounds (programs "
          f"{sorted(agent._programs)}, {replays + 1} replays): device "
          f"kernels within R {draft + verify:.2f} ms, the draft (anchor, "
          f"{SPEC_GRAPH_K} forwards of {SPEC_GRAPH_D} layers, processors) "
          f"{draft:.2f} ms ({draft / rounds:.3f} a round), the verify (the "
          f"32-layer forward over {SPEC_GRAPH_K + 1} tokens, acceptance, "
          f"commit) {verify:.2f} ms ({verify / rounds:.3f} a round); "
          f"{agent.last_result.n_tokens} tokens; replayed chunk wall median "
          f"{med:.2f} ms (RTF {med / 1e3 / 0.96:.4f})", flush=True)
    del agent
    torch.cuda.empty_cache()


def check_alignatt_profile(dev, cfg, params):
    """The flagship W8A8 weights in the bench's AlignAtt agent, whose call
    is one captured program per (n_units, prompt bucket), and a twin
    agent: both take the same two calls (one 960 ms chunk padded to the
    28.8 s cap shape, 24 beam steps: the key's warm-up pass and capture;
    then a replay), timed; then the same third call, replayed, timed on
    the agent and under torch.profiler on the twin (device time by
    piece, idle share against the twin's wall and the agent's; the
    kernels the profiler saw, counted by name, equal the launches the
    graphs recorded at capture); then a call over 28.8 s of audio and the
    first replayed call after it (the target may cross into the next
    prompt bucket, whose first call captures its key) with CUDA events
    around each piece (64 beam steps, the parity mode's steady state:
    device ms by piece, idle share)."""
    import numpy as np
    import torch

    from infinisst_tpu_torch import bench

    rng = np.random.RandomState(3)

    def chunk(n=1):
        return rng.randn(n * 15360).astype(np.float32) * 0.1

    def describe(agent, wall, what):
        c, res = agent.last_call, agent.last_result
        print(f"[alignatt profile] {what} over {len(agent.states.source)} "
              f"samples: {wall * 1e3:.2f} ms ({agent.last_graph}), "
              f"{res.steps} beam steps (max_steps {c['max_steps']}), audio "
              f"units {c['n_units']}, prompt {c['prompt_len']} in a bucket "
              f"of {c['prompt_bucket']}", flush=True)

    def timed_push(agent, audio):
        _sync(dev)
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        _sync(dev)
        return time.perf_counter() - t0

    agent = bench.offline_agent("alignatt", False, cfg, params, dev)
    twin = bench.offline_agent("alignatt", False, cfg, params, dev)
    for what in ("first call", "second call"):
        audio = chunk()
        describe(agent, timed_push(agent, audio), what)
        describe(twin, timed_push(twin, audio), f"{what}, the twin")
    audio = chunk()
    wall = timed_push(agent, audio)
    describe(agent, wall, "third call")
    profile_run(dev, lambda: twin.push(audio, finished=False), PIECES,
                "alignatt profile", wall * 1e3, "replayed call",
                hold_launches=True)
    if twin.last_graph != "replay" or agent.last_graph != "replay":
        fail("[alignatt profile] the third call did not replay its program")
    if twin.last_result != agent.last_result:
        fail("[alignatt profile] the profiled twin's call differs from the "
             "agent's")
    describe(twin, wall, "the twin's third call, profiled")
    del twin
    wall = timed_push(agent, chunk(29))
    describe(agent, wall, "call")
    spans = {}

    def wrap(name, fn):
        def timed():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            spans.setdefault(name, []).append((e0, e1))
            return out
        return timed

    # the target may cross into the next prompt bucket, whose first call
    # is its key's warm-up pass and capture: time the first replay
    for _ in range(3):
        spans.clear()
        with wrapped_pieces(wrap):
            wall = timed_push(agent, chunk()) * 1e3
        describe(agent, wall / 1e3, "call, CUDA events around each piece")
        if agent.last_graph == "replay":
            break
    else:
        fail("[alignatt stages] three calls in a row did not replay")
    dev_ms = {k: sum(a.elapsed_time(b) for a, b in v)
              for k, v in spans.items()}
    busy = sum(dev_ms.values())
    steps = agent.last_result.steps
    step_dev = (dev_ms.get("B beam select", 0.0)
                + dev_ms.get("C beam forward", 0.0)) / max(steps, 1)
    print(f"[alignatt stages] one replayed call, CUDA events around each "
          f"replayed piece: wall {wall:.2f} ms, {steps} beam steps, device "
          f"{busy:.2f} ms, idle share {1.0 - busy / wall:.4f}; by piece "
          f"{ {k: round(v, 3) for k, v in dev_ms.items()} }; a beam step "
          f"{step_dev:.3f} ms of device time and "
          f"{(wall - dev_ms.get('A prologue', 0.0)) / max(steps, 1):.3f} "
          f"ms of wall", flush=True)
    del agent
    torch.cuda.empty_cache()


def check_serve_profile(dev, cfg, params):
    """The flagship W8A8 weights in a ServingEngine (pool 8, beam 4, m=1,
    the bench's serve defaults; its tick captured at tick 0): five ticks
    of one chunk of seeded noise per slot (tick wall, forwards, tokens),
    one tick with a synchronise around each replayed piece, one under
    torch.profiler, and the trim alone: one evict_cache over the whole
    pool cache, timed with CUDA events."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.serve.engine import ServingEngine

    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    eng = ServingEngine(params, cfg, StreamConfig(),
                        {("English", "German"): builder}, pool_size=8,
                        beam=4, dtype=torch.bfloat16, device=dev)
    slots = [eng.open_stream(f"c{i}") for i in range(eng.pool)]
    rng = np.random.RandomState(1)

    def tick():
        for s in slots:
            eng.push_audio(s, rng.randn(eng.chunk_samples).astype(
                np.float32) * 0.1)
        eng.tick()

    walls = []
    for i in range(5):
        fwd, toks = eng.forwards["token"], sum(len(eng.slots[s].target_ids)
                                               for s in slots)
        _sync(dev)
        t0 = time.perf_counter()
        tick()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        new = sum(len(eng.slots[s].target_ids) for s in slots) - toks
        print(f"  [serve profile] tick {i}: {walls[-1] * 1e3:.2f} ms, "
              f"{eng.forwards['token'] - fwd} token forwards, {new} tokens "
              f"({new / walls[-1]:.1f} tok/s), valid_len "
              f"{eng.valid_len_host.tolist()}", flush=True)
    med = statistics.median(walls[1:]) * 1e3
    spent, wall = timed_stages(dev, tick, PIECES)
    print(f"[serve stages] one tick with a synchronise around each piece: "
          f"wall {wall * 1e3:.2f} ms (median unsynchronised tick {med:.2f} "
          f"ms)", flush=True)
    for stage in PIECES:  # the pool's tick is a program of these pieces
        name = stage_label(stage)
        n, t = spent.get(name, (0, 0.0))
        print(f"[serve stages]   {name:19s} replays {n:2d}  {t * 1e3:9.2f} "
              f"ms", flush=True)
    n, t = spent.get("B beam select", (0, 0.0))
    print(f"[serve stages]   a beam step's bookkeeping (log-softmax, "
          f"processors, top-2B, add_hyp, reorder): {t / max(n, 1) * 1e3:.3f} "
          f"ms of wall a replay", flush=True)
    profile_run(dev, tick, PIECES, "serve profile", med, "tick")
    # the trim: keep the last 500 of each slot's cache, the system prompt
    # pinned (the gather costs the same whatever it keeps)
    keep = torch.full((eng.pool,), 500, dtype=torch.int64)
    sys_len = torch.full((eng.pool,), 40, dtype=torch.int64)
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trimmed = L.evict_cache(eng.dec_state, keep, sys_len)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del trimmed
    nbytes = 2 * 2 * eng.dec_state.k.numel() * eng.dec_state.k.element_size()
    print(f"[serve profile] evict_cache over the pool cache "
          f"{tuple(eng.dec_state.k.shape)} x 2: {sorted(times)} ms "
          f"(bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms: K and V "
          "read and written once)", flush=True)
    del eng
    torch.cuda.empty_cache()


POOL_GRAPH_TICKS = 14  # the mixed (1, 2) pool: m=2 slots tick every other
POOL_GRAPH_CACHE = 300  # max_llm_cache_tokens: trims within the ticks
POOL_GRAPH_MS = (1, 2) * 4  # the 8 slots' multipliers
GREEDY_TICKS = 4  # the beam-1 pool's greedy program


def _pool_engine(dev, cfg, params, beam, captured, cache=None, **kw):
    """The flagship pool of 8 at ``beam``, multipliers (1, 2) (``kw``:
    more of the engine's options): its tick the captured program, or the
    same functions uncaptured."""
    import torch

    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.serve.engine import ServingEngine

    stream = (StreamConfig() if cache is None
              else StreamConfig(max_llm_cache_tokens=cache))
    eng = ServingEngine(params, cfg, stream, {("English", "German"):
                        PromptBuilder(StubTokenizer(cfg.llama.vocab_size),
                                      cfg.tokens)},
                        pool_size=8, beam=beam, multipliers=(1, 2),
                        dtype=torch.bfloat16, device=dev, **kw)
    eng._graphs_on = captured  # the private hook: uncaptured on the card
    return eng


def _pool_run(dev, eng, ms, n_ticks, label):
    """``n_ticks`` ticks of one 960 ms unit of seeded noise a slot (slot i
    at multiplier ms[i]); a captured engine's ticks under
    ``graphs.strict_syncs()``.  Each tick's forwards are held to its beam
    steps (a speculative tick's to its rounds).  Returns one record a
    tick."""
    import contextlib

    import numpy as np

    from infinisst_tpu_torch.core import graphs

    slots = [eng.open_stream(f"c{i}", multiplier=m)
             for i, m in enumerate(ms)]
    rng = np.random.RandomState(4)
    push = eng.stream.chunk_samples(1)
    _, A = _kernel_modules()
    recs = []
    for i in range(n_ticks):
        for s in slots:
            eng.push_audio(s, rng.randn(push).astype(np.float32) * 0.1)
        replays = sum(p.replays for p in eng._programs.values())
        reset_counts()
        reads, fwd = graphs.host_reads, eng.forwards["token"]
        verify = eng.forwards["verify"]
        before_fwd = forward_counts()
        strict = graphs.strict_syncs() if eng._graphs_on else \
            contextlib.nullcontext()
        _sync(dev)
        t0 = time.perf_counter()
        with strict:
            eng.tick()
        _sync(dev)
        dt = time.perf_counter() - t0
        n_fwd = eng.forwards["token"] - fwd
        rounds = eng.forwards["verify"] - verify
        if eng.beam > 1:
            check_forwards(before_fwd, n_fwd + 1, eng.cfg.llama.num_layers,
                           f"pool graph {label}")
        if eng.speculative:
            want = spec_forwards("spec", rounds, eng.cfg.llama.num_layers,
                                 eng.spec_draft_layers, eng.spec_k)
            if forwards_since(before_fwd) != want:
                fail(f"[pool graph {label}] tick {i}: the forward counters "
                     f"recorded {forwards_since(before_fwd)}; {rounds} "
                     f"rounds ran {want}")
        recs.append(dict(
            ids=[list(eng.slots[s].target_ids) for s in slots], wall=dt,
            counts=launch_counts(), shapes=dict(A.launch_shapes),
            reads=graphs.host_reads - reads, steps=n_fwd + 1,
            rounds=rounds, evictions=eng.evictions,
            ticked=len(eng.last_ticked),
            replayed=sum(p.replays for p in eng._programs.values())
            > replays))
    return recs


def _pool_pair(dev, cfg, params, beam, n_ticks, cache, label,
               tag="pool graph", **kw):
    """The same audio through the pool (``kw``: more of the engine's
    options) captured and uncaptured: fails unless every slot's tokens
    are equal after every tick, a replayed tick launches what the
    uncaptured tick does, and a tick reads the device at most steps + 1
    times (a speculative tick rounds + 2).  Returns (the captured engine,
    its records, the uncaptured records)."""
    import torch

    runs = {}
    for name, on in (("captured", True), ("uncaptured", False)):
        eng = _pool_engine(dev, cfg, params, beam, on, cache, **kw)
        runs[name] = (eng if on else None,
                      _pool_run(dev, eng, POOL_GRAPH_MS, n_ticks,
                                f"{label} {name}"))
        del eng
    torch.cuda.empty_cache()
    (cap, c), (_, u) = runs["captured"], runs["uncaptured"]
    for i, (a, b) in enumerate(zip(c, u)):
        if a["ids"] != b["ids"]:
            fail(f"[{tag}] {label} tick {i}: captured {a['ids']} != "
                 f"uncaptured {b['ids']}")
        if a["counts"] != b["counts"] or a["shapes"] != b["shapes"]:
            fail(f"[{tag}] {label} tick {i}: the captured tick launched "
                 f"{a['counts']} {a['shapes']}, the uncaptured tick "
                 f"{b['counts']} {b['shapes']}")
        bound = a["rounds"] + 2 if a["rounds"] else a["steps"] + 1
        if a["reads"] > bound:
            fail(f"[{tag}] {label} tick {i}: {a['reads']} host reads "
                 f"for {a['steps']} steps, {a['rounds']} rounds")
    if not all(a["replayed"] for a in c[1:]):
        fail(f"[{tag}] {label}: a tick after the first did not replay")
    print(f"[{tag}] {label}: {len(c)} ticks, programs "
          f"{sorted(cap._programs)}, evictions {cap.evictions}; every "
          f"slot's tokens equal captured / uncaptured every tick "
          f"({sum(map(len, c[-1]['ids']))} tokens); every tick's launches "
          f"equal the uncaptured tick's; replays under sync debug mode "
          f"\"error\" synchronised only at the reads", flush=True)
    for i, (a, b) in enumerate(zip(c, u)):
        kind = "replay" if a["replayed"] else "warm-up + capture"
        print(f"[{tag}]   {label} tick {i:2d}: {a['ticked']} slots, "
              f"captured {a['wall'] * 1e3:8.2f} ms ({kind}), uncaptured "
              f"{b['wall'] * 1e3:8.2f} ms; steps {a['steps']}, rounds "
              f"{a['rounds']}, host reads "
              f"{a['reads']}, launches "
              f"{ {k: v for k, v in a['counts'].items() if v} } "
              f"{a['shapes']}", flush=True)
    return cap, c, u


def check_pool_graph(dev, cfg, params, paths):
    """The serving pool's tick as captured CUDA graphs (JAX's one-jit
    step): the flagship W8A8 pool of 8 at beam 4, multipliers (1, 2),
    POOL_GRAPH_TICKS ticks with trims, against the same functions
    uncaptured; the tick walls (median, p95), the host reads against
    steps + 1, a replayed tick under the profiler (its kernels counted
    by name against the recorded launches, kernel ms, idle share); then
    the greedy program on a beam-1 pool."""
    import numpy as np
    import torch

    cap, c, u = _pool_pair(dev, cfg, params, 4, POOL_GRAPH_TICKS,
                           POOL_GRAPH_CACHE, "beam 4")
    if not any(a["evictions"] for a in c[:-1]):
        fail("[pool graph] beam 4: no trim was applied")
    steady = [i for i, a in enumerate(c) if a["replayed"]]
    for name, recs in (("captured", c), ("uncaptured", u)):
        w = sorted(recs[i]["wall"] * 1e3 for i in steady)
        n = len(w)
        p95 = w[min(n - 1, math.ceil(0.95 * n) - 1)]
        print(f"[pool graph] beam 4 {name}: tick wall median "
              f"{statistics.median(w):.2f} ms, p95 {p95:.2f} ms over {n} "
              f"ticks", flush=True)
    print(f"[pool graph] host reads a tick {[c[i]['reads'] for i in steady]}"
          f" for steps {[c[i]['steps'] for i in steady]}", flush=True)
    # one more replayed tick under the profiler, every slot ticking
    slots = list(range(8))
    rng = np.random.RandomState(9)

    def tick():
        for s in slots:
            cap.push_audio(s, rng.randn(cap.stream.chunk_samples(2)).astype(
                np.float32) * 0.1)
        cap.tick()

    med = statistics.median(c[i]["wall"] for i in steady) * 1e3
    replays = cap._programs["beam"].replays
    reset_counts()
    busy, wall = profile_run(dev, tick, PIECES, "pool graph profile", med,
                             "tick", hold_launches=True)
    if cap._programs["beam"].replays != replays + 1:
        fail("[pool graph] the profiled tick did not replay its program")
    if len(cap.last_ticked) != 8:
        fail(f"[pool graph] the profiled tick ticked {cap.last_ticked}")
    _, A = _kernel_modules()
    paths["pool_graph"] = (
        "flagship W8A8 captured pool of 8, beam 4, a replayed tick of all "
        "8 slots", launch_counts(), dict(A.launch_shapes))
    print(f"[pool graph] the profiled tick: {paths['pool_graph'][1]} "
          f"{paths['pool_graph'][2]}", flush=True)
    del cap
    torch.cuda.empty_cache()
    # the greedy program: a beam-1 pool, captured against uncaptured
    gcap, _, _ = _pool_pair(dev, cfg, params, 1, GREEDY_TICKS, None,
                            "beam 1")
    if list(gcap._programs) != ["greedy"]:
        fail(f"[pool graph] beam 1 ran {sorted(gcap._programs)}")
    del gcap
    torch.cuda.empty_cache()


def check_weight_only(dev, paths, speech):
    import torch

    from infinisst_tpu_torch.bench import flagship_params

    print("[weight_only] 8B {'q_kmajor','scale'} projections", flush=True)
    cfg, params = flagship_params(dev, act_int8=False, speech=speech)
    r = stream_8b(dev, cfg, params, min_chunks=4, max_chunks=4,
                  need_evict=False, label="w8")
    want = r["forwards"] * 7 * r["n_layers"]
    c = r["counts"]
    # the W8A8 head's quantizer fused into final_ln: one each a forward
    if not (c["w8_bf16_gemm"] == want
            and c["w8a8_gemm"] == c["rms_norm_quant_int8"] == r["forwards"]
            and c["row_quant_int8"] == c["silu_mul_quant_int8"] == 0):
        fail(f"[weight_only] launches {c}, expected w8_bf16_gemm {want} "
             f"and the W8A8 head's w8a8_gemm and rms_norm_quant_int8 "
             f"{r['forwards']}")
    if internal_counts()["w8_bf16_gemm_f32_cast"]:
        fail("[weight_only] the bf16 stream rounded float32 activations")
    rtf = [t / r["chunk_sec"] for t in r["times"][1:]]
    print(f"[weight_only] chunks {r['chunks']}; forwards {r['forwards']};"
          f" launches {c}; RTF chunks 1..: "
          f"{[round(x, 4) for x in rtf]}", flush=True)
    paths["w8_bf16_gemm"] = ("weight-only stream", c)
    profile_chunk(dev, r, label="w8 profile")
    del params, r
    torch.cuda.empty_cache()


def check_group128(dev, paths, speech):
    import torch

    from infinisst_tpu_torch.bench import flagship_params

    print(f"[group128] 8B grouped W8A8 projections (groups of {GROUP}), "
          "per-channel W8A8 lm_head", flush=True)
    cfg, params = flagship_params(dev, act_int8=True, speech=speech,
                                  group_size=GROUP)
    r = stream_8b(dev, cfg, params, min_chunks=4, max_chunks=4,
                  need_evict=False, label="g128")
    L, c = r["n_layers"], r["counts"]
    # a8_forward_launches(L, grouped): the grouped norms and SwiGLU
    # products fused, group_quant_int8 before o, the per-channel head's
    # norm quantized per row
    want = {k: r["forwards"] * n
            for k, n in a8_forward_launches(L, grouped=True).items()}
    want["w8_bf16_gemm"] = 0
    if any(c[k] != n for k, n in want.items()):
        fail(f"[group128] launches {c}, expected {want} for "
             f"{r['forwards']} forwards")
    rtf = [t / r["chunk_sec"] for t in r["times"][1:]]
    print(f"[group128] chunks {r['chunks']}; forwards {r['forwards']}; "
          f"launches {c}; RTF chunks 1..: {[round(x, 4) for x in rtf]} "
          "(bring-up reading)", flush=True)
    for name in ("w8a8_grouped_gemm", "group_quant_int8"):
        paths[name] = ("group128 stream", c)
    paths["group128"] = ("group128 stream", c)
    profile_chunk(dev, r, label="g128 profile")
    del params, r
    torch.cuda.empty_cache()


def check_multiplier(dev, r):
    """On the flagship stream: update_multiplier(2), then (4), one chunk
    at each.  The encoder takes 96, then 192 frames; beam_attention is
    launched once per layer per beam forward, the GEMMs and quantizers as
    ``a8_forward_launches`` says a forward."""
    import numpy as np

    agent = r["agent"]
    L = r["n_layers"]
    for m in (2, 4):
        agent.update_multiplier(m)
        frames = int(agent.enc_state.n_frames[0])
        audio = r["rng"].randn(agent.chunk_samples).astype(np.float32) * 0.1
        reset_counts()
        before_fwd = forward_counts()
        _sync(dev)
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        _sync(dev)
        dt = time.perf_counter() - t0
        counts = launch_counts()
        steps = agent.last_result.steps  # 1 prefill + steps - 1 beam forwards
        check_forwards(before_fwd, steps, L, "multiplier")
        got = int(agent.enc_state.n_frames[0]) - frames
        rtf = dt / (agent.chunk_samples / 16000)
        print(f"[multiplier] m={m}: chunk {agent.chunk_samples} samples, "
              f"{dt * 1e3:.2f} ms, RTF {rtf:.4f}; encoder frames +{got}; "
              f"max_new {agent.max_new}; forwards "
              f"{steps}; emitted {agent.pend_n_host}; launches {counts}",
              flush=True)
        if got != 48 * m:
            fail(f"[multiplier] m={m}: the encoder took {got} frames, "
                 f"expected {48 * m}")
        if counts["beam_attention"] != (steps - 1) * L:
            fail(f"[multiplier] m={m}: beam_attention launched "
                 f"{counts['beam_attention']} times, expected "
                 f"{steps - 1} beam forwards x {L} layers")
        for k, n in a8_forward_launches(L).items():
            if counts[k] != steps * n:
                fail(f"[multiplier] m={m}: {k} launched {counts[k]} times, "
                     f"expected {steps} forwards x {n}")


def check_bench():
    """``python -m infinisst_tpu_torch.bench`` with its defaults
    (``run_main``): exit 0, and its last stdout line is the JSON line of
    bench.py with metric streaming_rtf_m1_beam4_8b_int8 over 9 timed
    chunks."""
    out = run_main("infinisst_tpu_torch.bench", [])
    for line in out.stderr.strip().splitlines()[-16:]:
        print(f"[bench]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[bench] bench exited {out.returncode}")
    lines = out.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"[bench] its last stdout line is not JSON: {lines[-1:]}")
    missing = [k for k in BENCH_KEYS if k not in result]
    if result.get("metric") != BENCH_METRIC or missing:
        fail(f"[bench] metric {result.get('metric')!r} (expected "
             f"{BENCH_METRIC!r}), missing keys {missing}")
    if "chunks=9 " not in out.stderr:
        fail("[bench] the bench did not time 9 chunks")
    launches = [json.loads(line[len("kernel launches "):]) for line in
                out.stderr.splitlines() if line.startswith("kernel launches ")]
    if not launches or not all(launches[-1].get(k, 0) > 0 for k in (
            "w8a8_gemm", "row_quant_int8", "beam_attention",
            "rms_norm_quant_int8", "silu_mul_quant_int8")):
        fail(f"[bench] the flagship kernels were not launched: {launches}")
    if not (math.isfinite(result["value"]) and result["value"] > 0):
        fail(f"[bench] RTF {result['value']}")
    print(f"[bench] {json.dumps(result)}", flush=True)


def _stderr_json(stderr, prefix):
    """The JSON object after ``prefix`` on the last stderr line that
    starts with it, or None."""
    lines = [ln for ln in stderr.splitlines() if ln.startswith(prefix)]
    return json.loads(lines[-1][len(prefix):]) if lines else None


def run_serve_bench(extra, metric, n_layers=32):
    """``python -m infinisst_tpu_torch.bench --mode serve`` + ``extra``
    (``run_main``): exit 0, its last stdout line the serve JSON line with
    ``metric``, and its launches on stderr those of the forwards it ran:
    beam_attention token forwards x L (all at B=32 over Bc=8 prefix
    caches, each read by its slot's 4 beams), the GEMMs and quantizers
    ``a8_forward_launches(L)`` a forward, no other kernel.
    Returns (result, launches, launches by shape, forwards)."""
    argv = ["--mode", "serve"] + extra
    out = run_main("infinisst_tpu_torch.bench", argv)
    for line in out.stderr.strip().splitlines()[-24:]:
        print(f"[serve]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[serve] bench {' '.join(argv)} exited {out.returncode}")
    lines = out.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"[serve] its last stdout line is not JSON: {lines[-1:]}")
    missing = [k for k in SERVE_KEYS if k not in result]
    if result.get("metric") != metric or missing:
        fail(f"[serve] metric {result.get('metric')!r} (expected "
             f"{metric!r}), missing keys {missing}")
    if not (math.isfinite(result["value"]) and result["value"] > 0):
        fail(f"[serve] {result['value']} tok/s")
    counts = _stderr_json(out.stderr, "kernel launches ")
    shapes = _stderr_json(out.stderr, "attention launches by shape ")
    fwd = _stderr_json(out.stderr, "engine forwards ")
    progs = _stderr_json(out.stderr, "pool programs ")
    if counts is None or shapes is None or fwd is None:
        fail("[serve] the bench did not report its launches and forwards")
    # the pool's tick is the captured program: captured in the untimed
    # tick, replayed in every timed one
    beam = (progs or {}).get("beam", {})
    if not beam.get("captured") or beam.get("replays", 0) < 2:
        fail(f"[serve] the pool's tick program did not replay: {progs}")
    reads = [int(x) for x in re.findall(r"(\d+) host reads",
                                        out.stderr)]
    steps = [int(x) + 1 for x in re.findall(r"(\d+) token forwards",
                                            out.stderr)]
    if not reads or any(r > n + 1 for r, n in zip(reads, steps)):
        fail(f"[serve] host reads a tick {reads} for steps {steps}")
    print(f"[serve] the tick captured, {beam['replays']} replays; host "
          f"reads a tick {reads} for steps {steps}", flush=True)
    tok, total = fwd["token"], fwd["prefill"] + fwd["token"]
    L = n_layers
    want = {"beam_attention": tok * L, "decode_attention": 0,
            "w8_bf16_gemm": 0,
            **{k: total * n for k, n in a8_forward_launches(L).items()}}
    got = {k: counts.get(k, 0) for k in want}
    want_shapes = {"beam B=32 Bc=8": tok * L}
    if got != want or shapes != want_shapes or tok <= 0:
        fail(f"[serve] launches {got} by shape {shapes} for forwards {fwd}; "
             f"expected {want} and {want_shapes}")
    print(f"[serve] {json.dumps(result)}", flush=True)
    print(f"[serve] forwards {fwd}: launches {got}, beam_attention by "
          f"shape {shapes} (B=32 over Bc=8 prefix caches, each read by its "
          "slot's 4 beams, and each row's per-beam block)", flush=True)
    return result, counts, shapes, fwd


def check_serve(paths):
    """The port bench's serve mode at its defaults (pool 8, beam 4, m=1,
    12 timed ticks), then a mixed (1, 2) pool of 2 chunks; row 5's path
    is the first run's pool prefix."""
    _, counts, shapes, _ = run_serve_bench([], SERVE_METRIC)
    paths["beam_attention_pool"] = ("serve bench (pool 8, beam 4)", {
        "beam_attention": shapes["beam B=32 Bc=8"]})
    run_serve_bench(["--multipliers", "1,2", "--chunks", "2"],
                    SERVE_MIXED_METRIC)


STREAMATT_CHUNKS, STREAMATT_TIMED_FROM = 16, 2
ALIGNATT_METRICS = {False: "alignatt_rtf_beam4_parity_8b_int8",
                    True: "alignatt_rtf_beam4_es_8b_int8"}
STREAMATT_METRIC = "streamatt_rtf_beam4_8b_int8"
# the direct StreamAtt drive: its own window (chunks 2-15), not the bench's
STREAMATT_DIRECT_METRIC = "streamatt_direct16_rtf_beam4_8b_int8"
OFFLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "rtf_median",
                "rtf_p95")
# the bench's chunk line (bench.run_offline): its fields in the order of
# run_offline's records (wall, steps, max_steps, prompt bucket, target
# ids, source samples, prompt length, audio units)
CHUNK_LINE = re.compile(
    r"chunk (\d+): ([\d.]+)s steps=(\d+) max_steps=(\d+) "
    r"prompt_bucket=(\d+) tgt=(\d+) source=(\d+) prompt_len=(\d+) "
    r"units=(\d+)")


def check_offline_launches(label, counts, calls, n_layers=32,
                           beam_forwards=True):
    """The launches of offline calls (bench.run_offline records): a call
    runs one prefill and steps - 1 beam forwards, so the GEMMs and
    quantizers ``a8_forward_launches(L)`` a forward, beam_attention L a
    beam forward, and no other kernel; each launched unless
    ``beam_forwards`` is false (calls may then all stop at their first
    step).  Every prompt bucket (the prefill's rows) must be among the
    rows [kernels] held.  Returns the launches."""
    L = n_layers
    steps = sum(c[1] for c in calls)
    want = {"beam_attention": (steps - len(calls)) * L,
            "decode_attention": 0, "w8_bf16_gemm": 0,
            **{k: steps * n for k, n in a8_forward_launches(L).items()}}
    got = {k: counts.get(k, 0) for k in want}
    launched = ("w8a8_gemm", "row_quant_int8", "rms_norm_quant_int8",
                "silu_mul_quant_int8") + (
        ("beam_attention",) if beam_forwards else ())
    if got != want or not all(got[k] > 0 for k in launched):
        fail(f"[{label}] launches {got} for {len(calls)} calls of {steps} "
             f"beam steps in all; expected {want}")
    buckets = sorted({c[3] for c in calls})
    unheld = [m for m in buckets if m not in TABLE_M + SERVE_M + OFFLINE_M]
    if unheld:
        fail(f"[{label}] prefills of {unheld} rows, which [kernels] did not "
             "hold against the plain versions")
    print(f"[{label}] {len(calls)} calls, {steps} beam steps "
          f"({steps / len(calls):.1f} a call), prompt buckets {buckets} "
          f"(prefill rows held in [kernels]); launches {got} = steps x "
          f"({A8_TEXT} at n = {L}) and (steps - calls) x {L} "
          f"beam_attention", flush=True)
    return got


def run_offline_bench(extra, metric, label, beam_forwards=True):
    """``python -m infinisst_tpu_torch.bench`` + ``extra`` (an offline
    mode; ``run_main``): exit 0, its last stdout line the JSON line with
    ``metric``, each chunk's wall, beam steps and prompt bucket re-printed,
    and its launches those of the forwards its calls ran
    (``check_offline_launches``).  Returns (result, launches, chunks:
    bench.run_offline's records)."""
    out = run_main("infinisst_tpu_torch.bench", extra)
    chunks = []
    for line in out.stderr.splitlines():
        m = CHUNK_LINE.match(line)
        if m:
            chunks.append((float(m[2]),) + tuple(int(m[k]) for k in
                                                 range(3, 10)))
        if m or line.startswith(("chunks=", "kernel launches",
                                 "attention launches", "alignatt",
                                 "streamatt")):
            print(f"[{label}]   {line}", flush=True)
    if out.returncode != 0:
        for line in out.stderr.strip().splitlines()[-12:]:
            print(f"[{label}]   {line}", flush=True)
        fail(f"[{label}] bench {' '.join(extra)} exited {out.returncode}")
    lines = out.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"[{label}] its last stdout line is not JSON: {lines[-1:]}")
    missing = [k for k in OFFLINE_KEYS if k not in result]
    if result.get("metric") != metric or missing:
        fail(f"[{label}] metric {result.get('metric')!r} (expected "
             f"{metric!r}), missing keys {missing}")
    if not (math.isfinite(result["value"]) and result["value"] > 0):
        fail(f"[{label}] RTF {result['value']}")
    counts = _stderr_json(out.stderr, "kernel launches ")
    if counts is None or not chunks:
        fail(f"[{label}] the bench did not report its chunks and launches")
    got = check_offline_launches(label, counts, chunks,
                                 beam_forwards=beam_forwards)
    print(f"[{label}] {json.dumps(result)}", flush=True)
    return result, got, chunks


def offline_path(paths, mode, counts, chunks, keys):
    """Record the bench's offline mode as the path of the three kernels
    it launches, with the shapes to report: the modal prompt bucket's
    prefill and the beam_attention shape ``keys`` times."""
    bucket = statistics.mode(c[3] for c in chunks)
    shapes = {"w8a8_gemm": (bucket, REPORT_SHAPE[1], REPORT_SHAPE[2]),
              "row_quant_int8": (bucket, REPORT_SHAPE[1], 0),
              "rms_norm_quant_int8": (bucket, NORM_D, 0),
              "silu_mul_quant_int8": (bucket, SILU_D, 0),
              "beam_attention": keys}
    for name, shape in shapes.items():
        paths[f"{mode} {name}"] = (f"bench --mode {mode}", counts, shape)


def check_alignatt(dev, notes, paths):
    """The port bench's AlignAtt mode (12 chunks, 3 untimed), in parity
    and with --early-stop; beam_attention and the probe held at the
    shapes the parity calls ran (hold_offline_attention), timed at the
    one with the most beam forwards.  The early stop may end every call at
    its first step (the prefill's probe already in the stop zone), with no
    beam forward: its beam_attention launches may then be 0, and its
    RTF times one prefill a call."""
    for early in (False, True):
        extra = ["--mode", "alignatt"] + (["--early-stop"] if early else [])
        _, counts, chunks = run_offline_bench(
            extra, ALIGNATT_METRICS[early], "alignatt",
            beam_forwards=not early)
        if not early:
            keys = hold_offline_attention(dev, notes, "alignatt", chunks,
                                          timed=True)
            offline_path(paths, "alignatt", counts, chunks, keys)
        elif all(c[1] == 1 for c in chunks):
            print("[alignatt] --early-stop: every call stopped at its first "
                  "step (the prefill's probe already in the stop zone): no "
                  "beam forward, so its RTF times a prefill a call, a "
                  "degenerate reading on random weights (ROADMAP §3)",
                  flush=True)


def check_streamatt_bench(dev, notes, paths):
    """The port bench's StreamAtt mode (40 chunks, timed from 32;
    ``run_main``); beam_attention and the probe held at the shapes its
    calls ran, timed at the one with the most beam forwards."""
    _, counts, chunks = run_offline_bench(["--mode", "streamatt"],
                                          STREAMATT_METRIC, "streamatt bench")
    keys = hold_offline_attention(dev, notes, "streamatt", chunks,
                                  timed=True, where="streamatt bench")
    if keys is None:
        fail("[streamatt bench] no call ran a beam forward")
    offline_path(paths, "streamatt", counts, chunks, keys)


class StreamAttRule:
    """Called after each push of a StreamAtt agent (``run_offline``'s
    ``on_push``): the kept source must equal the rule's, the source before
    the cut (the kept source of the previous push and this push's audio)
    from min(the earliest attended sample of the kept target, its length
    less min_speech_duration) on, then its last max_speech_duration.
    Records the pushes cut at the attended sample itself (``at_frame``)
    and those clamped to min_speech_duration (``clamped``)."""

    def __init__(self, opts, label):
        import numpy as np

        self.min_s = int(opts.min_speech_duration * 16000)
        self.max_s = int(opts.max_speech_duration * 16000)
        self.label = label
        self.source = np.zeros(0, np.float32)
        self.at_frame, self.clamped, self.n = [], [], 0

    def __call__(self, agent, audio):
        import numpy as np

        st, i = agent.states, self.n
        before = np.concatenate([self.source, audio])
        src_idx = 0
        if st.target_ids and st.most_attended_indices:
            attended = int(min(st.most_attended_indices[
                -len(st.target_ids):]))
            clamp = max(0, len(before) - self.min_s)
            src_idx = min(attended, clamp)
            if src_idx > 0:
                (self.at_frame if attended <= clamp else
                 self.clamped).append(i)
        want = before[src_idx:][-self.max_s:]
        got = np.asarray(st.source, np.float32)
        if not np.array_equal(got, want):
            fail(f"{self.label} push {i}: {len(got)} source samples kept; "
                 f"the rule keeps {len(want)} (cut at {src_idx} of "
                 f"{len(before)}, then the last {self.max_s})")
        self.source, self.n = got, i + 1


def check_streamatt(dev, cfg, params):
    """The bench's StreamAtt agent (``bench.offline_agent``: Chinese
    target, 10-unit audio buckets, the early stop) on the flagship
    weights, driven directly for STREAMATT_CHUNKS chunks through the
    bench's ``run_offline`` and ``summarize_offline`` (its own metric
    name: the bench times chunks 32-39, [streamatt bench]): each chunk's
    wall, beam steps, prompt bucket and kept source; the launches per
    call; after every push, the kept source equal to the rule's: the
    source before the cut, from min(the earliest attended sample of the
    kept target, its length less min_speech_duration) on, then its last
    max_speech_duration; a cut by that rule at least once; beam_attention
    and the probe held at the shapes the calls ran."""
    import numpy as np
    import torch

    from infinisst_tpu_torch import bench

    agent = bench.offline_agent("streamatt", True, cfg, params, dev)
    rule = StreamAttRule(agent.opts, "[streamatt]")
    reset_counts()
    run = bench.run_offline(agent, STREAMATT_CHUNKS, STREAMATT_TIMED_FROM,
                            on_push=rule)
    counts = launch_counts()
    calls = run["calls"]
    for i, c in enumerate(calls):
        print(f"[streamatt]   chunk {i}: {c[0]:.3f}s steps={c[1]} "
              f"max_steps={c[2]} prompt_bucket={c[3]} tgt={c[4]} "
              f"source={c[5]} prompt_len={c[6]} units={c[7]}", flush=True)
    check_offline_launches("streamatt", counts, calls)
    result = dict(bench.summarize_offline(run["times"],
                                          STREAMATT_DIRECT_METRIC),
                  chunks=len(calls), timed_from=STREAMATT_TIMED_FROM)
    print(f"[streamatt] {json.dumps(result)} (the bench's agent driven "
          f"directly: {len(calls)} chunks timed from "
          f"{STREAMATT_TIMED_FROM}; not the bench's metric, which times "
          "chunks 32-39)", flush=True)
    print(f"[streamatt] source samples after each call: "
          f"{[c[5] for c in calls]}, each equal to the rule's; cut by the "
          f"attended-frame rule at calls {rule.at_frame} (at the earliest "
          f"attended sample) and {rule.clamped} (clamped to "
          f"min_speech_duration)", flush=True)
    if not (rule.at_frame or rule.clamped):
        fail("[streamatt] the source was never cut by the attended-frame "
             "rule")
    del agent
    torch.cuda.empty_cache()
    hold_offline_attention(dev, None, "streamatt", calls, timed=False)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(d):
    """Start ``check_server``'s server in the background (its process
    spends its first ~10 s importing torch; it idles once up): returns
    (process, port, log path)."""
    port = _free_port()
    log_path = os.path.join(d, "server.log")
    with open(log_path, "w") as log:
        server = subprocess.Popen(
            [sys.executable, "-m", "infinisst_tpu_torch.serve.server",
             "--model-preset", "dryrun", "--port", str(port),
             "--pool-size", "2", "--multipliers", "1,2"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return server, port, log_path


def check_server(d, talks, started):
    """The port's server at the dryrun preset (pool 2, beam 4,
    multipliers 1 and 2) on the card (``started``: ``start_server``'s,
    started before [cli ckpt]) and two ``serve.client`` processes,
    at m=1 and m=2, streaming the CLI's two talks over localhost: both
    print their FINAL line and exit 0; the server is stopped after."""
    import socket

    server, port, log_path = started
    with open(talks[0]) as f:
        wavs = f.read().split()
    clients = []
    try:
        deadline = time.perf_counter() + 300
        while True:  # the server is up once it accepts a connection
            if server.poll() is not None:
                fail(f"[server] the server exited {server.returncode}")
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                if time.perf_counter() > deadline:
                    fail("[server] the server did not start in 300 s")
                time.sleep(0.5)
        t0 = time.perf_counter()
        clients = [subprocess.Popen(
            [sys.executable, "-m", "infinisst_tpu_torch.serve.client",
             "--port", str(port), "--wav", wav, "--multiplier", str(m)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for wav, m in zip(wavs, (1, 2))]
        outs = [c.communicate(timeout=300)[0] for c in clients]
        wall = time.perf_counter() - t0
    finally:
        for proc in clients + [server]:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        with open(log_path) as f:
            for line in f.read().strip().splitlines()[-6:]:
                print(f"[server]   server: {line}", flush=True)
    for i, (c, text) in enumerate(zip(clients, outs)):
        final = [ln for ln in text.splitlines() if ln.startswith("FINAL:")]
        print(f"[server] client {i} (m={i + 1}): exit {c.returncode}, "
              f"{len(text.splitlines()) - 1} text messages, "
              f"{final[-1][:100] if final else 'no FINAL line'!r}",
              flush=True)
        if c.returncode != 0 or not final:
            fail(f"[server] client {i} did not finish its stream")
    print(f"[server] both streams finished in {wall:.1f} s", flush=True)


def write_talks(d):
    """Two seeded 16 kHz wav files (CLI_TALKS) and their source / target
    lists in ``d``; returns the source and target paths."""
    import numpy as np

    from infinisst_tpu_torch.data.audio import write_wav

    rng = np.random.RandomState(6)
    paths = []
    for i, (sec, _) in enumerate(CLI_TALKS):
        n = int(sec * 16000)
        wav = (np.sin(np.linspace(0, 700 + 100 * i, n)) * 0.3
               + rng.randn(n) * 0.05).astype(np.float32)
        paths.append(os.path.join(d, f"talk{i}.wav"))
        write_wav(paths[-1], wav)
    src, tgt = os.path.join(d, "talks.source"), os.path.join(d, "talks.target")
    with open(src, "w") as f:
        f.write("\n".join(paths) + "\n")
    with open(tgt, "w") as f:
        f.write("\n".join(ref for _, ref in CLI_TALKS) + "\n")
    return src, tgt


def reference_bin_state(cfg, seed):
    """A pruned stage-2 ``pytorch_model.bin`` state dict (the layout of
    ``tests/test_convert.py:610``) for ``cfg``, as torch tensors: the
    fairseq wav2vec2 body under ``model.speech_encoder.speech_encoder.``,
    the adapter under ``model.speech_encoder.``, the Llama under HF
    names."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.convert.from_torch import export_llama
    from infinisst_tpu_torch.models import llama as L

    rng = np.random.RandomState(seed)
    sd = {}

    def put(key, shape, scale=None, fill=None):
        sd[key] = (np.full(shape, fill, np.float32) if fill is not None
                   else (rng.randn(*shape) * scale).astype(np.float32))

    w = "model.speech_encoder.speech_encoder."
    in_d = 1
    for i, lc in enumerate(cfg.w2v2.conv_layers):
        base = f"{w}feature_extractor.conv_layers.{i}"
        put(f"{base}.0.weight", (lc.dim, in_d, lc.kernel), 0.3)
        sd[f"{base}.2.1.weight"] = rng.rand(lc.dim).astype(np.float32)
        put(f"{base}.2.1.bias", (lc.dim,), 0.1)
        in_d = lc.dim
    D, F = cfg.w2v2.encoder_embed_dim, cfg.w2v2.encoder_ffn_embed_dim
    put(f"{w}layer_norm.weight", (in_d,), fill=1.0)
    put(f"{w}layer_norm.bias", (in_d,), fill=0.0)
    put(f"{w}post_extract_proj.weight", (D, in_d), 0.1)
    put(f"{w}post_extract_proj.bias", (D,), fill=0.0)
    for li in range(cfg.w2v2.encoder_layers):
        e = f"{w}encoder.layers.{li}"
        for nm in ("self_attn_layer_norm", "final_layer_norm"):
            put(f"{e}.{nm}.weight", (D,), fill=1.0)
            put(f"{e}.{nm}.bias", (D,), fill=0.0)
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{e}.self_attn.{nm}.weight", (D, D), 0.1)
            put(f"{e}.self_attn.{nm}.bias", (D,), fill=0.0)
        put(f"{e}.fc1.weight", (F, D), 0.1)
        put(f"{e}.fc1.bias", (F,), fill=0.0)
        put(f"{e}.fc2.weight", (D, F), 0.1)
        put(f"{e}.fc2.bias", (D,), fill=0.0)
    put(f"{w}encoder.layer_norm.weight", (D,), fill=1.0)
    put(f"{w}encoder.layer_norm.bias", (D,), fill=0.0)
    in_d = cfg.adapter.in_dim
    for i, lc in enumerate(cfg.adapter.conv_layers):
        base = f"model.speech_encoder.length_shrink.conv_layers.{i}"
        put(f"{base}.0.weight", (lc.dim, in_d, lc.kernel), 0.3)
        sd[f"{base}.2.1.weight"] = rng.rand(lc.dim).astype(np.float32)
        put(f"{base}.2.1.bias", (lc.dim,), fill=0.0)
        in_d = lc.dim
    put("model.speech_encoder.proj.weight", (cfg.adapter.out_dim, in_d), 0.2)
    put("model.speech_encoder.proj.bias", (cfg.adapter.out_dim,), fill=0.0)
    llama = L.init_params(cfg.llama, torch.Generator().manual_seed(seed),
                          "cpu")
    sd.update(export_llama(llama, cfg.llama))
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _instances(out_dir):
    with open(os.path.join(out_dir, "instances.log")) as f:
        return [json.loads(line) for line in f]


def check_cli_ckpt(d, talks):
    """``agents.cli.main`` at the dryrun preset from a synthetic reference
    .bin (loaded through convert/from_torch.py), float32, on the card and
    on the CPU (TF32 off, as set in main): equal predictions and
    delays."""
    import torch

    from infinisst_tpu_torch.agents import cli
    from infinisst_tpu_torch.core.presets import dryrun_config

    ckpt = os.path.join(d, "pytorch_model.bin")
    torch.save(reference_bin_state(dryrun_config(), seed=42), ckpt)
    logs = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(d, f"ckpt_{device}")
        reset_counts()
        t0 = time.perf_counter()
        scores = cli.main([
            "--source", talks[0], "--target", talks[1], "--output", out,
            "--model-preset", "dryrun", "--state-dict-path", ckpt,
            "--dtype", "float32", "--device", device,
        ])
        counts = launch_counts()
        logs[device] = _instances(out)
        print(f"[cli ckpt] {device}: {time.perf_counter() - t0:.1f} s, "
              f"scores {json.dumps(scores)}, launches {counts}", flush=True)
        if device == "cuda" and counts["beam_attention"] <= 0:
            fail("[cli ckpt] the beam step did not launch beam_attention")
    for g, c in zip(logs["cuda"], logs["cpu"]):
        print(f"[cli ckpt] talk {g['index']}: cuda {g['prediction'][:96]!r}"
              f" ({len(g['delays'])} writes)", flush=True)
        print(f"[cli ckpt]         cpu  {c['prediction'][:96]!r}", flush=True)
        if (g["prediction"], g["delays"]) != (c["prediction"], c["delays"]):
            fail(f"[cli ckpt] talk {g['index']}: the card's predictions or "
                 "delays differ from the CPU's")
    if len(logs["cuda"]) != len(CLI_TALKS) or not all(
            r["prediction"] for r in logs["cuda"]):
        fail("[cli ckpt] a talk has no prediction")
    # the StreamAtt baseline over the same checkpoint and talks
    out = os.path.join(d, "ckpt_streamatt")
    reset_counts()
    t0 = time.perf_counter()
    scores = cli.main([
        "--source", talks[0], "--target", talks[1], "--output", out,
        "--model-preset", "dryrun", "--state-dict-path", ckpt,
        "--dtype", "float32", "--agent", "streamatt",
    ])
    counts = launch_counts()
    recs = _instances(out)
    print(f"[cli ckpt] --agent streamatt on the card: "
          f"{time.perf_counter() - t0:.1f} s, scores {json.dumps(scores)}, "
          f"launches {counts}", flush=True)
    for r in recs:
        print(f"[cli ckpt] streamatt talk {r['index']}: "
              f"{r['prediction'][:96]!r} ({len(r['delays'])} writes)",
              flush=True)
    if len(recs) != len(CLI_TALKS) or not any(r["prediction"] for r in recs):
        fail("[cli ckpt] --agent streamatt left an empty instances file")
    if counts["beam_attention"] <= 0:
        fail("[cli ckpt] the StreamAtt beam step did not launch "
             "beam_attention")


def check_cli_flagship(d, talks):
    """``agents.cli.main`` at the flagship preset, m=2, no checkpoint
    (random bf16 weights drawn on the card), the stub tokenizer: both
    talks finish with a finite RTF and StreamLAAL."""
    from infinisst_tpu_torch.agents import cli

    out = os.path.join(d, "flagship")
    reset_counts()
    t0 = time.perf_counter()
    scores = cli.main([
        "--source", talks[0], "--target", talks[1], "--output", out,
        "--model-preset", "flagship", "--latency-multiplier", "2",
    ])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    logs = _instances(out)
    print(f"[cli flagship] {wall:.1f} s (random bf16 init included); scores "
          f"{json.dumps(scores)}; launches {counts}", flush=True)
    for rec in logs:
        print(f"[cli flagship] talk {rec['index']}: "
              f"{rec['source_length'] / 1000:.2f} s of audio, RTF "
              f"{rec['rtf']:.4f}, {len(rec['delays'])} writes", flush=True)
    if len(logs) != len(CLI_TALKS) or scores["n_instances"] != len(CLI_TALKS):
        fail(f"[cli flagship] {len(logs)} talks finished")
    for key in ("rtf", "stream_laal"):
        if not math.isfinite(scores[key]):
            fail(f"[cli flagship] {key} is {scores[key]}")
    if counts["beam_attention"] <= 0:
        fail("[cli flagship] the beam step did not launch beam_attention")


# ---------------------------------------------------------------------------
# the training path: plain torch (JAX's training forward calls no Pallas
# kernel), so every kernel's launches there must be 0

TRAIN_LR = 1e-3
TRAIN_TINY_CASES = (  # label, freeze, grad_acc_steps, cpo_beta, schedule
    ("stage 1", "stage1", 1, 0.0, "cosine"),
    ("stage 2, grad_acc_steps 2", "stage2", 2, 0.0, "constant"),
    ("stage 0, cpo_beta 0.5", "stage0", 1, 0.5, "cosine"),
)
# new pinned host allocations another thread makes inside each open
# capture of ``check_capture_beside_loader``
PIN_DURING_CAPTURE = 64
TRAIN_METRIC = "train_stage1_speech_s_per_s_1chip_1.5b"
TRAIN_IO_METRIC = "train_stage1_speech_s_per_s_realio_1chip_1.5b"
TRAIN_KEYS = ("metric", "value", "unit", "vs_baseline")
TRAIN_IO_KEYS = TRAIN_KEYS + ("pipeline", "steps_pipelined",
                              "sec_per_step_pipelined",
                              "sec_per_step_synced", "speech_s_per_s_synced",
                              "final_loss")


def _freeze(name):
    from infinisst_tpu_torch.train import step as tstep

    return {"stage0": tstep.FreezeConfig(),
            "stage1": tstep.FreezeConfig.stage1(),
            "stage2": tstep.FreezeConfig.stage2()}[name]


def train_tiny_batches(cfg, n=4):
    """``n`` padded trajectory-4 batches (m = 1) of three rows of seeded
    noise, 1920, 940 and 920 ms (ragged patches and frame lengths),
    padded to four rows: host numpy dicts."""
    import numpy as np

    from infinisst_tpu_torch.data.collators import COLLATORS
    from infinisst_tpu_torch.data.dataset import SpeechToTextItem
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.train.trainer import pad_to_buckets

    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10,
                                          hi=900), cfg.tokens)
    coll = COLLATORS[4](builder, cfg, block_size=48, max_multiplier=1,
                        seed=0)
    rng = np.random.RandomState(11)
    out = []
    for b in range(n):
        items = []
        for i, units in enumerate((2, 1, 1)):
            traj = [f"b{b} r{i} w{j}" for j in range(units)]
            src = rng.randn(15360 * units - 320 * i) * 0.1
            items.append(SpeechToTextItem(
                id=f"{b}-{i}", index=i, source=src.astype(np.float32),
                target=" ".join(traj), src_text="", trajectory=traj))
        raw = coll(items)
        out.append(pad_to_buckets(raw, raw["multiplier"], cfg.tokens.pad))
    return out


def _train_run(d, cfg, base, host, freeze_name, acc, cpo, sched):
    """4 steps of make_train_step on device ``d`` from a copy of ``base``:
    per-step (loss, grad norm), the leaves before and after."""
    import torch

    from infinisst_tpu_torch.train import step as tstep
    from infinisst_tpu_torch.train.trainer import BATCH_KEYS

    params = tstep.tree_map(lambda t: t.clone().to(d), base)
    before = [p.clone() for p in tstep.tree_leaves(params)]
    freeze = _freeze(freeze_name)
    tx = tstep.make_optimizer(tstep.OptimConfig(
        learning_rate=TRAIN_LR, warmup_steps=2, total_steps=6,
        scheduler=sched), params, freeze)
    if acc > 1:
        tx = tstep.MultiSteps(tx, acc)
    state = tstep.init_train_state(params, tx)
    step = tstep.make_train_step(cfg, tx, 48, 96, cpo_beta=cpo,
                                 freeze=freeze, remat=True)
    metrics = []
    for b in host:
        batch = tstep.Batch(**{k: torch.from_numpy(b[k]).to(d)
                               for k in BATCH_KEYS})
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, before, tstep.tree_leaves(state.params)


def check_train_tiny(dev):
    """The dryrun preset in float32 (TF32 off): stage 1, stage 2 with
    grad_acc_steps 2 and stage 0 with cpo_beta 0.5, 4 steps each on the
    same batches on the card and on the CPU: per-step loss and grad norm
    within TINY_RTOL relative, the parameters after the last step within
    the CPU test's tolerance (10 x lr x 1e-2, and all but 1e-3 of the
    entries within lr x 1e-2), frozen leaves bitwise unchanged on the
    card, no kernel launched."""
    import torch

    from infinisst_tpu_torch.core.presets import dryrun_config
    from infinisst_tpu_torch.train import step as tstep
    from infinisst_tpu_torch.train.main import random_params

    cfg = dryrun_config()
    host = train_tiny_batches(cfg)
    base = random_params(cfg, "cpu", torch.float32)
    reset_counts()
    for label, fz, acc, cpo, sched in TRAIN_TINY_CASES:
        t0 = time.perf_counter()
        cpu = _train_run("cpu", cfg, base, host, fz, acc, cpo, sched)
        t1 = time.perf_counter()
        card = _train_run(dev, cfg, base, host, fz, acc, cpo, sched)
        t2 = time.perf_counter()
        for i, ((lc, gc), (lg, gg)) in enumerate(zip(cpu[0], card[0])):
            for what, a, b in (("loss", lc, lg), ("grad_norm", gc, gg)):
                if not (math.isfinite(b) and
                        abs(b - a) <= TINY_RTOL * abs(a)):
                    fail(f"[train tiny] {label} step {i} {what}: card {b} "
                         f"cpu {a}")
        mask = tstep.tree_leaves(tstep.trainable_mask(base, _freeze(fz)))
        worst, n_far, n_all = 0.0, 0, 0
        for m, b0, pc, pg in zip(mask, card[1], cpu[2], card[2]):
            if not m:
                if not torch.equal(pg, b0):
                    fail(f"[train tiny] {label}: a frozen leaf moved")
                continue
            d = (pg.cpu() - pc).abs()
            worst = max(worst, float(d.max()))
            n_far += int((d > TRAIN_LR * 1e-2).sum())
            n_all += d.numel()
        if worst > 10 * TRAIN_LR * 1e-2 or n_far > 1e-3 * n_all:
            fail(f"[train tiny] {label}: parameters after step 4 differ by "
                 f"up to {worst:.3e}, {n_far} of {n_all} entries past "
                 f"lr x 1e-2")
        print(f"[train tiny] {label}: losses card "
              f"{[round(x[0], 6) for x in card[0]]} grad norms "
              f"{[float(f'{x[1]:.6g}') for x in card[0]]}; parameters "
              f"within {worst:.3e} of the CPU's ({n_far} of {n_all} "
              f"entries past lr x 1e-2); frozen leaves bitwise; cpu "
              f"{t1 - t0:.1f} s, card {t2 - t1:.1f} s", flush=True)
    counts = launch_counts()
    if any(counts.values()):
        fail(f"[train tiny] kernels launched on the training path: {counts}")


# the training step's forward stages (the backward pass, with the layers'
# replay under remat, and the optimizer are the rest of the step)
TRAIN_STAGES = (
    ("infinisst_tpu_torch.models.speech_llm", "offline_spliced_embeddings"),
    ("infinisst_tpu_torch.models.llama", "offline_forward"),
)


def _tree_bytes(tree) -> int:
    import torch

    from infinisst_tpu_torch.train.step import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


# [train flagship]'s Llama layers: the LLM is frozen at stage 1, so its
# depth sets the frozen forward's cost and the checkpoint's bytes (18 GB
# at 32 layers, written twice), nothing the stage trains
TRAIN_FLAGSHIP_LAYERS = 8


def _flagship_trainer(dev, d, max_steps, stage=1, run="run", n_layers=None,
                      graphs_on=True):
    """A Trainer on the flagship preset (random bfloat16 weights, as
    bench.py's bench_train builds them; the first ``n_layers`` Llama
    layers if given), ``stage`` (1 by default), remat,
    encoder dropout 0.1 (applied at stage 1 only), over the TSV in ``d``:
    collator 4 at m = 1, two 28.8 s rows a batch, log_step 1, save_step
    0, under ``d/run``.  Its steps and saves are timed (the step
    synchronised; its last host batch kept as ``last_batch``).  ``graphs_on=False`` runs its program uncaptured (the
    private hook, set before the program is made)."""
    import torch

    from infinisst_tpu_torch.core.presets import flagship_config
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.train.main import random_params
    from infinisst_tpu_torch.train.trainer import Trainer, TrainerArgs

    cfg = flagship_config()
    if n_layers:
        cfg = cfg.replace(llama=cfg.llama.__class__(
            **{**cfg.llama.__dict__, "num_layers": n_layers}))
    args = TrainerArgs(
        data_path=d, data_split_train="tr", data_split_eval="none",
        trajectory=4, trajectory_max_multiplier=1, stage=stage,
        train_bsz=1900, bsz_sent=2, learning_rate=TRAIN_LR, warmup_steps=1,
        max_steps=max_steps, grad_acc_steps=1, log_step=1, eval_step=0,
        save_step=0, save_dir=os.path.join(d, run), remat=True,
        encoder_dropout=0.1)
    t = Trainer(args, cfg, PromptBuilder(StubTokenizer(cfg.llama.vocab_size),
                                         cfg.tokens),
                random_params(cfg, dev, torch.bfloat16), device=dev)
    t._graphs_on = graphs_on
    step_fn, save_fn = t._get_step_fn(1), t._save
    t.walls, t.save_walls = [], []

    def timed_step(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        t.walls.append(time.perf_counter() - t0)
        t.last_batch = batch
        return out

    def timed_save(step):
        t0 = time.perf_counter()
        save_fn(step)
        t.save_walls.append(time.perf_counter() - t0)

    t._step_fns[1], t._save = timed_step, timed_save
    return t


def check_train_flagship(dev, paths, d):
    """Trainer.fit on the flagship (Llama-3.1-8B + wav2vec2-large, the
    Llama cut to its first TRAIN_FLAGSHIP_LAYERS layers) in
    bfloat16, stage 1, 3 steps over synthetic TSV + wav rows of 28.8 s
    under build/: finite losses, every LLM leaf bitwise unchanged, the
    encoder and adapter moved, no kernel launched; the step walls, the
    peak memory, the final save's size and wall.  Then a second Trainer
    with max_steps=4 restores step 3 and takes one step.  The run
    directory is removed afterwards.  ``d`` holds the TSV and wav rows
    (``write_train_tsv(d, 6, 30, ...)``, shared with ``[train flagship
    stage 2]``)."""
    import gc

    import torch

    from infinisst_tpu_torch.train import checkpoint as ckpt
    from infinisst_tpu_torch.train.step import tree_leaves

    build = os.path.join(ROOT, "build")
    try:
        t = _flagship_trainer(dev, d, 3, n_layers=TRAIN_FLAGSHIP_LAYERS)
        state_bytes = _tree_bytes(t.state.params) + _tree_bytes(
            t.state.opt_state)
        free = shutil.disk_usage(build).free
        df = subprocess.run(["df", "-h", build], capture_output=True,
                            text=True).stdout.strip().splitlines()
        print(f"[train flagship] {TRAIN_FLAGSHIP_LAYERS} Llama layers: "
              f"state {state_bytes / 1e9:.2f} GB a "
              f"checkpoint (max_to_keep 2); free under build/ "
              f"{free / 1e9:.1f} GB: {df[-1] if df else '?'}", flush=True)
        if free < 2.2 * state_bytes:
            fail(f"[train flagship] build/ has {free / 1e9:.1f} GB free, "
                 f"two checkpoints need {2 * state_bytes / 1e9:.1f} GB")
        snap = {c: [p.clone() for p in tree_leaves(t.state.params[c])]
                for c in ("w2v2", "adapter", "llama")}
        snap_bytes = _tree_bytes(snap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        if t.fit() != 3:
            fail("[train flagship] fit did not stop at step 3")
        fit_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        counts = launch_counts()
        paths["train"] = ("[train flagship] Trainer.fit, flagship stage 1 "
                          f"bf16 at {TRAIN_FLAGSHIP_LAYERS} Llama layers, 3 "
                          "steps", counts)
        if any(counts.values()):
            fail(f"[train flagship] kernels launched: {counts}")
        with open(os.path.join(d, "run", "metrics.jsonl")) as f:
            logs = [json.loads(x) for x in f.read().splitlines()]
        losses = [x["train_loss"] for x in logs if "train_loss" in x]
        if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
            fail(f"[train flagship] losses {losses}")
        for c, before in snap.items():
            same = [torch.equal(a, b) for a, b in
                    zip(tree_leaves(t.state.params[c]), before)]
            if c == "llama" and not all(same):
                fail("[train flagship] a frozen LLM leaf moved")
            if c != "llama" and all(same):
                fail(f"[train flagship] no {c} leaf moved")
        ck = os.path.join(d, "run", "ckpt", "3", "state.pt")
        size = os.path.getsize(ck)
        norms = [float("%.4g" % x["grad_norm"]) for x in logs]
        print(f"[train flagship] losses {[round(x, 4) for x in losses]}; "
              f"grad norms {norms}; "
              f"step walls {[round(x, 3) for x in t.walls]} s (the first "
              f"includes warm-up); fit {fit_wall:.1f} s; peak "
              f"{peak / 2**30:.2f} GiB (max_memory_allocated), of which "
              f"{snap_bytes / 2**30:.2f} GiB this check's copy of the "
              f"weights: {(peak - snap_bytes) / 2**30:.2f} GiB for the "
              f"training; final save "
              f"{size / 1e9:.2f} GB in {t.save_walls[-1]:.1f} s; every LLM "
              f"leaf bitwise unchanged, w2v2 and adapter moved; launches "
              f"{counts}", flush=True)
        # one more step under the profiler (after the checks: it moves the
        # state on); forward stages by range, the rest is the backward
        # pass (with the layers' replay) and the optimizer
        ds, sampler, coll = t._make_loader("tr", 1900, shuffle=False)
        batch = t._to_batch(coll([ds[i] for i in next(iter(sampler))]), 1)
        step_fn = t._get_step_fn(1)
        profile_run(dev, lambda: step_fn(t.state, batch), TRAIN_STAGES,
                    "train profile", statistics.median(t.walls[1:]) * 1e3,
                    "step")
        # step_fn (the timed step) refers to t: drop both, and collect
        # their reference cycle, before the next Trainer's weights
        del t, snap, step_fn, batch
        gc.collect()
        torch.cuda.empty_cache()

        t2 = _flagship_trainer(dev, d, 4, n_layers=TRAIN_FLAGSHIP_LAYERS)
        t0 = time.perf_counter()
        final = t2.fit()
        wall = time.perf_counter() - t0
        if final != 4 or len(t2.walls) != 1 or t2.state.step != 4:
            fail(f"[train flagship] the resumed fit ended at {final} after "
                 f"{len(t2.walls)} steps")
        if ckpt.latest_step(os.path.join(d, "run", "ckpt")) != 4:
            fail("[train flagship] the resumed fit saved no step 4")
        print(f"[train flagship] resumed from step 3, one step "
              f"{t2.walls[0]:.3f} s, save {t2.save_walls[-1]:.1f} s, fit "
              f"(restore + step + save) {wall:.1f} s", flush=True)
        del t2
    finally:
        shutil.rmtree(os.path.join(d, "run"), ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def check_train_flagship_stage2(dev, d):
    """Trainer.fit on the flagship in bfloat16 at stage 2 (the adapter and
    the whole 8B LLM trained, the encoder frozen), remat, 3 steps over
    the TSV rows of 28.8 s in ``d`` (``[train flagship]``'s): finite
    losses, every w2v2 leaf bitwise unchanged, the adapter and the LLM
    moved (read at each leaf's first 4096 entries: some adapter leaf,
    and every LLM matrix but the embedding, whose rows outside the batch
    get no gradient), no kernel launched; the step walls, the peak
    memory, and the bytes of the parameters, the gradients (one a
    trainable leaf) and the moments (mu, nu), counted from the leaves.
    Then one step at a second key (the next text bucket), whose warm-up
    and capture share the graphs' pool with the first key's graph: a
    finite loss and norm, and its peak.  Nothing is saved, and the run
    directory is removed afterwards."""
    import gc

    import torch

    from infinisst_tpu_torch.core import graphs
    from infinisst_tpu_torch.data.template import IGNORE_INDEX
    from infinisst_tpu_torch.train import step as tstep

    run = os.path.join(d, "run2")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    try:
        t = _flagship_trainer(dev, d, 3, stage=2, run="run2")
        # no checkpoint (~50 GB at stage 2): [train flagship] holds saving
        # and resuming
        t._save = lambda step: None
        params = t.state.params
        mask = tstep.tree_leaves(tstep.trainable_mask(params, t.freeze))
        leaves = tstep.tree_leaves(params)
        p_bytes = _tree_bytes(params)
        g_bytes = sum(p.numel() * p.element_size()
                      for p, m in zip(leaves, mask) if m)
        opt = t.state.opt_state
        m_bytes = _tree_bytes(opt["mu"]) + _tree_bytes(opt["nu"])
        # the check's own copies: the encoder whole, 4096 entries of each
        # adapter and LLM leaf
        enc = [p.clone() for p in tstep.tree_leaves(params["w2v2"])]
        sample = {c: [p.reshape(-1)[:4096].clone()
                      for p in tstep.tree_leaves(params[c])]
                  for c in ("adapter", "llama")}
        copy_bytes = _tree_bytes(enc) + _tree_bytes(sample)
        gib = 2**30
        print(f"[train flagship stage 2] parameters {p_bytes / gib:.2f} "
              f"GiB, gradients {g_bytes / gib:.2f} GiB, moments "
              f"{m_bytes / gib:.2f} GiB (from the leaves; "
              f"{sum(mask)} of {len(mask)} leaves trained); two rows of "
              f"28.8 s a batch; {before / gib:.2f} GiB allocated before "
              f"the Trainer", flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        if t.fit() != 3:
            fail("[train flagship stage 2] fit did not stop at step 3")
        fit_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        counts = launch_counts()
        if any(counts.values()):
            fail(f"[train flagship stage 2] kernels launched: {counts}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logs = [json.loads(x) for x in f.read().splitlines()]
        losses = [x["train_loss"] for x in logs if "train_loss" in x]
        if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
            fail(f"[train flagship stage 2] losses {losses}")
        params = t.state.params
        if not all(torch.equal(a, b) for a, b in
                   zip(tstep.tree_leaves(params["w2v2"]), enc)):
            fail("[train flagship stage 2] a frozen w2v2 leaf moved")
        # an update of about lr (1e-3) rounds away in bfloat16 on an entry
        # near 1 (the norm scales, spacing 2^-7): the matrices must move
        still = []
        for c, before in sample.items():
            names = tstep.tree_leaves(_leaf_names(params[c]))
            moved = [not torch.equal(p.reshape(-1)[:4096], b) for p, b in
                     zip(tstep.tree_leaves(params[c]), before)]
            still += [f"{c}/{n}" for n, m in zip(names, moved) if not m]
            if not any(moved):
                fail(f"[train flagship stage 2] no {c} leaf moved")
        if any(n.startswith("llama/layers/w") or n == "llama/lm_head"
               for n in still):
            fail(f"[train flagship stage 2] LLM matrices did not move: "
                 f"{still}")
        norms = [float("%.4g" % x["grad_norm"]) for x in logs]
        print(f"[train flagship stage 2] losses "
              f"{[round(x, 4) for x in losses]}; grad norms {norms}; step "
              f"walls {[round(x, 3) for x in t.walls]} s (the first "
              f"includes warm-up); fit {fit_wall:.1f} s; peak "
              f"{peak / gib:.2f} GiB (max_memory_allocated), of which "
              f"{copy_bytes / gib:.2f} GiB this check's copies: "
              f"{(peak - copy_bytes) / gib:.2f} GiB for the training; "
              f"every w2v2 leaf bitwise unchanged, the adapter and the LLM "
              f"moved (unmoved at their first 4096 entries: {still}); "
              f"launches {counts}", flush=True)
        # a second key: the last batch with 128 more text columns, fully
        # masked (the next padded bucket); its warm-up and capture run in
        # the graphs' pool, beside the first key's graph
        b = t.last_batch

        def wider(x, fill):
            return torch.cat([x, torch.full((x.shape[0], 128), fill,
                                            dtype=x.dtype)], 1).pin_memory()

        b2 = tstep.Batch(b.speech, b.frame_lengths,
                         wider(b.input_ids, t.cfg.tokens.pad),
                         wider(b.labels, IGNORE_INDEX),
                         wider(b.attention_mask, 0),
                         wider(b.patch_mask, False))
        torch.cuda.reset_peak_memory_stats(dev)
        t.state, met = t._step_fns[1](t.state, b2)
        loss2, norm2 = graphs.read(met["packed"])
        peak2 = torch.cuda.max_memory_allocated(dev)
        keys = t._program.keys.values()
        if len(keys) != 2 or not all(k.program.captured for k in keys):
            fail(f"[train flagship stage 2] the second key: "
                 f"{len(keys)} programs, captured "
                 f"{[k.program.captured for k in keys]}")
        if not (math.isfinite(loss2) and math.isfinite(norm2)):
            fail(f"[train flagship stage 2] the second key: loss {loss2}, "
                 f"norm {norm2}")
        print(f"[train flagship stage 2] a second key (text "
              f"{tuple(b2.input_ids.shape)}, the first's "
              f"{tuple(b.input_ids.shape)}): warm-up and capture inside "
              f"the graphs' pool, loss {loss2:.4f}, grad norm "
              f"{norm2:.4g}, step wall {t.walls[-1]:.3f} s; peak "
              f"{peak2 / gib:.2f} GiB (max_memory_allocated over that "
              f"step), of which {copy_bytes / gib:.2f} GiB this check's "
              f"copies: {(peak2 - copy_bytes) / gib:.2f} GiB for the "
              f"training", flush=True)
        del t, params, enc, sample, met
    finally:
        shutil.rmtree(run, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# [train graph]: the train step as a captured program (TrainProgram)
# against its uncaptured twin (``captured=False``, the trainer's
# ``_graphs_on = False``), from the same state, in lockstep; the host
# reads the packed [loss, norm] at every TRAIN_GRAPH_LOG-th step only
TRAIN_GRAPH_LOG = 2
TRAIN_GRAPH_STEPS = 5  # the flagship's: warm-up + capture, then replays


def _train_graph_step(label, i, cap, unc, batch, m=1):
    """Step i of the captured program ``cap`` = (prog, state) under
    ``graphs.strict_syncs`` (reading its packed pair at a log step only),
    then of the uncaptured ``unc``; both stepped.  Returns the new pairs,
    the captured step's wall (host, to its return) and its host reads."""
    from infinisst_tpu_torch.core import graphs

    (cp, cs), (up, us) = cap, unc
    reads = graphs.host_reads
    with graphs.strict_syncs():
        t0 = time.perf_counter()
        cs, cm = cp(cs, batch, m)
        wall = time.perf_counter() - t0
        if (i + 1) % TRAIN_GRAPH_LOG == 0:
            graphs.read(cm["packed"])
    reads = graphs.host_reads - reads
    want = 1 if (i + 1) % TRAIN_GRAPH_LOG == 0 else 0
    if reads != want:
        fail(f"[train graph] {label} step {i}: {reads} host reads, "
             f"{want} expected")
    us, um = up(us, batch, m)
    return (cp, cs), (up, us), cm, um, wall, reads


def _states_equal(label, i, cap, unc, cm, um):
    """Captured and uncaptured bitwise: the packed [loss, norm], every
    parameter and every optimizer tensor."""
    import torch

    from infinisst_tpu_torch.train import step as tstep

    cs, us = cap[1], unc[1]
    if not torch.equal(cm["packed"], um["packed"]):
        fail(f"[train graph] {label} step {i}: loss and norm "
             f"{cm['packed'].tolist()} captured, {um['packed'].tolist()} "
             "uncaptured")
    for name, a, b in (("params", cs.params, us.params),
                       ("moments", cs.opt_state, us.opt_state)):
        la = [x for x in tstep.tree_leaves(a) if isinstance(x, torch.Tensor)]
        lb = [x for x in tstep.tree_leaves(b) if isinstance(x, torch.Tensor)]
        bad = [j for j, (x, y) in enumerate(zip(la, lb))
               if not torch.equal(x, y)]
        if len(la) != len(lb) or bad:
            fail(f"[train graph] {label} step {i}: {name} differ at leaves "
                 f"{bad[:8]} of {len(la)}")


# the profiler can miss the first kernels of a window: on the card the
# flagship step's first kernels, the optimizer's three scalar fills, went
# missing from some windows; ``_device_ops`` opens a window with this many
# spin kernels (left out of its counts) and a synchronise
PROFILE_SENTINELS = 32


def _device_ops(dev, step) -> tuple:
    """``step()`` under torch.profiler (the device's activity only): its
    kernels counted by name, then its device-to-device copies and its
    memsets, counted alike whether they ran as copies (eagerly) or as the
    driver's copy and memset kernels of a graph's nodes ("memcpy...",
    "memset..."); the host's uploads and reads are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(PROFILE_SENTINELS):
            torch.cuda._sleep(100)
        _sync(dev)
        step()
        _sync(dev)
        time.sleep(PROFILE_MARGIN_S)
    return _count_ops((e.key, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)


def _count_ops(pairs) -> tuple:
    """(kernels by name, device copies, memsets) of (name, count) pairs of
    device activities, the sentinels and the host's uploads and reads
    left out (``_device_ops``)."""
    names, copies, sets = {}, 0, 0
    for k, n in pairs:
        if "spin_kernel" in k:  # the sentinels
            continue
        if k.startswith("memcpy") or (k.startswith("Memcpy") and "DtoD" in k):
            copies += n
        elif k.startswith(("memset", "Memset")):
            sets += n
        elif not k.startswith("Memcpy"):
            names[k] = names.get(k, 0) + n
    return names, copies, sets


def _device_ops_last(dev, step) -> tuple:
    """``_device_ops`` of the second of two calls of ``step()`` in one
    profiler window, a spin kernel and a synchronise between them: the
    device activities that start after that spin kernel, and their
    device milliseconds by name.  The first call stands where a window
    loses its first activities: in a whole-script run on the H100 the
    window of a replayed 0.3 ms distill step lost its first 16, after the
    sentinels, and ``profile_run``'s window of a flagship distill step
    its first GEMM."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(PROFILE_SENTINELS):
            torch.cuda._sleep(100)
        _sync(dev)
        step()
        _sync(dev)
        torch.cuda._sleep(100)  # the separator
        _sync(dev)
        step()
        _sync(dev)
        time.sleep(PROFILE_MARGIN_S)
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if not spins:
        fail("the profiler saw no spin kernel in its window")
    last = events[spins[-1] + 1:]
    ms = {}
    for e in last:
        ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return (*_count_ops((e.name, 1) for e in last), ms)


def check_train_graph_tiny(dev):
    """[train tiny]'s three cases (stage 1, here with encoder dropout 0.1;
    stage 2 with grad_acc_steps 2; stage 0 with cpo_beta 0.5) on the
    dryrun preset in float32, 4 steps over [train tiny]'s batches, as
    ``TrainProgram`` captured on the card against the same program
    uncaptured, from the same parameters, deterministic algorithms on:
    loss, norm, every parameter and every moment bitwise after every
    step; the replays under ``graphs.strict_syncs`` with host reads only
    at the log steps; no kernel launched."""
    import torch

    from infinisst_tpu_torch.core.presets import dryrun_config
    from infinisst_tpu_torch.parallel.mesh_check import deterministic
    from infinisst_tpu_torch.train import step as tstep
    from infinisst_tpu_torch.train.main import random_params
    from infinisst_tpu_torch.train.trainer import BATCH_KEYS

    cfg = dryrun_config()
    host = [tstep.Batch(**{k: torch.from_numpy(b[k]).pin_memory()
                           for k in BATCH_KEYS})
            for b in train_tiny_batches(cfg)]
    base = random_params(cfg, "cpu", torch.float32)
    reset_counts()

    def make(fz, acc, cpo, sched, rate, captured):
        params = tstep.tree_map(lambda t: t.clone().to(dev), base)
        freeze = _freeze(fz)
        tx = tstep.make_optimizer(tstep.OptimConfig(
            learning_rate=TRAIN_LR, warmup_steps=2, total_steps=6,
            scheduler=sched), params, freeze)
        if acc > 1:
            tx = tstep.MultiSteps(tx, acc)
        prog = tstep.TrainProgram(cfg, tx, 48, 96, dev, cpo_beta=cpo,
                                  freeze=freeze, remat=True,
                                  encoder_dropout=rate, dropout_seed=7,
                                  captured=captured)
        return prog, tstep.init_train_state(params, tx)

    with deterministic():
        for label, fz, acc, cpo, sched in TRAIN_TINY_CASES:
            rate = 0.1 if fz == "stage1" else 0.0
            cap, unc = (make(fz, acc, cpo, sched, rate, c)
                        for c in (True, False))
            walls, losses = [], []
            for i, b in enumerate(host):
                cap, unc, cm, um, wall, _ = _train_graph_step(
                    label, i, cap, unc, b)
                _states_equal(label, i, cap, unc, cm, um)
                walls.append(wall)
                losses.append(cm["packed"].tolist())
            prog = cap[0]
            progs = [k.program for k in prog.keys.values()] + (
                [prog._apply] if prog._apply is not None else [])
            if not all(p.captured and p.replays for p in progs):
                fail(f"[train graph] {label}: a program did not replay: "
                     f"{[(p.captured, p.replays) for p in progs]}")
            print(f"[train graph] dryrun {label}"
                  f"{', dropout 0.1' if rate else ''}: captured = "
                  f"uncaptured bitwise every step (loss, norm, parameters, "
                  f"moments); [loss, norm] {losses}; programs "
                  f"{len(progs)}, replays {[p.replays for p in progs]}; "
                  f"captured step walls (host, to return) "
                  f"{[round(w * 1e3, 2) for w in walls]} ms", flush=True)
            del cap, unc, prog, progs
        check_capture_beside_loader(dev, host, make)
    counts = launch_counts()
    if any(counts.values()):
        fail(f"[train graph] kernels launched on the training path: "
             f"{counts}")


def check_capture_beside_loader(dev, host, make):
    """The stage 1 case's program captured and replayed while another
    thread pins new host memory, as ``Trainer``'s loader pins its next
    batches during a step: every capture, once open, waits until the
    other thread has made PIN_DURING_CAPTURE new pinned allocations.  A
    capture that held every thread to its rules would be voided."""
    import threading

    import torch

    stop, want, done = (threading.Event() for _ in range(3))
    made = [0, 0]  # pinned allocations, captures they ran inside
    errors = []

    def pin():
        keep = []  # never freed: every allocation is a new one
        while not stop.is_set():
            if want.wait(0.01):
                want.clear()
                try:
                    for _ in range(PIN_DURING_CAPTURE):
                        keep.append(torch.empty(1 << 14, pin_memory=True))
                except Exception as e:  # noqa: BLE001 -- reported below
                    errors.append(e)
                made[0] += PIN_DURING_CAPTURE
                made[1] += 1
                done.set()

    enter = torch.cuda.graph.__enter__

    def entered(self):
        enter(self)
        done.clear()
        want.set()
        if not done.wait(60):
            fail("[train graph] the pinning thread did not run")
        if errors:
            fail(f"[train graph] a pinned allocation in another thread "
                 f"during a capture: {str(errors[0]).splitlines()[0]}")

    _, fz, acc, cpo, sched = TRAIN_TINY_CASES[0]
    prog, state = make(fz, acc, cpo, sched, 0.1, True)
    t = threading.Thread(target=pin, daemon=True)
    t.start()
    torch.cuda.graph.__enter__ = entered
    try:
        for b in host[:3]:
            state, _ = prog(state, b)
        torch.cuda.synchronize(dev)
    finally:
        torch.cuda.graph.__enter__ = enter
        stop.set()
        t.join()
    progs = [k.program for k in prog.keys.values()]
    if not made[1] or not all(p.captured and p.replays for p in progs):
        fail(f"[train graph] beside a pinning thread: a program did not "
             f"capture or replay: {[(p.captured, p.replays) for p in progs]}"
             f", captures {made[1]}")
    print(f"[train graph] dryrun {TRAIN_TINY_CASES[0][0]}: captured and "
          f"replayed while another thread made {made[0]} pinned host "
          f"allocations inside {made[1]} open capture(s)", flush=True)


def check_train_graph_flagship(dev, d):
    """The flagship stage 1 (``_flagship_trainer``: bf16, remat, encoder
    dropout 0.1, the Llama at TRAIN_FLAGSHIP_LAYERS layers) in two
    Trainers on the same random weights, one captured and one with
    ``_graphs_on = False``, TRAIN_GRAPH_STEPS steps in lockstep over the
    TSV rows in ``d``, deterministic algorithms on: loss, norm, every
    parameter, mu and nu bitwise after every step, replays under
    ``graphs.strict_syncs`` with host reads only at the log steps.  Then
    one more step of each under the profiler: the device kernels of the
    replayed step, counted by name, equal the uncaptured step's; the
    host's dispatch (its time to return) of a replayed and of an
    uncaptured step, and the replay's idle share."""
    import gc

    import torch

    from infinisst_tpu_torch.parallel.mesh_check import deterministic

    label = f"flagship stage 1 at {TRAIN_FLAGSHIP_LAYERS} Llama layers"
    ts = [_flagship_trainer(dev, d, 0, n_layers=TRAIN_FLAGSHIP_LAYERS,
                            run=f"graph{i}", graphs_on=i == 0)
          for i in range(2)]
    try:
        if ts[1]._get_program().pool is not None:
            fail("[train graph] the uncaptured twin has a graph pool")
        ds, sampler, coll = ts[0]._make_loader("tr", 1900, shuffle=False)
        sampler.set_epoch(0)
        batches = [ts[0]._to_batch(coll([ds[j] for j in idx]), 1)
                   for idx in list(sampler)[:2]]
        # the programs themselves: the trainers' step functions are
        # _flagship_trainer's timed wrappers, which synchronise
        cap = (ts[0]._get_program(), ts[0].state)
        unc = (ts[1]._get_program(), ts[1].state)
        walls = []
        with deterministic():
            for i in range(TRAIN_GRAPH_STEPS):
                b = batches[i % len(batches)]
                cap, unc, cm, um, wall, _ = _train_graph_step(
                    label, i, cap, unc, b)
                torch.cuda.synchronize()
                _states_equal(label, i, cap, unc, cm, um)
                walls.append(wall)
            prog = ts[0]._program
            # one replayed step and one uncaptured step under the profiler
            b = batches[0]
            got = {}

            def replayed():
                got["cap"] = cap[0](cap[1], b)

            def uncaptured():
                got["unc"] = unc[0](unc[1], b)

            seen_cap, copies_cap, sets_cap = _device_ops(dev, replayed)
            seen_unc, copies_unc, sets_unc = _device_ops(dev, uncaptured)
            if (copies_cap, sets_cap) != (copies_unc, sets_unc):
                fail(f"[train graph] {label}: the replayed step ran "
                     f"{copies_cap} device copies and {sets_cap} memsets, "
                     f"the uncaptured step {copies_unc} and {sets_unc}")
            cap = (cap[0], got["cap"][0])
            unc = (unc[0], got["unc"][0])
            torch.cuda.synchronize()
            _states_equal(label, TRAIN_GRAPH_STEPS, cap, unc,
                          got["cap"][1], got["unc"][1])
            # a replay of a graph with a registered generator first fills
            # the generator's seed and offset tensors (two int64 fills,
            # CUDAGraph.replay's prologue); the uncaptured draws pass them
            # as kernel arguments
            n_gen = sum(len(k.program.generators.get("step", ()))
                        for k in prog.keys.values())
            prologue = {k: 2 * n_gen for k in seen_cap
                        if "FillFunctor<long>" in k}
            want = dict(seen_unc)
            for k, n in prologue.items():
                want[k] = want.get(k, 0) + n
            if seen_cap != want or len(prologue) != (n_gen > 0):
                diff = {k: (seen_cap.get(k, 0), seen_unc.get(k, 0))
                        for k in set(seen_cap) | set(seen_unc)
                        if seen_cap.get(k, 0) != seen_unc.get(k, 0)}
                fail(f"[train graph] {label}: the replayed step's kernels "
                     f"by name (captured, uncaptured) differ beyond the "
                     f"generator's replay prologue ({2 * n_gen} int64 "
                     f"fills): {diff}")
            # dispatch: the host's time to return, without a synchronise
            disp = {}
            for name, (fn, st) in (("captured", cap), ("uncaptured", unc)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = fn(st, b)
                disp[name] = time.perf_counter() - t0
                torch.cuda.synchronize()
                disp[name + " wall"] = time.perf_counter() - t0
                if name == "captured":
                    cap = (fn, st)
                else:
                    unc = (fn, st)
        med = statistics.median(walls[1:])
        print(f"[train graph] {label}: captured = uncaptured bitwise every "
              f"step of {TRAIN_GRAPH_STEPS} (loss, norm, parameters, mu, "
              f"nu), replays under strict syncs, host reads at the log "
              f"steps only; keys {sorted(prog.keys)}, replays "
              f"{[k.program.replays for k in prog.keys.values()]}; the "
              f"replayed step's device kernels equal the uncaptured "
              f"step's by name ({sum(seen_unc.values())} kernels, "
              f"{len(seen_unc)} names) and its {copies_unc} device "
              f"copies and {sets_unc} memsets, plus the generator's replay "
              f"prologue ({sum(prologue.values())} int64 fills); captured "
              f"step walls (host, to "
              f"return) {[round(w, 4) for w in walls]} s; dispatch of one "
              f"step: captured {disp['captured'] * 1e3:.2f} ms (wall "
              f"{disp['captured wall'] * 1e3:.2f} ms), uncaptured "
              f"{disp['uncaptured'] * 1e3:.2f} ms (wall "
              f"{disp['uncaptured wall'] * 1e3:.2f} ms); graph pool "
              f"{graph_pool_bytes(prog.pool) / 2**30:.2f} GiB", flush=True)
        profile_run(dev, lambda: cap[0](cap[1], b), TRAIN_STAGES,
                    "train graph profile", disp["captured wall"] * 1e3,
                    "replayed step")
    finally:
        del ts, cap, unc
        gc.collect()
        torch.cuda.empty_cache()


def _leaf_names(tree, prefix=""):
    """The tree with each leaf replaced by its key path, 'a/b'."""
    if isinstance(tree, dict):
        return {k: _leaf_names(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaf_names(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix[:-1]


def _agent_tokens(dev, cfg, params, n_chunks, mesh=None):
    """The flagship agent (m = 1, beam 4, the default stream) on
    ``n_chunks`` chunks of seeded noise, under ``tensor_parallel(mesh)``;
    its target ids after each chunk and the kernels' launches."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel

    rng = np.random.RandomState(12)
    out = []
    reset_counts()
    with tensor_parallel(mesh):
        agent = InfiniSSTAgent(
            params, cfg, StreamConfig(),
            PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens),
            InfiniSSTOptions(latency_multiplier=1, beam=4),
            param_dtype=torch.bfloat16, device=dev)
        for _ in range(n_chunks):
            agent.push(rng.randn(agent.chunk_samples).astype(np.float32)
                       * 0.1, finished=False)
            out.append(list(agent.states.target_ids))
    _sync(dev)
    return out, launch_counts()


def _pool_tokens(dev, cfg, params, n_ticks, mesh=None):
    """The flagship W8A8 pool of 8 slots at beam 4 (``[serve]``'s
    geometry), every slot streaming seeded noise, ``n_ticks`` ticks,
    built and ticked under ``tensor_parallel(mesh)`` (with a mesh: one
    pool split over its 'data' axis); each tick's slot tokens and the
    kernels' launches."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel
    from infinisst_tpu_torch.serve.engine import ServingEngine

    rng = np.random.RandomState(13)
    stream = StreamConfig()
    out = []
    reset_counts()
    with torch.no_grad(), tensor_parallel(mesh):
        eng = ServingEngine(
            params, cfg, stream, {("English", "German"): PromptBuilder(
                StubTokenizer(cfg.llama.vocab_size), cfg.tokens)},
            pool_size=8, beam=4, dtype=torch.bfloat16, device=dev)
        slots = [eng.open_stream(f"s{i}") for i in range(8)]
        for _ in range(n_ticks):
            for s in slots:
                eng.push_audio(s, (rng.randn(stream.chunk_samples(1))
                                   * 0.1).astype(np.float32))
            eng.tick()
            out.append([list(eng.slots[s].target_ids) for s in slots])
    _sync(dev)
    return out, launch_counts()


def check_mesh_step(dev, mesh):
    """The sharded train step at mesh (1, 1) on the dryrun preset (float32,
    stage 2, remat, 3 of [train tiny]'s batches) against
    ``make_train_step`` without a mesh: losses, grad norms and every
    parameter bitwise equal (at world size 1 no reduction is reordered).
    Deterministic algorithms are on for the check (the embedding's and
    the convolutions' backward passes otherwise accumulate in any
    order; ``mesh_check.deterministic``); a second run without the mesh
    shows the card repeats itself.  The sharded step as
    ``TrainProgram``, captured as CUDA
    graphs (the mesh's collectives inside them), equals it too."""
    import torch

    from infinisst_tpu_torch.core import graphs
    from infinisst_tpu_torch.core.presets import dryrun_config
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.mesh_check import deterministic
    from infinisst_tpu_torch.train import step as tstep
    from infinisst_tpu_torch.train.main import random_params
    from infinisst_tpu_torch.train.trainer import BATCH_KEYS

    cfg = dryrun_config()
    host = train_tiny_batches(cfg, n=3)
    base = random_params(cfg, "cpu", torch.float32)
    freeze = tstep.FreezeConfig.stage2()

    def run(with_mesh, program=False):
        params = tstep.tree_map(lambda t: t.clone().to(dev), base)
        plan = None
        if with_mesh:  # zero's (FSDP's) spec tree, as Trainer's default
            params, lay = pmesh.shard_params(
                params, mesh, pmesh.model_param_specs(cfg, zero=True),
                cfg=cfg)
            plan = tstep.MeshPlan(mesh, lay)
        tx = tstep.make_optimizer(tstep.OptimConfig(
            learning_rate=TRAIN_LR, warmup_steps=1, total_steps=6),
            params, freeze)
        state = tstep.init_train_state(params, tx)
        kw = dict(freeze=freeze, remat=True, plan=plan)
        metrics = []
        if program:
            prog = tstep.TrainProgram(cfg, tx, 48, 96, dev, **kw)
            for b in host:
                state, m = prog(state, tstep.Batch(**{
                    k: torch.from_numpy(b[k]).pin_memory()
                    for k in BATCH_KEYS}))
                metrics.append(tuple(graphs.read(m["packed"])))
            if not all(k.program.replays for k in prog.keys.values()):
                fail("[mesh] the sharded step's program did not replay")
            return metrics, tstep.tree_leaves(state.params)
        step = tstep.make_train_step(cfg, tx, 48, 96, **kw)
        for b in host:
            state, m = step(state, tstep.Batch(**{
                k: torch.from_numpy(b[k]).to(dev) for k in BATCH_KEYS}))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, tstep.tree_leaves(state.params)

    with deterministic():
        plain = run(False)
        sharded = run(True)
        captured = run(True, program=True)
        again = run(False)
    for label, other in (("the plain step run again", again),
                         ("the sharded step at (1, 1)", sharded),
                         ("the captured sharded step at (1, 1)",
                          captured)):
        if other[0] != plain[0] or not all(
                torch.equal(a, b) for a, b in zip(other[1], plain[1])):
            fail(f"[mesh] {label} is not bitwise the plain step: metrics "
                 f"{other[0]} against {plain[0]}")
    print(f"[mesh] sharded train step at (1, 1) (zero's spec tree, FSDP's "
          f"code path; one rank splits nothing), dryrun float32 stage 2, 3 "
          f"steps: losses and grad norms {plain[0]} and every parameter "
          f"bitwise those of make_train_step without a mesh, also as "
          f"TrainProgram captured as CUDA graphs", flush=True)


def start_mesh_runs(d) -> dict:
    """Start ``check_mesh``'s two torchrun runs (items 4 and 5) in the
    background, their output into files under ``d``; returns their
    processes, files, the run directory and the start time."""
    import numpy as np

    from infinisst_tpu_torch.bench import write_train_tsv

    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    data = os.path.join(d, "mesh_main")
    os.makedirs(data)
    write_train_tsv(data, 6, 2, np.random.RandomState(1), words_per_unit=0)
    run = os.path.join(data, "run")
    runs = {"run": run, "t0": time.perf_counter(), "procs": {}}
    for name, argv in (
            ("dryrun", ["infinisst_tpu_torch.parallel.dryrun"]),
            ("train.main", [
                "infinisst_tpu_torch.train.main", "--model_preset",
                "dryrun", "--n_data", "1", "--max_steps", "3",
                "--data_path", data, "--data_split_train", "tr",
                "--data_split_eval", "tr", "--eval_step", "0", "--log_step",
                "1", "--save_step", "0", "--grad_acc_steps", "1",
                "--train_bsz", "300", "--max_cache_size", "96",
                "--save_dir", run])):
        files = [open(os.path.join(d, f"{name}.{x}"), "w+")
                 for x in ("out", "err")]
        proc = subprocess.Popen(torchrun + ["-m"] + argv, cwd=ROOT,
                                stdout=files[0], stderr=files[1], text=True)
        runs["procs"][name] = (proc, files)
    return runs


def stop_mesh_runs(runs):
    """Kill what is left of ``start_mesh_runs``' processes."""
    for proc, files in runs["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in files:
            f.close()


def finish_mesh_runs(runs) -> dict:
    """Wait for ``start_mesh_runs``' processes; name -> CompletedProcess."""
    outs = {}
    for name, (proc, files) in runs["procs"].items():
        proc.wait(timeout=600)
        text = []
        for f in files:
            f.flush()
            f.seek(0)
            text.append(f.read())
        outs[name] = subprocess.CompletedProcess(proc.args, proc.returncode,
                                                 *text)
    return outs


def check_mesh(dev, cfg, params, runs, paths):
    """The mesh path on the card at world size 1 (one H100: NCCL refuses
    two ranks on one card, so the multi-rank checks run on the CPU under
    gloo, tests/test_torch_parallel.py):

    1. in this process, a world-1 NCCL group: the flagship W8A8 agent
       (``[flagship]``'s weights) through the mesh path (``shard_params``
       at (1, 1) with zero's spec tree, ``tensor_parallel``), 4 chunks:
       the target ids of the agent without a mesh after every chunk, and
       w8a8_gemm, row_quant_int8 and beam_attention launched;
    2. the split-pool engine's code path: the flagship W8A8 pool of 8 at
       beam 4 built and ticked under ``tensor_parallel`` of the (1, 1)
       mesh, 2 ticks, every slot's tokens those of the pool without a
       mesh (one data rank holds every row: the split itself runs on
       four cards, ``parallel.mesh_check``, and on the CPU under gloo);
    3. in the same group, ``check_mesh_step``;
    4. ``torchrun --standalone --nproc_per_node 1 -m
       infinisst_tpu_torch.parallel.dryrun``: the five parts at mesh (1, 1)
       under NCCL, exit 0 and the summary line, its launches;
    5. ``torchrun ... -m infinisst_tpu_torch.train.main --model_preset
       dryrun --n_data 1 --max_steps 3``: metrics.jsonl with three finite
       losses and the checkpoint of step 3.

    4 and 5 run beside the phases from [alignatt graph] on and beside
    1-3 (``start_mesh_runs``: each of their processes spends its first
    ~10 s importing torch); ``runs`` are they, read here."""
    import torch

    counts, pool_counts = _mesh_in_process(dev, cfg, params)
    outs = finish_mesh_runs(runs)
    print(f"[mesh] the two torchrun runs, started before [alignatt graph], "
          f"read {time.perf_counter() - runs['t0']:.1f} s after their start",
          flush=True)
    run = runs["run"]

    out = outs["dryrun"]
    lines = (out.stdout + out.stderr).strip().splitlines()
    for line in lines[-3:]:
        print(f"[mesh]   {line}", flush=True)
    summary = [x for x in out.stdout.splitlines()
               if x.startswith("dryrun_multichip OK: mesh=(1x1) devices=1")]
    if out.returncode != 0 or not summary:
        fail(f"[mesh] the dryrun exited {out.returncode} without its summary")
    dry = _stderr_json(out.stderr, "kernel launches ")
    if dry.get("beam_attention", 0) <= 0:
        fail(f"[mesh] the dryrun's pool ticks launched no beam_attention: "
             f"{dry}")
    shapes = _stderr_json(out.stderr, "attention launches by shape ")
    print(f"[mesh] dryrun under torchrun (NCCL, world 1): exit 0, launches "
          f"{dry}, attention by shape {shapes}", flush=True)

    out = outs["train.main"]
    for line in (out.stdout + out.stderr).strip().splitlines()[-2:]:
        print(f"[mesh]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[mesh] train.main under torchrun exited {out.returncode}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        logs = [json.loads(x) for x in f.read().splitlines()]
    losses = [x["train_loss"] for x in logs if "train_loss" in x]
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        fail(f"[mesh] train.main under torchrun: losses {losses}")
    saved = torch.load(os.path.join(run, "ckpt", "3", "state.pt"),
                       map_location="cpu", weights_only=True)
    if saved["step"] != 3:
        fail(f"[mesh] the torchrun checkpoint holds step {saved['step']}")
    print(f"[mesh] train.main under torchrun (NCCL, n_data 1): losses "
          f"{[round(x, 4) for x in losses]}, checkpoint of step 3",
          flush=True)
    paths["mesh"] = (
        "[mesh] the flagship W8A8 agent at mesh (1, 1), 4 chunks; the "
        "flagship W8A8 pool through the split engine at (1, 1), 2 ticks; "
        "the dryrun under torchrun at (1, 1)",
        {"agent": counts, "split_pool": pool_counts, "dryrun": dry})


def _mesh_in_process(dev, cfg, params):
    """``check_mesh``'s items 1-3, in a world-1 NCCL group of this
    process; returns the launches of 1 and of 2."""
    import torch
    import torch.distributed as dist

    from infinisst_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = pmesh.make_mesh(1, 1, dev)
        local, _ = pmesh.shard_params(
            params, mesh, pmesh.model_param_specs(cfg, zero=True), cfg=cfg)
        want, _ = _agent_tokens(dev, cfg, params, 4)
        got, counts = _agent_tokens(dev, cfg, local, 4, mesh=mesh)
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                fail(f"[mesh] chunk {i}: target ids {g} through the mesh "
                     f"path, {w} without it")
        for k in ("w8a8_gemm", "row_quant_int8", "beam_attention",
                  "rms_norm_quant_int8", "silu_mul_quant_int8"):
            if counts[k] <= 0:
                fail(f"[mesh] {k} was not launched on the mesh path")
        print(f"[mesh] flagship W8A8 agent through the mesh path at (1, 1): "
              f"4 chunks, {len(got[-1])} target ids, equal to the agent "
              f"without a mesh after every chunk; launches {counts} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t1 = time.perf_counter()
        want, _ = _pool_tokens(dev, cfg, params, 2)
        got, pool_counts = _pool_tokens(dev, cfg, local, 2, mesh=mesh)
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                fail(f"[mesh] pool tick {i}: slot tokens {g} through the "
                     f"split engine's path, {w} without a mesh")
        for k in ("w8a8_gemm", "row_quant_int8", "beam_attention",
                  "rms_norm_quant_int8", "silu_mul_quant_int8"):
            if pool_counts[k] <= 0:
                fail(f"[mesh] {k} was not launched by the split engine")
        print(f"[mesh] flagship W8A8 pool of 8 at beam 4 through the split "
              f"engine's path at (1, 1) (one data rank: no split on one "
              f"card): 2 ticks, {sum(map(len, got[-1]))} tokens, every "
              f"slot's equal to the pool's without a mesh; launches "
              f"{pool_counts} ({time.perf_counter() - t1:.1f} s)",
              flush=True)
        del local
        torch.cuda.empty_cache()
        check_mesh_step(dev, mesh)
    finally:
        dist.destroy_process_group()
    return counts, pool_counts


def check_train_main(d):
    """``python -m infinisst_tpu_torch.train.main --model_preset dryrun
    --max_steps 3`` on the card (``run_main``) over a dryrun TSV (rows
    of 1920 ms; the trajectories carry no text, so that the stub
    tokenizer's ids, past the dryrun vocabulary, are no target):
    metrics.jsonl with three finite train losses and an eval loss, and
    the checkpoint of step 3."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.bench import write_train_tsv

    data = os.path.join(d, "train_main")
    os.makedirs(data)
    write_train_tsv(data, 6, 2, np.random.RandomState(1), words_per_unit=0)
    run = os.path.join(data, "run")
    argv = ["--model_preset", "dryrun", "--max_steps", "3",
            "--data_path", data, "--data_split_train", "tr",
            "--data_split_eval", "tr", "--eval_step", "3", "--log_step",
            "1", "--save_step", "0", "--grad_acc_steps", "1", "--train_bsz",
            "300", "--max_cache_size", "96", "--save_dir", run]
    out = run_main("infinisst_tpu_torch.train.main", argv)
    for line in (out.stdout + out.stderr).strip().splitlines()[-4:]:
        print(f"[train main]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[train main] exited {out.returncode}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        logs = [json.loads(x) for x in f.read().splitlines()]
    losses = [x["train_loss"] for x in logs if "train_loss" in x]
    evals = [x["eval_loss"] for x in logs if "eval_loss" in x]
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses + evals) \
            or len(evals) != 1:
        fail(f"[train main] train losses {losses}, eval losses {evals}")
    saved = torch.load(os.path.join(run, "ckpt", "3", "state.pt"),
                       map_location="cpu", weights_only=True)
    if saved["step"] != 3:
        fail(f"[train main] the checkpoint holds step {saved['step']}")
    print(f"[train main] train losses {[round(x, 4) for x in losses]}, eval "
          f"loss {evals[0]:.4f}, checkpoint of step 3", flush=True)


def check_train_bench():
    """``python -m infinisst_tpu_torch.bench --mode train`` and ``--mode
    train-io`` (``run_main``): exit 0, the JSON line of bench.py's row
    (its metric and keys), the value finite and positive; returns the two
    lines."""
    out_lines = {}
    for mode, metric, keys in (("train", TRAIN_METRIC, TRAIN_KEYS),
                               ("train-io", TRAIN_IO_METRIC, TRAIN_IO_KEYS)):
        label = f"train bench {mode}"
        out = run_main("infinisst_tpu_torch.bench", ["--mode", mode])
        for line in out.stderr.strip().splitlines()[-20:]:
            print(f"[{label}]   {line}", flush=True)
        if out.returncode != 0:
            fail(f"[{label}] exited {out.returncode}")
        lines = out.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            fail(f"[{label}] its last stdout line is not JSON: {lines[-1:]}")
        if result.get("metric") != metric or tuple(result) != keys:
            fail(f"[{label}] line {result}; expected metric {metric} with "
                 f"keys {keys}")
        if not (math.isfinite(result["value"]) and result["value"] > 0):
            fail(f"[{label}] value {result['value']}")
        print(f"[{label}] {json.dumps(result)}", flush=True)
        out_lines[mode] = result
    return out_lines


def profile_train_bench(dev):
    """The bench's stage-1 step (the 1.5B preset, bf16, B = 2 x 28.8 s,
    remat) in this process, as the bench runs it (``TrainProgram``,
    captured): the synced walls of 4 replays after the warm-up and
    capture, the host's time to return from a replayed step without a
    synchronise (its dispatch), the same of the step uncaptured (a second
    program, ``captured=False``, on the same state), and one replayed
    step under the profiler (the device's idle share)."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.bench import train_batch, train_params
    from infinisst_tpu_torch.core.presets import bench_1chip_config
    from infinisst_tpu_torch.train import step as tstep

    cfg = bench_1chip_config()
    params, freeze, tx = train_params(cfg, dev)
    state = tstep.init_train_state(params, tx)
    batch = train_batch(2, 30, dev, np.random.RandomState(0))
    progs = {c: tstep.TrainProgram(cfg, tx, 48, 576, dev, freeze=freeze,
                                   remat=True, captured=c)
             for c in (True, False)}
    out = {}
    for captured, prog in progs.items():
        walls = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = prog(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        state, _ = prog(state, batch)
        dispatch = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[captured] = (walls, dispatch, statistics.median(walls[1:]))
    (walls, dispatch, med), (u_walls, u_dispatch, u_med) = (out[True],
                                                            out[False])
    print(f"[train bench profile] 1.5B stage-1 step, captured: synced "
          f"walls {[round(w, 3) for w in walls]} s (the first warms up and "
          f"captures); the host returns from a replayed step after "
          f"{dispatch * 1e3:.2f} ms without a synchronise ({dispatch / med:.3f}"
          f" of the median wall {med * 1e3:.2f} ms); uncaptured: walls "
          f"{[round(w, 3) for w in u_walls]} s, dispatch "
          f"{u_dispatch * 1e3:.2f} ms ({u_dispatch / u_med:.3f} of "
          f"{u_med * 1e3:.2f} ms)", flush=True)
    prog = progs[True]
    profile_run(dev, lambda: prog(state, batch), TRAIN_STAGES,
                "train bench profile", med * 1e3, "replayed step")


# ---------------------------------------------------------------------------
# the tools: the int8 fidelity probe, draft distillation, profiling

FIDELITY_STEPS = 600  # the JAX tool's default
FIDELITY_DOC = "docs/quant_fidelity.json"  # the JAX tool's table
# the kernels each variant's probe must launch (the float32 reference and
# every variant run beam_attention in their beam steps)
# (every W8A8 variant: the norms and the SwiGLU product quantized by the
# fused kernels, the attention output by its own quantizer; a per-channel
# head's by the final norm's fused kernel)
FUSED = ("rms_norm_quant_int8", "silu_mul_quant_int8")
FIDELITY_KERNELS = {
    "bf16": ("beam_attention",),
    "w8": ("w8_bf16_gemm", "beam_attention"),
    "w8a8": FUSED + ("row_quant_int8", "w8a8_gemm", "beam_attention"),
    "w8a8_g128": FUSED + ("group_quant_int8", "w8a8_grouped_gemm",
                          "beam_attention"),
    "w8a8_g128_projonly": FUSED + ("group_quant_int8", "w8a8_grouped_gemm",
                                   "w8a8_gemm", "beam_attention"),
    "w8a8_8groups_like_g512": FUSED + ("group_quant_int8",
                                       "w8a8_grouped_gemm",
                                       "beam_attention"),
    # groups of 8: the grouped GEMM's simple route
    "w8a8_32groups_like_g128": FUSED + ("group_quant_int8",
                                        "w8a8_grouped_gemm",
                                        "beam_attention"),
    "w8a8_32groups_projonly": FUSED + ("group_quant_int8",
                                       "w8a8_grouped_gemm", "w8a8_gemm",
                                       "beam_attention"),
}
FIDELITY_COLS = ("train_flip_rate", "held_flip_rate", "held_dlogit_p99",
                 "greedy_match_32", "beam4_winner_changed")
# the probe's prefill (8 x 64 rows into wq): the kernels line's tools shape
TOOL_SHAPE = (512, 256, 256)
# its beam step's beam_attention: 4 beams over the 8-token prompt's cache
# (32 slots) and their own block of 24 slots, 12 tokens in
TOOL_ATT_CASES = (("fidelity beam step", 4, 1, 32, [20], 24, [12] * 4),)
TOOL_ATT_SHAPE = ("fidelity beam step", 4, 32)
DISTILL_TINY_TRAIN = 150  # tests/test_draft_adapter.py's lift test
DISTILL_CHUNKS = 4


def _leaf(tree, key, layer=0):
    """A (K-major) weight leaf of layer ``layer`` (the lm_head as it is)."""
    if key == "lm_head":
        return tree["lm_head"]
    w = tree["layers"][key]
    return {k: v[layer] for k, v in w.items()} if isinstance(w, dict) \
        else w[layer]


def hold_tool_kernels(dev, params):
    """Every int8 kernel bitwise against its plain version (w8_bf16_gemm
    within 1e-5 x max|plain|: float32 summation order) at the probe's
    shapes on its trained weights: the prefill's 512 rows and a beam
    step's 4, into wq (D=256), w_down (D=512) and the lm_head (O=512),
    W8A8 per-channel, weight-only and grouped by 128, 32 and 8 (the
    grouped pair's simple route); the activations are the trained model's
    layer-0 inputs."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.kernels import quant_matmul as K
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.tools import quant_fidelity as QF

    cfg = QF.CFG
    ids = torch.as_tensor(QF.make_corpus(np.random.RandomState(0), 8, 64),
                          device=dev)
    lp = L.layer_params(params["layers"], 0)
    with torch.no_grad():
        y = L._rms_norm(L.embed(params, ids), lp["input_ln"],
                        cfg.rms_norm_eps).reshape(-1, cfg.hidden_size)
        y2 = torch.nn.functional.silu(y @ lp["w_gate"]) * (y @ lp["w_up"])
    var = QF.quant_variants(params)
    grouped = (("w8a8_g128", 128), ("w8a8_8groups_like_g512", 32),
               ("w8a8_32groups_like_g128", 8))
    n = 0
    for M in (512, 4):
        for x, key in ((y, "wq"), (y2, "w_down"), (y, "lm_head")):
            xm = x[:M].contiguous()
            label = f"M={M} {key}"
            yq, ys = K.row_quant_int8(xm)
            pq, ps = K.row_quant_int8_plain(xm)
            if not (torch.equal(yq, pq) and torch.equal(ys, ps)):
                fail(f"[fidelity] row_quant_int8 differs at {label}")
            w = _leaf(var["w8a8"], key)
            if not torch.equal(
                    K.w8a8_gemm(yq, ys, w["q_kmajor"], w["scale_a8"],
                                torch.float32),
                    K.w8a8_gemm_plain(yq, ys, w["q_kmajor"], w["scale_a8"],
                                      torch.float32)):
                fail(f"[fidelity] w8a8_gemm differs at {label}")
            n += 2
            if key != "lm_head":  # the w8 variant keeps a float head
                w = _leaf(var["w8"], key)
                out = K.w8_bf16_gemm(xm, w["q_kmajor"], w["scale"])
                ref = K.w8_bf16_gemm_plain(xm, w["q_kmajor"], w["scale"])
                e = (out - ref).abs().max().item()
                if not e <= 1e-5 * ref.abs().max().item():
                    fail(f"[fidelity] w8_bf16_gemm at {label}: "
                         f"max_abs_err {e}")
                n += 1
            for name, gs in grouped:
                w = _leaf(var[name], key)
                if w["scale_a8"].ndim != 2:
                    continue
                check_grouped(K, xm, w["q_kmajor"], w["scale_a8"], gs,
                              f"[fidelity] {label} gs={gs}",
                              (torch.float32,))
                n += 2
    # the fused quantizers at the probe's widths (its norm D=256 over the
    # embedding and the layer's input as the residual, the SwiGLU product
    # I=512), one scale a row and in groups of 128, 32 and 8
    with torch.no_grad():
        h = L.embed(params, ids).reshape(-1, cfg.hidden_size)
        gate, up = y @ lp["w_gate"], y @ lp["w_up"]
    for M in (512, 4):
        for gs in (cfg.hidden_size, 128, 32, 8):
            args = (h[:M].contiguous(), y[:M].contiguous(), lp["post_ln"],
                    cfg.rms_norm_eps, gs)
            hold_fused(f"[fidelity] rms_norm_quant_int8 M={M} gs={gs}",
                       K.rms_norm_quant_int8(*args),
                       K.rms_norm_quant_int8_plain(*args))
            gs = cfg.intermediate_size if gs == cfg.hidden_size else gs
            args = (gate[:M].contiguous(), up[:M].contiguous(), gs)
            hold_fused(f"[fidelity] silu_mul_quant_int8 M={M} gs={gs}",
                       K.silu_mul_quant_int8(*args),
                       K.silu_mul_quant_int8_plain(*args))
            n += 2
    torch.cuda.synchronize()
    print(f"  {n} kernel calls at the probe's shapes agree with their "
          "plain versions (bitwise but w8_bf16_gemm)", flush=True)
    return var, y


def time_tool_kernels(dev, notes, var, y):
    """Each kernel's time at the probe's prefill (TOOL_SHAPE, float32, as
    the tool runs them), beside its plain version, the library call and
    the bound; beam_attention at the probe's beam step (within
    ATT_RTOL)."""
    import torch

    from infinisst_tpu_torch.kernels import quant_matmul as K

    M, D, O = TOOL_SHAPE
    x = y[:M].contiguous()
    lbl = f"tools M={M} D={D} O={O}"
    key = ("tools",) + TOOL_SHAPE
    qkey = ("tools", M, D, 0)
    # row_quant_int8 and its launch floor
    rp = K.row_quant_plan(M, D, 4)
    bms, by = bound_ms(M * D * 4 + M * D + M * 4, 0, 1.0)
    notes.note("row_quant_int8", qkey, 0.0,
               cuda_time_ms(lambda i: K.row_quant_int8(x), 50),
               cuda_time_ms(lambda i: K.row_quant_int8_plain(x), 20), None,
               bms, by, label=f"tools M={M} D={D}",
               floor_ms=cuda_time_ms(
                   lambda i: K.launch_empty(dev, rp.vpt * M, rp.threads), 50))
    # the fused quantizers at the probe's prefill: the norm (D) after the
    # residual add, the SwiGLU product (the intermediate width)
    lp = {k: v[0] for k, v in var["w8a8"]["layers"].items()
          if not isinstance(v, dict)}
    plan = K.norm_quant_plan(D)
    bms, by = bound_ms(3 * M * D * 4 + D * 4 + M * D + M * 4, 0, 1.0)
    notes.note("rms_norm_quant_int8", qkey, 0.0,
               cuda_time_ms(lambda i: K.rms_norm_quant_int8(
                   x, x, lp["post_ln"], 1e-5, D), 50),
               cuda_time_ms(lambda i: K.rms_norm_quant_int8_plain(
                   x, x, lp["post_ln"], 1e-5, D), 20), None, bms, by,
               label=f"tools M={M} D={D}", floor_ms=cuda_time_ms(
                   lambda i: K.launch_empty_rows(dev, plan, M), 50))
    wg = _leaf(var["w8a8"], "w_gate")
    Iw = wg["q_kmajor"].shape[0]
    gate = torch.randn((M, Iw), device=dev)
    plan = K.norm_quant_plan(Iw)
    bms, by = bound_ms(2 * M * Iw * 4 + M * Iw + M * 4, 0, 1.0)
    notes.note("silu_mul_quant_int8", ("tools", M, Iw, 0), 0.0,
               cuda_time_ms(lambda i: K.silu_mul_quant_int8(
                   gate, gate, Iw), 50),
               cuda_time_ms(lambda i: K.silu_mul_quant_int8_plain(
                   gate, gate, Iw), 20), None, bms, by,
               label=f"tools M={M} I={Iw}", floor_ms=cuda_time_ms(
                   lambda i: K.launch_empty_rows(dev, plan, M), 50))
    yq, ys = K.row_quant_int8(x)
    w = _leaf(var["w8a8"], "wq")
    wt, s = w["q_kmajor"], w["scale_a8"]
    wk = wt.t().contiguous()  # (D, O): torch._int_mm's layout
    bms, by = bound_ms(M * D + M * 4 + D * O + O * 4 + M * O * 4,
                       2.0 * M * D * O, INT8_OPS_PER_S)
    notes.note("w8a8_gemm", key, 0.0,
               cuda_time_ms(lambda i: K.w8a8_gemm(yq, ys, wt, s,
                                                  torch.float32), 20),
               cuda_time_ms(lambda i: K.w8a8_gemm_plain(
                   yq, ys, wt, s, torch.float32), 3, warmup=1),
               cuda_time_ms(lambda i: torch._int_mm(yq, wk).float() * ys * s,
                            20),
               bms, by, label=lbl)
    w = _leaf(var["w8"], "wq")
    wt, s = w["q_kmajor"], w["scale"]
    out, ref = K.w8_bf16_gemm(x, wt, s), K.w8_bf16_gemm_plain(x, wt, s)
    err = (out - ref).abs().max().item()
    xb = x.to(torch.bfloat16)
    bms, by = bound_ms(M * D * 4 + D * O + O * 4 + M * O * 4,
                       2.0 * M * D * O, BF16_FLOPS_PER_S)
    notes.note("w8_bf16_gemm", key, err,
               cuda_time_ms(lambda i: K.w8_bf16_gemm(x, wt, s), 20),
               cuda_time_ms(lambda i: K.w8_bf16_gemm_plain(x, wt, s), 3,
                            warmup=1),
               cuda_time_ms(lambda i: torch._weight_int8pack_mm(xb, wt, s),
                            20),
               bms, by, label=lbl)
    gs = 128
    G = D // gs
    qp = K.group_quant_plan(M, D, G, 4)
    bms, by = bound_ms(M * D * 4 + M * D + M * G * 4, 0, 1.0)
    notes.note("group_quant_int8", qkey, 0.0,
               cuda_time_ms(lambda i: K.group_quant_int8(x, gs), 50),
               cuda_time_ms(lambda i: K.group_quant_int8_plain(x, gs), 20),
               None, bms, by, label=f"tools M={M} D={D} gs={gs}",
               floor_ms=cuda_time_ms(
                   lambda i: K.launch_empty(dev, qp.blocks, qp.threads), 50))
    gq, gsc = K.group_quant_int8(x, gs)
    w = _leaf(var["w8a8_g128"], "wq")
    wt, s = w["q_kmajor"], w["scale_a8"]
    bms, by = bound_ms(M * D + M * G * 4 + D * O + G * O * 4 + M * O * 4,
                       2.0 * M * D * O, INT8_OPS_PER_S)
    notes.note("w8a8_grouped_gemm", key, 0.0,
               cuda_time_ms(lambda i: K.w8a8_grouped_gemm(
                   gq, gsc, wt, s, torch.float32), 20),
               cuda_time_ms(lambda i: K.w8a8_grouped_gemm_plain(
                   gq, gsc, wt, s, torch.float32), 1, warmup=1),
               None, bms, by, label=f"{lbl} gs={gs}")
    # the simple route at the 32-group variants' groups of 8
    gs = 8
    G = D // gs
    gq, gsc = K.group_quant_int8(x, gs)
    w = _leaf(var["w8a8_32groups_like_g128"], "wq")
    wt, s = w["q_kmajor"], w["scale_a8"]
    bms, by = bound_ms(M * D + M * G * 4 + D * O + G * O * 4 + M * O * 4,
                       2.0 * M * D * O, INT8_OPS_PER_S)
    notes.note("w8a8_grouped_gemm", ("tools gs8",) + TOOL_SHAPE, 0.0,
               cuda_time_ms(lambda i: K.w8a8_grouped_gemm(
                   gq, gsc, wt, s, torch.float32), 20),
               cuda_time_ms(lambda i: K.w8a8_grouped_gemm_plain(
                   gq, gsc, wt, s, torch.float32), 1, warmup=1),
               None, bms, by, label=f"{lbl} gs={gs} (simple route)")
    gen = torch.Generator(device=dev).manual_seed(17)
    H, KV, Dh = 4, 4, 64  # the probe's Llama
    for case in TOOL_ATT_CASES:
        beam_case(dev, gen, notes, *case, dtype=torch.float32, timed=True,
                  heads=(H, KV, Dh))


def check_fidelity(dev, notes, paths):
    """``tools.quant_fidelity.main`` on the card in this process at 600
    training steps: all eight variants run, each variant's kernels
    launched (the groups-of-8 variants through the grouped GEMM's simple
    route), the card's rates beside the JAX tool's table; then the
    kernels held and timed at the probe's shapes.  Returns the trained
    float parameters."""
    import torch

    from infinisst_tpu_torch.tools import quant_fidelity as QF

    reset_counts()
    t0 = time.perf_counter()
    results, params = QF.main(["--steps", str(FIDELITY_STEPS),
                               "--device", "cuda"])
    counts = launch_counts()
    print(f"[fidelity] tool wall {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(counts)}", flush=True)
    paths["fidelity"] = (
        f"tools.quant_fidelity.main --steps {FIDELITY_STEPS}", counts)
    if set(results["variants"]) != set(FIDELITY_KERNELS):
        fail(f"[fidelity] variants run: {sorted(results['variants'])}")
    for name, kernels in FIDELITY_KERNELS.items():
        n = results["launches"].get(name)
        if n is None:
            fail(f"[fidelity] variant {name} did not run")
        missing = [k for k in kernels if n[k] <= 0]
        if missing:
            fail(f"[fidelity] {name} launched no {', '.join(missing)}")
        print(f"  {name:24s} launches "
              f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
    for m in ("train_margins", "held_margins"):
        if not all(math.isfinite(v) for v in results[m].values()):
            fail(f"[fidelity] {m} not finite: {results[m]}")
    with open(os.path.join(ROOT, FIDELITY_DOC)) as f:
        ref = json.load(f)
    print(f"[fidelity] the card's table beside {FIDELITY_DOC} (JAX, CPU); "
          "the float32 training ran on other hardware, so the rates differ "
          "as the trained models do", flush=True)
    print(f"  margins: card train {results['train_margins']} held "
          f"{results['held_margins']}; JAX train {ref['train_margins']} "
          f"held {ref['held_margins']}", flush=True)
    print(f"  {'variant':24s} " + " ".join(f"{c:>22s}" for c in
                                            FIDELITY_COLS), flush=True)
    for name in ref["variants"]:
        for who, rows in (("card", results["variants"]),
                          ("JAX", ref["variants"])):
            row = rows.get(name)
            if row is None:
                cells = ["not run"] * len(FIDELITY_COLS)
            else:
                cells = [str(row[c]) for c in FIDELITY_COLS]
                if who == "card" and not (0 <= row["held_flip_rate"] <= 1):
                    fail(f"[fidelity] {name}: {row}")
            print(f"  {name + ' ' + who:24s} "
                  + " ".join(f"{c:>22s}" for c in cells), flush=True)
    var, y = hold_tool_kernels(dev, params)
    time_tool_kernels(dev, notes, var, y)
    del var
    torch.cuda.empty_cache()
    return params


def check_distill_tiny(dev, paths):
    """The lift of ``tests/test_draft_adapter.py`` on the card: the probe's
    Llama trained 150 steps on the 64 x 64 corpus, 8 prompts rolled out,
    an adapter distilled at d = 1 (300 steps, lr 2e-3); then speculative
    greedy with and without it in float32 and with W8A8 weights: the KL
    below 0.2 x its start, the agreement above 0.9, the tokens unchanged
    by the adapter, the float32 acceptance at least doubled with fewer
    rounds, w8a8_gemm launched by the W8A8 runs."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.decode.speculative import (
        SpecSpec,
        speculative_greedy,
    )
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models.quant import quantize_llama_params
    from infinisst_tpu_torch.streaming.state import init_decoder_state
    from infinisst_tpu_torch.tools import quant_fidelity as QF
    from infinisst_tpu_torch.train import draft as DR

    cfg = QF.CFG
    reset_counts()
    corpus = QF.make_corpus(np.random.RandomState(0), 64, 64)
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev, torch.float32)
    params = QF.train(params, corpus, DISTILL_TINY_TRAIN)
    prompts = torch.as_tensor(QF.make_corpus(np.random.RandomState(50), 8, 8),
                              device=dev)
    rollouts = DR.rollout_corpus(params, cfg, prompts, 32)
    adapter, hist = DR.distill(
        params, cfg, 1, [rollouts], steps=300, lr=2e-3,
        key=torch.Generator(device=dev).manual_seed(5), log_every=150)
    print(f"[distill tiny] history (step, kl, agreement): {hist}",
          flush=True)
    if not hist[-1][1] < 0.2 * hist[0][1]:
        fail(f"[distill tiny] the KL did not collapse: {hist}")
    if not hist[-1][2] > 0.9:
        fail(f"[distill tiny] final agreement {hist[-1][2]} <= 0.9")
    spec = SpecSpec(max_new_tokens=24, eos_id=-1, pad_id=0, draft_layers=1,
                    draft_k=4, no_repeat_ngram_size=0, repetition_penalty=1.0)
    hist_buf = torch.zeros((8,), dtype=torch.int64, device=dev)

    def run(p, exit_adapter, prompt):
        st = init_decoder_state(cfg.num_layers, 1, len(prompt) + 24 + 5,
                                cfg.num_kv_heads, cfg.head_dim,
                                torch.float32, dev)
        with torch.no_grad():
            lg, st = L.decode_step(p, cfg, st, L.embed(p, prompt[None]))
        return speculative_greedy(p, cfg, st, lg[0, -1, :cfg.vocab_size],
                                  prompt, len(prompt), hist_buf, 0, spec,
                                  exit_adapter=exit_adapter)

    w8a8 = quantize_llama_params(params, quantize_lm_head=True,
                                 act_int8=True)
    for label, p in (("float32", params), ("w8a8", w8a8)):
        before = launch_counts()
        tot = {"raw": [0, 0, 0], "adapter": [0, 0, 0]}
        for i in range(prompts.shape[0]):
            a = run(p, None, prompts[i])
            b = run(p, adapter, prompts[i])
            if a.tokens[:a.n_tokens] != b.tokens[:b.n_tokens]:
                fail(f"[distill tiny] {label}: the adapter changed the "
                     f"tokens of prompt {i}")
            for k, r in (("raw", a), ("adapter", b)):
                tot[k] = [tot[k][0] + r.accepted, tot[k][1] + r.drafted,
                          tot[k][2] + r.rounds]
        launched = launch_counts()["w8a8_gemm"] - before["w8a8_gemm"]
        print(f"[distill tiny] {label}: tokens equal with and without the "
              "adapter; acceptance raw "
              f"{tot['raw'][0]}/{tot['raw'][1]} "
              f"({tot['raw'][0] / max(tot['raw'][1], 1):.4f}, "
              f"{tot['raw'][2]} rounds), adapter "
              f"{tot['adapter'][0]}/{tot['adapter'][1]} "
              f"({tot['adapter'][0] / max(tot['adapter'][1], 1):.4f}, "
              f"{tot['adapter'][2]} rounds); w8a8_gemm launches {launched}",
              flush=True)
        if label == "float32":
            if not tot["adapter"][0] >= 2 * max(tot["raw"][0], 1):
                fail(f"[distill tiny] acceptance not doubled: {tot}")
            if not tot["adapter"][2] < tot["raw"][2]:
                fail(f"[distill tiny] rounds did not drop: {tot}")
        elif launched <= 0:
            fail("[distill tiny] the W8A8 runs launched no w8a8_gemm")
    paths["distill tiny"] = (
        "quant_fidelity.train, draft.rollout_corpus and distill, "
        "speculative_greedy float32 and W8A8", launch_counts())
    distill_graph(dev, "distill tiny", params, cfg, d=1, rank=None,
                  prompts=prompts, gen_len=32, beam_len=10, steps=6,
                  batch=8)


DISTILL_GRAPH_LOG = 2  # the checks' log interval: a host read each
# profile_run's ranges: the pieces of a rollout
ROLLOUT_STAGES = (("graph", "prefill", "prefill"),
                  ("graph", "step", "one-token step"))


@contextlib.contextmanager
def kept_instances(mod, name):
    """Within: the instances of ``mod.<name>`` made are kept in the yielded
    list (a subclass stands in for the class)."""
    cls = getattr(mod, name)
    made = []

    class Kept(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    setattr(mod, name, Kept)
    try:
        yield made
    finally:
        setattr(mod, name, cls)


def _logged(steps: int) -> int:
    """The log steps of a distillation (every DISTILL_GRAPH_LOG and the
    last): its host reads."""
    return sum(1 for i in range(steps)
               if i % DISTILL_GRAPH_LOG == 0 or i == steps - 1)


def _strict(captured: bool):
    from infinisst_tpu_torch.core import graphs

    return graphs.strict_syncs() if captured else contextlib.nullcontext()


def _host_reads() -> int:
    from infinisst_tpu_torch.core import graphs

    return graphs.host_reads


def _reads(label, what, before, want):
    got = _host_reads() - before
    if got != want:
        fail(f"[{label}] {what}: {got} host reads, {want} expected")


def _fit_tensors(fit):
    return fit.leaves + fit.state["mu"] + fit.state["nu"]


def _fits_equal(label, what, a, b):
    import torch

    bad = [i for i, (x, y) in enumerate(zip(_fit_tensors(a),
                                            _fit_tensors(b)))
           if not torch.equal(x, y)]
    if bad:
        fail(f"[{label}] {what}: the adapter or the moments differ, "
             f"tensors {bad} of [ln, w1, w2, mu x 3, nu x 3]")


def _distill_rollouts(dev, label, params, cfg, prompts, gen_len, beam_len):
    """``Rollouts`` captured against uncaptured: each greedy key called
    twice, then one beam rollout.  Returns (the captured greedy tokens,
    the captured beam records)."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.train import draft as DR

    B, P = prompts.shape
    calls = [(prompts, gen_len),
             (prompts[:1, :P // 2].contiguous(), gen_len // 2)]
    rolled, walls = {}, {}
    for captured in (True, False):
        ro = DR.Rollouts(params, cfg, captured=captured)
        toks, w = [], []
        for _ in range(2):
            for p, g in calls:
                _sync(dev)
                reads = _host_reads()
                t0 = time.perf_counter()
                with _strict(captured):
                    toks.append(ro.greedy(p, g))
                _sync(dev)
                w.append(time.perf_counter() - t0)
                _reads(label, "a greedy rollout", reads, 0)
        reads = _host_reads()
        with _strict(captured):
            recs = ro.beam(prompts[0], beam_len)
        _reads(label, "a beam rollout", reads, 1)
        progs = [k.program for k in ro.keys.values()]
        if captured and not all(q.captured and q.replays for q in progs):
            fail(f"[{label}] a rollout program did not replay: "
                 f"{[(q.captured, q.replays) for q in progs]}")
        if captured:  # where a replayed greedy rollout's time goes
            profile_run(dev, lambda: ro.greedy(*calls[0]), ROLLOUT_STAGES,
                        f"{label} rollout profile", w[2] * 1e3,
                        "replayed greedy rollout")
        rolled[captured], walls[captured] = (toks, recs), w
        del ro, progs
    (ct, cr), (ut, ur) = rolled[True], rolled[False]
    if not all(torch.equal(a, b) for a, b in zip(ct, ut)):
        fail(f"[{label}] greedy rollouts: captured and uncaptured tokens "
             "differ")
    for t, (a, b) in enumerate(zip(cr, ur)):
        if a["len"] != b["len"] or not all(
                np.array_equal(a[k], b[k]) for k in (
                    "buf", "beam_scores", "sel_beam", "sel_tok")):
            fail(f"[{label}] beam rollout: step {t}'s records differ")
    tps = {c: B * gen_len / walls[c][2] for c in (True, False)}
    print(f"[{label}] rollouts: captured = uncaptured (greedy tokens on 2 "
          f"keys x 2 calls, {beam_len} beam-4 records), no host read a "
          f"greedy rollout, one a beam rollout; greedy ({B} x {P} + "
          f"{gen_len}, the second call) {tps[True]:.1f} tokens/s captured, "
          f"{tps[False]:.1f} uncaptured (walls, synchronised: captured "
          f"{[round(x * 1e3, 2) for x in walls[True]]} ms, uncaptured "
          f"{[round(x * 1e3, 2) for x in walls[False]]} ms)", flush=True)
    return ct[:2], cr


def _distill_fits(dev, label, params, cfg, d, rank, batches, feats, recs,
                  steps, batch):
    """The three distillers captured against uncaptured; returns the
    ``distill_on_features`` fits (captured, uncaptured)."""
    import torch

    from infinisst_tpu_torch.train import draft as DR

    seed = torch.Generator(device=dev)
    runs, fits, teachers = {}, {}, {}
    for captured in (True, False):
        with kept_instances(DR, "_Fit") as f, \
                kept_instances(DR, "_TeacherPass") as t:
            out = []
            for name, fn in (
                    ("distill", lambda k: DR.distill(
                        params, cfg, d, batches, steps=steps, rank=rank,
                        key=k, log_every=DISTILL_GRAPH_LOG,
                        max_cached_batches=1, captured=captured)),
                    ("distill_on_features", lambda k: DR.distill_on_features(
                        params, cfg, feats, steps=steps, rank=rank, key=k,
                        log_every=DISTILL_GRAPH_LOG, captured=captured)),
                    ("beam_selection_distill", lambda k: (
                        DR.beam_selection_distill(
                            params, cfg, d, recs, steps=steps, rank=rank,
                            key=k, batch=batch, log_every=DISTILL_GRAPH_LOG,
                            captured=captured)))):
                reads = _host_reads()
                with _strict(captured):
                    out.append(fn(seed.manual_seed(5)))
                _reads(label, name, reads, _logged(steps))
        runs[captured], fits[captured], teachers[captured] = out, f, t
    names = ("distill", "distill_on_features", "beam_selection_distill")
    for name, (_, ch), (_, uh), cf, uf in zip(
            names, runs[True], runs[False], fits[True], fits[False]):
        if ch != uh:
            fail(f"[{label}] {name}: history {ch} captured, {uh} uncaptured")
        _fits_equal(label, name, cf, uf)
    progs = [k.program for x in fits[True] + teachers[True]
             for k in x.keys.values()]
    if not all(q.captured and q.replays for q in progs):
        fail(f"[{label}] a distillation program did not replay: "
             f"{[(q.captured, q.replays) for q in progs]}")
    print(f"[{label}] distill (cache of 1: a teacher pass a step), "
          f"distill_on_features, beam_selection_distill, {steps} steps "
          f"each: captured = uncaptured bitwise (history, adapter, mu, nu), "
          f"{_logged(steps)} host reads each (the log steps), programs "
          f"{len(progs)}, replays {[q.replays for q in progs]}; histories "
          f"{[h for _, h in runs[True]]}", flush=True)
    return fits[True][1], fits[False][1]


def _distill_step_profile(dev, label, cap, unc, inputs):
    """Three timed steps of each of the fits ``cap`` (captured) and
    ``unc`` (host dispatch, synchronised wall); then two steps of each
    under the profiler (``_device_ops_last``): the second's kernels by
    name, copies and memsets the same, the states bitwise; each step's
    device idle share against its median unprofiled wall, and the
    replayed step's top kernels."""
    disp = {}
    for name, fit in (("captured", cap), ("uncaptured", unc)):
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            fit.step(inputs)
            d0 = time.perf_counter() - t0
            _sync(dev)
            disp.setdefault(name, []).append(
                (d0 * 1e3, (time.perf_counter() - t0) * 1e3))
    _fits_equal(label, "the timed steps", cap, unc)
    *ops_cap, ms_cap = _device_ops_last(dev, lambda: cap.step(inputs))
    *ops_unc, ms_unc = _device_ops_last(dev, lambda: unc.step(inputs))
    (seen_cap, copies_cap, sets_cap), (seen_unc, copies_unc, sets_unc) = (
        ops_cap, ops_unc)
    if ops_cap != ops_unc:
        diff = {k: (seen_cap.get(k, 0), seen_unc.get(k, 0))
                for k in set(seen_cap) | set(seen_unc)
                if seen_cap.get(k, 0) != seen_unc.get(k, 0)}
        fail(f"[{label}] the replayed step's kernels by name (captured, "
             f"uncaptured) differ: {diff}; copies {copies_cap} / "
             f"{copies_unc}, memsets {sets_cap} / {sets_unc}")
    _sync(dev)
    _fits_equal(label, "the profiled steps", cap, unc)
    idle = {}
    for name, ms in (("captured", ms_cap), ("uncaptured", ms_unc)):
        med = statistics.median(b for _, b in disp[name])
        idle[name] = (sum(ms.values()), 1.0 - sum(ms.values()) / med)
    print(f"[{label}] a replayed distill_on_features step ran the "
          f"uncaptured step's device kernels by name "
          f"({sum(seen_unc.values())} kernels, {len(seen_unc)} names), "
          f"{copies_unc} device copies and {sets_unc} memsets; a step's "
          f"(host dispatch, synchronised wall) ms: captured "
          f"{[(round(a, 3), round(b, 3)) for a, b in disp['captured']]}, "
          f"uncaptured "
          f"{[(round(a, 3), round(b, 3)) for a, b in disp['uncaptured']]}; "
          f"device ms and idle share against the median wall: captured "
          f"{idle['captured'][0]:.3f} ms, {idle['captured'][1]:.4f}; "
          f"uncaptured {idle['uncaptured'][0]:.3f} ms, "
          f"{idle['uncaptured'][1]:.4f}", flush=True)
    for k, t in sorted(ms_cap.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[{label} step profile]   {t:9.3f} ms  {k[:90]}", flush=True)


def distill_graph(dev, label, params, cfg, d, rank, prompts, gen_len,
                  beam_len, steps, batch):
    """``train/draft.py``'s programs captured against the same programs
    uncaptured (``captured=False``), from the same weights, seeds and
    inputs, the captured calls under ``graphs.strict_syncs`` (no
    deterministic mode: nothing on these paths accumulates in an order
    the card chooses):

    - ``Rollouts.greedy`` on two keys (``prompts``; its first row at half
      the prompt and half ``gen_len``), each called twice (the second
      replays every step): tokens equal, no host read; then
      ``Rollouts.beam`` from the first prompt, ``beam_len`` steps: every
      record equal, one host read; a replayed greedy call of the first
      key under the profiler (``profile_run``);
    - ``distill`` over the two keys' rollouts with a cache of one batch
      (each step a teacher pass: the teacher programs replay),
      ``distill_on_features`` over their teacher features and
      ``beam_selection_distill`` over the beam records, ``steps`` each:
      the history, the adapter and Adam's moments bitwise, one host read
      a log step, every program captured and replayed;
    - two more steps of each ``distill_on_features`` fit under the
      profiler: the second replayed step's device kernels by name, its
      copies and memsets, equal the second uncaptured step's; the states
      bitwise after them.

    Printed (no claim): rollout tokens/s captured and uncaptured (the
    first key's second call, synchronised), a step's host dispatch (its
    time to return) and wall (synchronised), captured and uncaptured,
    each step's device idle share (``_distill_step_profile``), and the
    walls of the three parts."""
    import gc

    import torch

    from infinisst_tpu_torch.train import draft as DR

    t0 = time.perf_counter()
    batches, recs = _distill_rollouts(dev, label, params, cfg, prompts,
                                      gen_len, beam_len)
    t1 = time.perf_counter()
    feats = []
    for ids in batches:
        mask = torch.ones(ids.shape, dtype=torch.float32, device=dev)
        feats.append((*DR.collect_targets(params, cfg, ids, d, mask), mask))
    cap, unc = _distill_fits(dev, label, params, cfg, d, rank, batches,
                             feats, recs, steps, batch)
    t2 = time.perf_counter()
    _distill_step_profile(dev, label, cap, unc, feats[0])
    t3 = time.perf_counter()
    print(f"[{label}] walls: rollouts {t1 - t0:.1f} s, distillers "
          f"{t2 - t1:.1f} s, the step's profile {t3 - t2:.1f} s",
          flush=True)
    del cap, unc, feats, batches, recs
    gc.collect()
    torch.cuda.empty_cache()


def check_distill_graph(dev):
    """``distill_graph`` on a float32 Llama at the flagship's full width
    and depth (random weights from seed 0; D 4096, V 128256, 32 layers),
    rank 2048, d = 8: greedy rollouts of 2 prompts of 16 tokens by 16
    (the [distill flagship] tool's shape), a beam-4 rollout of 6 steps,
    6 steps of each distiller, batches of 4 records."""
    import gc

    import torch

    from infinisst_tpu_torch.core.presets import flagship_config
    from infinisst_tpu_torch.models import llama as L

    cfg = flagship_config().llama
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev, torch.float32)
    prompts = torch.randint(5, 128000, (2, 16), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    print(f"[distill graph] float32 Llama, D {cfg.hidden_size}, V "
          f"{cfg.vocab_size}, {cfg.num_layers} layers, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB; rank 2048, "
          "d = 8", flush=True)
    distill_graph(dev, "distill graph", params, cfg, d=8, rank=2048,
                  prompts=prompts, gen_len=16, beam_len=6, steps=6, batch=4)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def check_distill_flagship(dev, paths):
    """``tools.distill_adapter`` at the flagship's full width (8B float32,
    V = 128256, rank 2048, d = 8; ``run_main``): its split (rollout,
    teacher pass, mean step) from its stderr, its three programs
    captured and replayed, the logged KL falls, the .npz loads at d = 8
    and is refused at 4.  Then the flagship W8A8
    agent, speculative at d = 8 with the guard off, DISTILL_CHUNKS chunks
    with and without the adapter: the same tokens, w8a8_gemm and
    row_quant_int8 launched.  The weights are random (the tool's and the
    agent's are not even the same draw), so the acceptance is a reading
    of the machinery, not of the adapter."""
    import gc

    import numpy as np
    import torch

    from infinisst_tpu_torch import bench
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent,
        InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.train import draft as DR

    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="distill_", dir=os.path.join(ROOT, "build"))
    try:
        prompts = os.path.join(d, "prompts.txt")
        rng = np.random.RandomState(0)
        with open(prompts, "w") as f:
            for _ in range(4):
                f.write(" ".join(str(x) for x in rng.randint(5, 128000, 16))
                        + "\n")
        out = os.path.join(d, "adapter_d8.npz")
        argv = ["--model-preset", "flagship", "--prompts", prompts,
                "--prompt-tokens", "16", "--gen-len", "16", "--batch-size",
                "2", "--draft-layers", "8", "--rank", "2048", "--steps",
                "20", "--out", out]
        t0 = time.perf_counter()
        with kept_instances(DR, "Rollouts") as ros, \
                kept_instances(DR, "_TeacherPass") as teachers, \
                kept_instances(DR, "_Fit") as fits:
            r = run_main("infinisst_tpu_torch.tools.distill_adapter", argv)
        wall = time.perf_counter() - t0
        # the tool ran the programs: each captured and replayed
        progs = [k.program for x in ros + teachers + fits
                 for k in x.keys.values()]
        replays = [(q.captured, q.replays) for q in progs]
        del ros, teachers, fits, progs  # they hold the tool's weights
        gc.collect()
        torch.cuda.empty_cache()
        print(r.stderr[-3000:], flush=True)
        if r.returncode != 0:
            fail(f"[distill flagship] the tool exited {r.returncode}")
        kls = [float(m.group(1)) for m in re.finditer(
            r"^step \d+: kl (\S+) top1-agree", r.stderr, re.M)]
        peak = re.search(r"^peak memory (\S+) GiB", r.stderr, re.M)
        split = [m.group(0) for m in re.finditer(
            r"^(rollout: .*|teacher: .*|step: .*)$", r.stderr, re.M)]
        print(f"[distill flagship] the tool's split: {'; '.join(split)}; "
              f"its wall with the weights' draw {wall:.1f} s, peak memory "
              f"{peak.group(1) if peak else '?'} GiB, kl {kls}; "
              f"{r.stdout.strip()}", flush=True)
        if len(split) != 3:
            fail(f"[distill flagship] the tool printed no split: {split}")
        print(f"[distill flagship] the tool's programs (rollout, teacher "
              f"pass, step): (captured, replays) {replays}", flush=True)
        if len(replays) != 3 or not all(c and n for c, n in replays):
            fail(f"[distill flagship] the tool did not replay its programs: "
                 f"{replays}")
        if len(kls) < 2 or not kls[-1] < kls[0]:
            fail(f"[distill flagship] the logged KL did not fall: {kls}")
        adapter = DR.load_adapter(out, expect_d=8)
        if tuple(adapter["w1"].shape) != (4096, 2048):
            fail(f"[distill flagship] w1 {tuple(adapter['w1'].shape)}")
        try:
            DR.load_adapter(out, expect_d=4)
        except ValueError as e:
            print(f"  refused at d=4: {e}", flush=True)
        else:
            fail("[distill flagship] the d=8 adapter loaded at d=4")
    finally:
        shutil.rmtree(d, ignore_errors=True)

    cfg, params = bench.flagship_params(dev)
    stream = StreamConfig()
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    runs = {}
    reset_counts()
    for label, ad in (("no adapter", None), ("adapter", adapter)):
        opts = InfiniSSTOptions(
            latency_multiplier=1, beam=4,
            max_llm_cache_size=stream.max_llm_cache_tokens, speculative=True,
            spec_draft_layers=8, spec_guard=False, spec_adapter=ad)
        agent = InfiniSSTAgent(params, cfg, stream, builder, opts,
                               param_dtype=torch.bfloat16, device=dev)
        before = launch_counts()
        t0 = time.perf_counter()
        bench.run_stream(agent, DISTILL_CHUNKS, warmup=0)
        after = launch_counts()
        n = {k: after[k] - before[k] for k in after}
        fields = bench.spec_fields(agent)
        runs[label] = list(agent.states.target_ids)
        print(f"[distill flagship] agent {label}: {DISTILL_CHUNKS} chunks in "
              f"{time.perf_counter() - t0:.1f} s, {len(runs[label])} target "
              f"ids, accept_rate {fields['accept_rate']}, rounds "
              f"{fields['rounds']}; launches "
              f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
        if n["w8a8_gemm"] <= 0 or n["row_quant_int8"] <= 0:
            fail(f"[distill flagship] {label}: no int8 launches {n}")
        del agent
    paths["distill flagship"] = (
        "tools.distill_adapter --model-preset flagship (float32, plain "
        "torch) and the W8A8 speculative agent d=8, with and without the "
        "adapter", launch_counts())
    if runs["adapter"] != runs["no adapter"]:
        fail("[distill flagship] the adapter changed the agent's tokens")
    print("[distill flagship] tokens equal with and without the adapter; "
          "random weights: the acceptance rates read the machinery, not "
          "the adapter", flush=True)
    del params
    torch.cuda.empty_cache()


PORT_KERNEL_NAMES = ("row_quant_int8_kernel", "w8a8_gemm_kernel",
                     "w8_bf16_gemm_tc_kernel", "group_quant_int8_kernel",
                     "w8a8_grouped_gemm_kernel", "decode_attention_kernel",
                     "beam_attention_kernel", "rms_norm_quant_int8_kernel",
                     "silu_mul_quant_int8_kernel")


def check_profiling(dev, params):
    """``core.profiling`` on the card: ``timed`` and ``StepTimer`` around
    w8a8_gemm launches with ``sync_on=``, and ``device_trace`` over one
    prefill of the probe's W8A8 model: the Chrome trace names the port's
    kernels."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.core import profiling as P
    from infinisst_tpu_torch.kernels import quant_matmul as K
    from infinisst_tpu_torch.models.quant import quantize_llama_params
    from infinisst_tpu_torch.tools import quant_fidelity as QF

    gen = torch.Generator(device=dev).manual_seed(23)
    M, D, O = REPORT_SHAPE
    y = (torch.randn((M, D), generator=gen, device=dev) * 2.0).to(
        torch.bfloat16)
    wt = torch.randint(-127, 128, (O, D), generator=gen, device=dev,
                       dtype=torch.int8)
    s = torch.rand((O,), generator=gen, device=dev) * 1e-3
    yq, ys = K.row_quant_int8(y)
    torch.cuda.synchronize()
    before = K.launch_counts["w8a8_gemm"]
    with P.timed(f"[profiling] timed w8a8_gemm M={M} D={D} O={O}",
                 sync_on=yq):
        K.w8a8_gemm(yq, ys, wt, s, torch.bfloat16)
    timer = P.StepTimer()
    for _ in range(5):
        with timer.phase("w8a8_gemm", sync_on={"y": [yq, ys]}):
            K.w8a8_gemm(yq, ys, wt, s, torch.bfloat16)
    print(timer.report(), flush=True)
    if timer.counts["w8a8_gemm"] != 5 or \
            K.launch_counts["w8a8_gemm"] - before != 6:
        fail("[profiling] the timed launches were not counted")
    vp = quantize_llama_params(params, quantize_lm_head=True, act_int8=True)
    ids = torch.as_tensor(QF.make_corpus(np.random.RandomState(0), 8, 64),
                          device=dev)
    QF.prefill_logits(vp, ids)  # warm
    d = tempfile.mkdtemp(prefix="profile_", dir=os.path.join(ROOT, "build"))
    try:
        with P.device_trace(d) as prof:
            QF.prefill_logits(vp, ids)
        with open(os.path.join(d, "trace.json")) as f:
            trace = json.load(f)
        names = {e.get("name", "") for e in trace.get("traceEvents", [])}
        seen = sorted({k for k in PORT_KERNEL_NAMES
                       if any(k in n for n in names)})
        dev_us = {e.key: e.device_time_total for e in prof.key_averages()
                  if any(k in e.key for k in PORT_KERNEL_NAMES)}
        print(f"[profiling] device_trace of one W8A8 prefill of the probe's "
              f"model: {len(names)} event names, port kernels {seen}, "
              f"device us {json.dumps(dev_us)}", flush=True)
        if not {"row_quant_int8_kernel", "w8a8_gemm_kernel",
                "rms_norm_quant_int8_kernel",
                "silu_mul_quant_int8_kernel"} <= set(seen):
            fail("[profiling] the trace names no port kernel")
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the trained-model tools and the demos

# training steps of each tool's model here (JAX's defaults: 2000 for the
# copy task's offline model, 3000 for its trajectory model, 1000 + 400 of
# distillation for the phrase teacher; PERF.md §6 has the tools at those)
TRAINED_STEPS = {"alignatt_quality": 400, "trained_e2e": 200,
                 "spec_trained_teacher": 200}
TRAINED_DISTILL = 100
TRAINED_UTTS = 4  # held-out utterances (JAX's tools: 24)
# spec_acceptance's rows card against CPU on [fidelity]'s trained Llama
# (the tool trains it with the same function and steps): (d, k, head
# vocabulary, shortlist mode, low rank)
SPEC_ACCEPT_ROWS = ((1, 4, 0, "full", 0), (2, 9, 128, "ranked", 0),
                    (1, 4, 0, "lowrank64", 64))
SPEC_ACCEPT_BEAM = (1, 2)  # (d, k) of one spec_beam_search row


def record_attention():
    """Wrap ``models.llama``'s beam_attention (the beam steps) and
    decode_attention (the tree verify's prefix) so that the first inputs
    of every (entry, B, caches, C, G, H, KV, Dh, dtype) they launch at are
    kept.  Returns (the record, a function that unwraps them)."""
    from infinisst_tpu_torch.models import llama as L

    orig = {"decode_attention": L.decode_attention,
            "beam_attention": L.beam_attention}
    seen = {}

    def keep(key, q, tensors, extra=()):
        if key not in seen and q.is_cuda:
            seen[key] = [None if t is None else t.clone()
                         for t in tensors] + list(extra)

    def rec_decode(q, k, v, valid_len, q_pos, inv_freq, key_offset=None,
                   return_lse=False):
        keep(("decode_attention", q.shape[0], k.shape[0], k.shape[1], 0,
              q.shape[1], k.shape[2], q.shape[2], str(q.dtype)[6:]), q,
             (q, k, v, valid_len, q_pos, inv_freq, key_offset), (return_lse,))
        return orig["decode_attention"](q, k, v, valid_len, q_pos, inv_freq,
                                        key_offset=key_offset,
                                        return_lse=return_lse)

    def rec_beam(q, pk, pv, plen, gk, gv, g_valid, g_off, q_pos, inv_freq):
        args = (q, pk, pv, plen, gk, gv, g_valid, g_off, q_pos, inv_freq)
        keep(("beam_attention", q.shape[0], pk.shape[0], pk.shape[1],
              gk.shape[1], q.shape[1], pk.shape[2], q.shape[2],
              str(q.dtype)[6:]), q, args)
        return orig["beam_attention"](*args)

    L.decode_attention, L.beam_attention = rec_decode, rec_beam

    def unwrap():
        L.decode_attention = orig["decode_attention"]
        L.beam_attention = orig["beam_attention"]

    return seen, unwrap


def hold_recorded_attention(seen, label):
    """beam_attention and decode_attention at every recorded shape, on the
    inputs the path gave them, against their plain versions: output and
    lse within ATT_RTOL."""
    import torch

    _, A = _kernel_modules()
    for key, args in seen.items():
        if key[0] == "beam_attention":
            got, ref = A.beam_attention(*args), A.beam_attention_plain(*args)
            pairs = list(zip(got, ref))
        else:
            got = A.decode_attention(*args[:6], key_offset=args[6],
                                     return_lse=args[7])
            ref = A.decode_attention_plain(*args)
            pairs = list(zip(got, ref)) if args[7] else [(got, ref)]
        torch.cuda.synchronize()
        rtol = ATT_RTOL["bf16" if key[-1] == "bfloat16" else "f32"]
        for n, (g, r) in enumerate(pairs):
            e = (g.float() - r.float()).abs().max().item()
            lim = (rtol if n == 0 else ATT_RTOL["f32"]) * \
                r.float().abs().max().item()
            if not (e <= lim and torch.isfinite(g).all()):
                fail(f"[{label}] {key[0]} at {key[1:]}: "
                     f"{'lse' if n else 'out'} max_abs_err {e} > {lim}")
    shapes = [dict(zip(("entry", "B", "caches", "C", "G", "H", "KV", "Dh",
                        "dtype"), k)) for k in sorted(seen)]
    print(f"[{label}] attention within ATT_RTOL of its plain versions at "
          f"the {len(seen)} shapes the path launched: {json.dumps(shapes)}",
          flush=True)


def padded_share(agent, utts):
    """Push each utterance through an AlignAtt agent; after each push,
    the share of its most-attended frames (the history trace) and of its
    winner's attended speech tokens that lie in the zero-padded audio
    bucket, past the real speech.  Returns (per-push texts, trace share,
    winner share)."""
    from infinisst_tpu_torch.tools import alignatt_quality as AQ

    texts, n_t, n_w = [], [0, 0], [0, 0]
    for ws, wav in utts:
        agent.reset()
        for j in range(len(ws)):
            prev = getattr(agent, "last_result", None)
            act = agent.push(wav[j * AQ.UNIT:(j + 1) * AQ.UNIT],
                             finished=(j == len(ws) - 1))
            texts.append(None if act is None or act.is_read()
                         else act.content)
            if getattr(agent, "last_result", None) is prev:
                continue  # no policy call on this push
            st, call = agent.states, agent.last_call
            real = len(st.source)
            n_t[0] += sum(i >= real for i in st.most_attended_indices)
            n_t[1] += len(st.most_attended_indices)
            res = agent.last_result
            real_tok = -(-(real - call["tail_start"]) // AQ.UNIT) * 12
            idx = list(res.attn_idx[: res.n_tokens])
            n_w[0] += sum(a >= real_tok for a in idx)
            n_w[1] += len(idx)
    return (texts, n_t[0] / max(n_t[1], 1), n_w[0] / max(n_w[1], 1),
            n_t, n_w)


def check_trained_tools(dev, paths, fidelity_params):
    """The trained-model tools on the card through their own ``main``s and
    flags at TRAINED_STEPS (their models trained by ``Trainer``, the
    pickles written by ``--save-params``/``--params`` read back): each
    trained model's held-out TER below its random twin's; the held-out
    utterances through each tool's agent on the card (the kernels) and on
    the CPU (the plain versions) from the same trained weights, tokens
    equal; the AlignAtt probe's share in the zero-padded bucket, push by
    push; spec_acceptance's ``run_spec``/``run_beam`` rows card against
    CPU on [fidelity]'s trained Llama; beam_attention (and any
    decode_attention) held at every shape these paths launched."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.tools import alignatt_quality as AQ
    from infinisst_tpu_torch.tools import phrase_e2e as PE
    from infinisst_tpu_torch.tools import spec_acceptance as SA
    from infinisst_tpu_torch.tools import spec_trained_teacher as ST
    from infinisst_tpu_torch.tools import trained_e2e as TE
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="trained_tools_",
                         dir=os.path.join(ROOT, "build"))
    aq_pkl, traj_pkl, ph_pkl = (os.path.join(d, f"{n}.pkl") for n in
                                ("aq", "traj", "phrase"))
    n_eval = str(TRAINED_UTTS)
    common = ["--device", dev.type, "--eval-utts", n_eval]
    try:
        seen, unwrap = record_attention()
        reset_counts()
        walls = {}
        try:
            t0 = time.perf_counter()
            r1 = AQ.main(common + [
                "--steps", str(TRAINED_STEPS["alignatt_quality"]),
                "--workdir", os.path.join(d, "aq"), "--save-params", aq_pkl])
            walls["alignatt_quality"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            r2 = TE.main(common + [
                "--steps", str(TRAINED_STEPS["trained_e2e"]),
                "--workdir", os.path.join(d, "te"),
                "--offline-params", aq_pkl, "--traj-params", traj_pkl])
            walls["trained_e2e"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            r3 = ST.main(common + [
                "--steps", str(TRAINED_STEPS["spec_trained_teacher"]),
                "--distill-steps", str(TRAINED_DISTILL),
                "--corpus-utts", "8", "--workdir", os.path.join(d, "st"),
                "--params", ph_pkl])
            walls["spec_trained_teacher"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            r4 = PE.main(common + ["--workdir", os.path.join(d, "pe"),
                                   "--params", ph_pkl])
            walls["phrase_e2e"] = time.perf_counter() - t0
        finally:
            unwrap()
        counts = launch_counts()
        paths["trained tools"] = (
            "tools.alignatt_quality, trained_e2e, spec_trained_teacher, "
            "phrase_e2e mains at " + json.dumps(TRAINED_STEPS), counts)
        walls = {k: round(v, 1) for k, v in walls.items()}
        print(f"[trained tools] walls {json.dumps(walls)} s; launches "
              f"{json.dumps(counts)}", flush=True)
        if counts["beam_attention"] <= 0:
            fail("[trained tools] beam_attention was not launched")

        # each trained model beats its random twin on held-out TER
        ter = {
            "alignatt_quality parity": (
                r1["trained"]["parity"]["ter_vs_ref"],
                r1["random_control"]["parity"]["ter_vs_ref"]),
            "alignatt_quality early_stop": (
                r1["trained"]["early_stop"]["ter_vs_ref"],
                r1["random_control"]["early_stop"]["ter_vs_ref"]),
            "trained_e2e alignatt": (
                r2["alignatt"]["trained_parity"]["ter"],
                r2["alignatt"]["random_parity"]["ter"]),
            "trained_e2e infinisst": (r2["infinisst"]["trained"]["ter"],
                                      r2["infinisst"]["random"]["ter"]),
            "phrase_e2e": (r4["phrase_task"]["trained"]["ter"],
                           r4["phrase_task"]["random"]["ter"]),
        }
        for name, (t, r) in ter.items():
            print(f"  {name:28s} held-out TER trained {t} random {r}",
                  flush=True)
            if not t < r:
                fail(f"[trained tools] {name}: trained TER {t} is not below "
                     f"the random twin's {r}")
        print(f"  alignatt_quality delta {json.dumps(r1['trained']['delta'])}"
              f"; tf acc {r1['tf_content_acc_heldout']}; monotonic "
              f"{r1['trained']['parity']['attn_monotonic_frac']}", flush=True)
        for k in ("trained", "random"):
            print(f"  trained_e2e infinisst {k}: "
                  f"{json.dumps(r2['infinisst'][k])}", flush=True)
        for row in r3["rows"]:
            print(f"  spec_trained_teacher k={row['k']} adapter="
                  f"{row['adapter']} guard={row['guard']}: accept "
                  f"{row['accept_rate']}, tokens/round "
                  f"{row['tokens_per_round']} (break-even "
                  f"{row['breakeven_tokens_per_round']}), fallbacks "
                  f"{row['guard_fallback_streams']}, exact vs plain "
                  f"{row['exact_match_vs_plain_greedy']}", flush=True)

        # card (kernels) against CPU (plain versions), same trained weights
        cfg, tok, builder, words, _, eval_utts = AQ.task(0, TRAINED_UTTS)
        erng = np.random.RandomState(4321)
        ph_utts = [ST.make_phrase_utt(tok, words, erng, k=4)
                   for _ in range(TRAINED_UTTS)]
        corpus = SA.make_corpus(np.random.RandomState(0), 8, 64)
        ranked = np.argsort(-np.bincount(
            corpus.ravel(), minlength=SA.CFG.vocab_size)).astype(np.int32)
        seen2, unwrap = record_attention()
        out = {}
        try:
            for device in ("cpu", dev):
                aqp = AQ.load_params(aq_pkl, device)
                trp = AQ.load_params(traj_pkl, device)
                php = AQ.load_params(ph_pkl, device)
                o = {}
                for early in (False, True):
                    o[f"alignatt early={early}"] = padded_share(
                        AQ.make_alignatt(aqp, cfg, builder, early, 4,
                                         device),
                        eval_utts)
                agent = TE.make_infinisst(trp, cfg, builder, 4, device)
                o["infinisst beam 4"] = [ST.stream_utt(agent, wav, len(ws))
                                         for ws, wav in eval_utts]
                spec = TE.make_infinisst(
                    php, cfg, builder, 1, device, speculative=True,
                    spec_draft_layers=1, spec_k=4, spec_guard=False)
                o["speculative d=1 k=4"] = [
                    (ST.stream_utt(spec, wav, len(steps)), spec.spec_rounds,
                     spec.spec_drafted, spec.spec_accepted)
                    for steps, wav in ph_utts]
                fp = _to(fidelity_params, device)
                rows = []
                for dd, k, hv, mode, lr in SPEC_ACCEPT_ROWS:
                    ids = ranked[:hv] if mode == "ranked" else None
                    for i in range(2):
                        p = torch.as_tensor(SA.make_corpus(
                            np.random.RandomState(100 + i), 1, 8)[0],
                            device=device)
                        rows.append(SA.run_spec(fp, p, dd, k, hv,
                                                head_ids=ids, lowrank=lr))
                p = torch.as_tensor(SA.make_corpus(
                    np.random.RandomState(100), 1, 8)[0], device=device)
                rows.append(SA.run_beam(fp, *SPEC_ACCEPT_BEAM, p))
                o["spec_acceptance rows"] = rows
                out[str(device)] = o
        finally:
            unwrap()
        for name in out["cpu"]:
            a, b = out["cpu"][name], out[str(dev)][name]
            if name.startswith("alignatt"):  # the texts; the shares: card's
                print(f"  {name}: probe in the zero-padded bucket: history "
                      f"trace {b[1]:.4f} ({b[3][0]}/{b[3][1]}), winner "
                      f"tokens {b[2]:.4f} ({b[4][0]}/{b[4][1]}); CPU "
                      f"{a[1]:.4f} / {a[2]:.4f}", flush=True)
                a, b = a[0], b[0]
            if a != b:
                fail(f"[trained tools] {name}: the card's tokens differ from "
                     f"the CPU's: cpu={a} card={b}")
            print(f"  {name}: card and CPU equal", flush=True)
        print("  spec_acceptance rows (tokens, rounds, drafted, accepted): "
              + json.dumps([r[1:] for r in out[str(dev)]
                            ["spec_acceptance rows"]]), flush=True)
        seen.update(seen2)
        hold_recorded_attention(seen, "trained tools")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def check_demos(dev, paths):
    """``examples.stream_demo`` and ``examples.serve_demo`` on the card
    for a few chunks and ticks: the final action finishes, the pool's
    beam_attention launches include a cache per slot (Bc > 1, kernel
    row 5); beam_attention held at every shape they launched."""
    from infinisst_tpu_torch.examples import serve_demo, stream_demo

    seen, unwrap = record_attention()
    reset_counts()
    try:
        if stream_demo.main(["--chunks", "3", "--device", dev.type]) != 0:
            fail("[demos] stream_demo did not finish")
        stream_counts = launch_counts()
        _, A = _kernel_modules()
        A.reset_launch_counts()
        outs = serve_demo.main(["--ticks", "3", "--device", dev.type])
        serve_shapes = dict(A.launch_shapes)
    finally:
        unwrap()
    counts = launch_counts()
    for k in ("decode_attention", "beam_attention"):
        counts[k] += stream_counts[k]
    paths["demos"] = ("examples.stream_demo --chunks 3, examples.serve_demo "
                      "--ticks 3", counts)
    print(f"[demos] launches {json.dumps(counts)}; the pool's "
          f"beam_attention by shape {json.dumps(serve_shapes)}", flush=True)
    if stream_counts["beam_attention"] <= 0 or not any(outs):
        fail("[demos] the stream demo launched no beam_attention or the "
             "pool emitted nothing")
    if not any(k.startswith("beam ") and int(k.split("Bc=")[1]) > 1
               for k in serve_shapes):
        fail("[demos] the pool launched no beam_attention over Bc > 1 "
             "caches")
    hold_recorded_attention(seen, "demos")


def train_phases(dev, paths):
    """[train flagship], [train flagship stage 2], [train graph] and [train
    tiny]: the training path, which runs no kernel of the port (run beside the
    build; the flagship's first: the card's work, where the build's
    compilers take the host's cores from [train tiny]'s CPU twin)."""
    import numpy as np

    from infinisst_tpu_torch.bench import write_train_tsv

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    train_dir = tempfile.mkdtemp(prefix="train_flagship_",
                                 dir=os.path.join(ROOT, "build"))
    try:
        write_train_tsv(train_dir, 6, 30, np.random.RandomState(0))
        with phase("train flagship"):
            check_train_flagship(dev, paths, train_dir)
        with phase("train flagship stage 2"):
            check_train_flagship_stage2(dev, train_dir)
        with phase("train graph"):
            print("[train graph] the train step as a captured program "
                  "against its uncaptured twin on the card", flush=True)
            check_train_graph_flagship(dev, train_dir)
            check_train_graph_tiny(dev)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    with phase("train tiny"):
        print("[train tiny] dryrun float32 train steps: card against CPU",
              flush=True)
        check_train_tiny(dev)


def main():
    t_start = time.perf_counter()

    # 1. device
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available; this check needs one "
              "H100", file=sys.stderr, flush=True)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[device] {card}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()}", flush=True)
    # state the float32 semantics: no TF32 in matmuls or convolutions
    # (cuDNN's default would run the tiny model's float32 convolutions in
    # TF32, and the card would then disagree with the CPU)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from infinisst_tpu_torch.kernels import _build

    # 2. build: one nvcc per source, all started together, in a thread;
    # the training phases, which launch no kernel of the port (JAX's
    # training forward calls no Pallas kernel), run beside it
    import concurrent.futures

    def timed_build():
        t0 = time.perf_counter()
        _build.load_all()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(timed_build)
        paths = {}
        train_phases(dev, paths)
        build_s = build.result()
    print(f"[build] {', '.join(_build.SOURCES)} built for sm_90a in "
          f"{build_s:.1f} s into {_build.BUILD_DIR} (beside the training "
          "phases)", flush=True)

    notes = Notes()
    with phase("kernels"):
        print("[kernels] against their plain versions on the card",
              flush=True)
        check_kernels(dev, notes)
    with phase("attention"):
        print("[attention] decode_attention and beam_attention against "
              "their plain versions on the card", flush=True)
        check_attention(dev, notes)
    with phase("spec kernels"):
        print("[spec kernels] the speculative stack's shapes: against the "
              "plain versions on the card", flush=True)
        check_spec_kernels(dev, notes)
    with phase("tiny"):
        print("[tiny] tiny speech-LLM: card against CPU", flush=True)
        tiny_params = check_tiny(dev)
    with phase("spec tiny"):
        print("[spec tiny] tiny agent, speculative and sampling modes: card "
              "against CPU", flush=True)
        check_spec_tiny(dev, tiny_params[0])
    with phase("serve tiny"):
        print("[serve tiny] tiny serving pool: card against CPU", flush=True)
        check_serve_tiny(dev, *tiny_params)
    with phase("alignatt tiny"):
        print("[alignatt tiny] tiny AlignAtt and StreamAtt agents: card "
              "against CPU", flush=True)
        check_alignatt_tiny(dev, *tiny_params)

    with phase("flagship"):
        cfg, params = check_flagship(dev, paths)
    with phase("graph"):
        check_graph(dev, cfg, params, paths)
    with phase("pool graph"):
        check_pool_graph(dev, cfg, params, paths)
    # [mesh]'s torchrun runs, in the background from here on (their
    # processes' imports take the time; their GPU work is the dryrun's)
    mesh_dir = tempfile.mkdtemp(prefix="mesh_", dir=os.path.join(ROOT,
                                                                "build"))
    mesh_runs = start_mesh_runs(mesh_dir)
    try:
        with phase("alignatt graph"):
            check_alignatt_graph(dev, cfg, params)
        with phase("sample graph"):
            check_sample_graph(dev, cfg, params)
        with phase("spec graph"):
            check_spec_graph(dev, cfg, params, paths)
        with phase("spec pool graph"):
            check_spec_pool_graph(dev, cfg, params, paths)
        with phase("spec profile"):
            check_spec_profile(dev, cfg, params)
        with phase("streamatt"):
            check_streamatt(dev, cfg, params)
        with phase("mesh"):
            check_mesh(dev, cfg, params, mesh_runs, paths)
    finally:
        stop_mesh_runs(mesh_runs)
        shutil.rmtree(mesh_dir, ignore_errors=True)
    speech = {k: params[k] for k in ("w2v2", "adapter")}
    del params
    torch.cuda.empty_cache()
    with phase("weight_only"):
        check_weight_only(dev, paths, speech)
    with phase("group128"):
        check_group128(dev, paths, speech)
    del speech
    torch.cuda.empty_cache()
    with phase("bench"):
        check_bench()
    with phase("serve"):
        check_serve(paths)
    with phase("spec bench"):
        check_spec_bench(paths)
    with phase("spec serve"):
        check_spec_serve(paths)
    with phase("alignatt"):
        check_alignatt(dev, notes, paths)
    with phase("streamatt bench"):
        check_streamatt_bench(dev, notes, paths)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cli_dir = tempfile.mkdtemp(prefix="cli_smoke_",
                               dir=os.path.join(ROOT, "build"))
    server = start_server(cli_dir)
    try:
        wavs = write_talks(cli_dir)
        with phase("cli ckpt"):
            check_cli_ckpt(cli_dir, wavs)
        with phase("cli flagship"):
            check_cli_flagship(cli_dir, wavs)
        with phase("server"):
            check_server(cli_dir, wavs, server)
        torch.cuda.empty_cache()
        with phase("train main"):
            check_train_main(cli_dir)
        with phase("train bench"):
            check_train_bench()
            profile_train_bench(dev)
    finally:
        if server[0].poll() is None:  # a phase before [server] failed
            server[0].kill()
            server[0].wait()
        shutil.rmtree(cli_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    with phase("fidelity"):
        print("[fidelity] tools.quant_fidelity on the card: int8 token "
              "flips on a trained model", flush=True)
        fidelity_params = check_fidelity(dev, notes, paths)
    with phase("distill tiny"):
        check_distill_tiny(dev, paths)
    with phase("distill graph"):
        check_distill_graph(dev)
    with phase("distill flagship"):
        check_distill_flagship(dev, paths)
    with phase("profiling"):
        check_profiling(dev, fidelity_params)
    with phase("trained tools"):
        print("[trained tools] the trained-model tools on the card: train, "
              "export, agent, eval; card against CPU", flush=True)
        check_trained_tools(dev, paths, fidelity_params)
    del fidelity_params
    with phase("demos"):
        check_demos(dev, paths)

    # 9. the kernels line
    q_src = "infinisst_tpu_torch/csrc/quant_matmul.cu"
    g_src = "infinisst_tpu_torch/csrc/grouped_matmul.cu"
    kernels = {  # name -> (source, TPU kernel replaced, reported shape)
        "row_quant_int8": (q_src, "infinisst_tpu/kernels/quant_matmul.py:106",
                           (REPORT_SHAPE[0], REPORT_SHAPE[1], 0)),
        "w8a8_gemm": (q_src, "infinisst_tpu/kernels/quant_matmul.py:94",
                      REPORT_SHAPE),
        "w8_bf16_gemm": (q_src, "infinisst_tpu/kernels/quant_matmul.py:26",
                         REPORT_SHAPE),
        "group_quant_int8": (
            g_src, "infinisst_tpu/kernels/quant_matmul.py:226",
            (REPORT_SHAPE[0], REPORT_SHAPE[1], 0)),
        # the row quantizer fused into the kernels that make its input:
        # llama._rms_norm (llama.py:47) with the residual add before it,
        # and the SwiGLU product (llama.py:174), then quantize_activation
        "rms_norm_quant_int8": (
            "infinisst_tpu_torch/csrc/norm_quant.cu",
            "infinisst_tpu/kernels/quant_matmul.py:106",
            (REPORT_SHAPE[0], NORM_D, 0)),
        "silu_mul_quant_int8": (
            "infinisst_tpu_torch/csrc/norm_quant.cu",
            "infinisst_tpu/kernels/quant_matmul.py:106",
            (REPORT_SHAPE[0], SILU_D, 0)),
        "w8a8_grouped_gemm": (
            g_src, "infinisst_tpu/kernels/quant_matmul.py:191", REPORT_SHAPE),
        # the beam step's two blocks in one launch: JAX's two einsums and
        # one softmax (llama.py:400-409), which the port ran as two
        # launches of the Pallas body's port (decode_attention.py:57)
        "beam_attention": (
            "infinisst_tpu_torch/csrc/decode_attention.cu",
            "infinisst_tpu/models/llama.py:400", BEAM_REPORT),
        # the same kernel with one block: the tree verify's prefix
        "decode_attention": (
            "infinisst_tpu_torch/csrc/decode_attention.cu",
            "infinisst_tpu/kernels/decode_attention.py:57", SPEC_ATT_SHAPE),
    }
    # decode_attention's path: the speculative beam's tree verify
    paths["decode_attention"] = paths["spec"]
    entries = []
    for name, (source, replaces, shape) in kernels.items():
        t = notes.rows[name]["shapes"][shape]
        path, counts = paths[name]
        launches = counts[name]
        if launches <= 0:
            fail(f"{name} was not launched on its path")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": notes.rows[name]["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": [x for x in shape if x != 0], "path": path,
        })
        for k in ("launch_floor_ms", "eager_ms", "quantizer_ms"):
            # the yardsticks of a latency-bound kernel: an empty kernel of
            # its geometry; for a fused one, the eager composition it
            # replaced and the quantizer alone
            if k in t:
                entries[-1][k] = t[k]
        if name == "w8a8_grouped_gemm":
            # every --group128 path shape (TABLE_M rows against each
            # projection, the grouped head, q|k|v and gate|up in one
            # launch) beside its bound and w8a8_gemm on the same bytes
            w8 = notes.rows["w8a8_gemm"]["shapes"]
            entries[-1]["path_shapes"] = [
                {"M": k[0], "D": k[1], "O": k[2], "ms": v["ms"],
                 "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                 "plain_ms": v["plain_ms"],
                 "w8a8_gemm_ms": w8[k]["ms"] if k in w8 else None}
                for k, v in notes.rows[name]["shapes"].items()
                if len(k) == 3 and k[0] in TABLE_M + MANY_M]
        if name in ("rms_norm_quant_int8", "silu_mul_quant_int8"):
            # the fused kernels' grouped form: the --group128 stream
            gt = notes.rows[name]["shapes"][("g128",) + shape]
            entries[-1]["group128"] = {
                "launches": paths["group128"][1][name],
                "path": paths["group128"][0], "gs": GROUP,
                **{k: gt[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "launch_floor_ms", "eager_ms",
                                      "quantizer_ms")}}
        # the training path runs no kernel (JAX's offline forward calls no
        # Pallas kernel): its launches, 0, checked in [train flagship]
        train_path, train_counts = paths["train"]
        entries[-1]["train"] = {"launches": train_counts.get(name, 0),
                                "path": train_path}
        # the captured chunk program: launches of one replayed chunk
        if paths["graph"][1].get(name):
            g_path, g_counts = paths["graph"]
            entries[-1]["graph"] = {"launches_a_chunk": g_counts[name],
                                    "path": g_path}
        # the captured pool: launches of one replayed tick of 8 slots
        pg_path, pg_counts, pg_shapes = paths["pool_graph"]
        if pg_counts.get(name):
            entries[-1]["pool_graph"] = {"launches_a_tick": pg_counts[name],
                                         "path": pg_path}
            if name == "beam_attention":
                entries[-1]["pool_graph"]["by_shape"] = pg_shapes
        # the captured speculative programs: launches of a replayed chunk
        # (greedy, sampling, spec beam) and of a replayed pool tick
        spec_graph = {}
        for what, keys in (("launches_a_chunk", ("spec", "spec_sample",
                                                 "spec_beam")),
                           ("launches_a_tick", ("spec", "spec_sample"))):
            prefix = "spec graph" if what.endswith("chunk") \
                else "spec pool graph"
            got = {k: paths[f"{prefix} {k}"][1].get(name, 0) for k in keys}
            if any(got.values()):
                spec_graph[what] = got
        if spec_graph:
            spec_graph["path"] = "; ".join(
                paths[k][0] for k in sorted(paths)
                if k.startswith(("spec graph ", "spec pool graph ")))
            entries[-1]["spec_graph"] = spec_graph
        # the mesh path at world size 1: the flagship agent in this
        # process, the dryrun under torchrun
        mesh_path, mesh_counts = paths["mesh"]
        entries[-1]["mesh"] = {
            "launches": {k: c.get(name, 0) for k, c in mesh_counts.items()},
            "path": mesh_path}
    # decode_attention_batched (decode_attention.py:287, body :228) on the
    # path: the serving pool's beam step, 8 prefix caches each read by its
    # slot's 4 beams, through the same kernel
    t = notes.rows["beam_attention"]["shapes"][BEAM_POOL]
    path, counts = paths["beam_attention_pool"]
    entry = next(e for e in entries if e["name"] == "beam_attention")
    entry["pool"] = {
        "replaces": "infinisst_tpu/kernels/decode_attention.py:228",
        "launches": counts["beam_attention"], "path": path,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": {"B": BEAM_POOL[1], "Bc": 8, "C": BEAM_POOL[2], "G": 10}}
    if counts["beam_attention"] <= 0:
        fail("beam_attention was not launched by the serving pool")
    # the offline paths (bench --mode alignatt and streamatt): their
    # launches, and the kernels' times at their shapes (the modal prompt
    # bucket's prefill; beam_attention at the (prompt length, cache slots)
    # with the most beam forwards)
    for mode in ("alignatt", "streamatt"):
        for e in entries:
            key = f"{mode} {e['name']}"
            if key not in paths:
                continue
            path, counts, shape = paths[key]
            t = notes.rows[e["name"]]["shapes"][shape]
            e[mode] = {
                "launches": counts[e["name"]], "path": path,
                "shape": [x for x in shape if x != 0],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
    # the speculative stack (bench --speculative, --spec-beam, --do-sample
    # and the speculative pool): its launches, and the times at its shapes
    # (a verify's gate/up, its row quantization, the tree verify's prefix)
    spec_shapes = {"w8a8_gemm": SPEC_SHAPE,
                   "row_quant_int8": (SPEC_SHAPE[0], SPEC_SHAPE[1], 0),
                   "rms_norm_quant_int8": (SPEC_SHAPE[0], NORM_D, 0),
                   "silu_mul_quant_int8": (SPEC_SHAPE[0], SILU_D, 0),
                   "decode_attention": SPEC_ATT_SHAPE,
                   "beam_attention": ("beam 1", 1, 1280)}
    for e in entries:
        shape = spec_shapes.get(e["name"])
        if shape is None:
            continue
        t = notes.rows[e["name"]]["shapes"][shape]
        for key in ("spec", "spec serve"):
            path, counts = paths[key]
            e[key.replace(" ", "_")] = {
                "launches": counts[e["name"]], "path": path,
                "shape": [x for x in shape if x != 0],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
        if paths["spec"][1][e["name"]] <= 0:
            fail(f"{e['name']} was not launched on the speculative paths")
    # the tools: launches on the fidelity probe and the two distillation
    # phases, and the times at the probe's shapes (its prefill into wq,
    # float32; beam_attention at its beam step)
    tool_shapes = {"row_quant_int8": ("tools", TOOL_SHAPE[0], TOOL_SHAPE[1],
                                      0),
                   "group_quant_int8": ("tools", TOOL_SHAPE[0],
                                        TOOL_SHAPE[1], 0),
                   "rms_norm_quant_int8": ("tools", TOOL_SHAPE[0],
                                           TOOL_SHAPE[1], 0),
                   "silu_mul_quant_int8": ("tools", TOOL_SHAPE[0],
                                           2 * TOOL_SHAPE[1], 0),
                   "beam_attention": TOOL_ATT_SHAPE}
    for e in entries:
        if e["name"] == "decode_attention":  # no tree verify on the tools
            e["tools"] = {"launches": {
                k.replace(" ", "_"): paths[k][1][e["name"]]
                for k in ("fidelity", "distill tiny", "distill flagship")}}
            continue
        shape = tool_shapes.get(e["name"], ("tools",) + TOOL_SHAPE)
        t = notes.rows[e["name"]]["shapes"][shape]
        e["tools"] = {
            "launches": {k.replace(" ", "_"): paths[k][1][e["name"]]
                         for k in ("fidelity", "distill tiny",
                                   "distill flagship")},
            "path": "; ".join(paths[k][0] for k in (
                "fidelity", "distill tiny", "distill flagship")),
            "shape": [x for x in shape[1:] if x != 0],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}
        if e["name"] == "w8a8_grouped_gemm":  # groups of 8: simple route
            t = notes.rows[e["name"]]["shapes"][("tools gs8",) + TOOL_SHAPE]
            e["tools"]["simple_route_gs8"] = {
                k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}
        if paths["fidelity"][1][e["name"]] <= 0:
            fail(f"{e['name']} was not launched on the fidelity probe")
        # the trained-model tools (float32 agents) and the demos
        for key in ("trained tools", "demos"):
            path, counts = paths[key]
            e[key.replace(" ", "_")] = {"launches": counts[e["name"]],
                                        "path": path}
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
