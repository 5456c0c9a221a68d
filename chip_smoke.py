#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``infinisst_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; no phase carries on past its own):
  1. device   -- require CUDA; print the card's name and power limit.
  2. build    -- build every kernel source (csrc/*.cu) for sm_90a, one
                 nvcc per source, all started together.
  3. kernels  -- each kernel against its plain PyTorch version on the card
                 at every main-path shape: row_quant_int8, w8a8_gemm (on
                 its K-major (O, D) weight, in bf16 and float32),
                 group_quant_int8 and w8a8_grouped_gemm (on the same
                 K-major weight; also at other group sizes, split and
                 not, GROUPED_EXTRA) bitwise, w8_bf16_gemm (on the same
                 K-major weight) within
                 W8_BF16_RTOL * max|plain| in bf16 and 1e-5 * max|plain|
                 in float32; kernel, plain and library times (median of 5
                 timed replays, with the kernel's min-max) and the bound;
                 the split-K plan both tensor-core GEMMs take beside their
                 times (one row tile at every M), the grouped GEMM's plan
                 and w8a8_gemm's time on the same bytes beside its own;
                 row_quant_int8 and group_quant_int8 beside an empty
                 kernel of their launch geometry (the launch floor).
                 The library yardsticks,
                 timed here and never called by the port: torch._int_mm
                 and the scale epilogue in PyTorch ops (M > 16 only, with
                 the kernel / library ratio) beside w8a8_gemm,
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
                 step's two blocks, at decode_attention_batched's pooled
                 shapes, at the serving pool's two blocks (its prefix:
                 8 caches, each read by its slot's 4 beams) and at an
                 AlignAtt call with 64 target ids (a prefix of 447 valid
                 in 512 slots; the per-beam block of 64 slots at key
                 offset 447, valid 1-64), output and lse within ATT_RTOL;
                 times as in phase 3, with F.scaled_dot_product_attention
                 (enable_gqa) over keys rotated beforehand as the library
                 yardstick.  Then the AlignAtt probe (llama.span_probe
                 over the 360 speech keys) from the two launches' lse
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
                 forward pass (w8a8_gemm 7L + 1, row_quant_int8 4L + 1:
                 q/k/v and gate/up share one quantized input), printed
                 beside what the wrappers did besides launching (split-K
                 calls, fills of the kernels' tile counters); then one
                 chunk with a synchronise around each stage (wall ms per
                 stage) and one under torch.profiler (device time by
                 kernel and by stage, idle share).
                 Then [multiplier]: update_multiplier(2) and (4) on the
                 same stream, one chunk at each (encoder frames +96, +192;
                 decode_attention launches = beam forwards x L x 2).
                 Then [serve profile]: the same weights in a ServingEngine
                 (pool 8, beam 4, m=1): tick walls, one tick with a
                 synchronise around each stage and one under
                 torch.profiler.
                 Then [alignatt profile]: the same weights in the bench's
                 AlignAtt agent (every call at the 28.8 s audio shape):
                 its first call (24 beam steps) timed and, on a fresh
                 agent, profiled (device time by stage: encoder,
                 adapter, prefill, beam steps); a call at 64 beam steps
                 with a synchronise around each stage.
     mesh     -- (after streamatt, on the flagship's weights) the mesh path
                 at world size 1 (one card; the multi-rank paths are held
                 on the CPU under gloo, tests/test_torch_parallel.py): in
                 this process a world-1 NCCL group, the flagship W8A8
                 agent through shard_params and tensor_parallel at (1, 1),
                 4 chunks, its target ids those of the agent without a
                 mesh after every chunk, w8a8_gemm, row_quant_int8 and
                 decode_attention launched; the sharded train step at
                 (1, 1) on the dryrun preset bitwise make_train_step's
                 (deterministic algorithms on); then under ``torchrun
                 --standalone --nproc_per_node 1`` the dryrun
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
                 that rule at least once; then decode_attention and the
                 probe held at each (prompt length, cache slots) its calls
                 ran (hold_offline_attention, untimed).
  7. weight-only -- three chunks of the 8B model with {'q_kmajor','scale'}
                 projections through w8_bf16_gemm, then one chunk under
                 torch.profiler.
  8. group128 -- three chunks of the 8B model as ``bench.py --group128``
                 makes it: grouped (128-wide) W8A8 projections, packed
                 K-major, through w8a8_grouped_gemm (group_quant_int8 4L
                 per forward), per-channel W8A8 lm_head; then one chunk
                 under torch.profiler.
  9. bench    -- ``python -m infinisst_tpu_torch.bench`` (flagship W8A8,
                 m=1, beam 4, 12 chunks, 3 untimed) in a subprocess, while
                 this process holds no 8B weights: exit 0 and its JSON line
                 with metric streaming_rtf_m1_beam4_8b_int8, re-printed.
     serve    -- ``python -m infinisst_tpu_torch.bench --mode serve``
                 (pool 8, beam 4, m=1, 12 timed ticks) in a subprocess:
                 exit 0, metric serve_decode_tok_per_s_pool8_beam4_m1_8b_int8,
                 launches decode_attention = token forwards x L x 2 (half
                 at B=32 Bc=8, the pool prefix), w8a8_gemm = forwards x
                 (7L + 1); then a mixed --multipliers 1,2 pool of 2 chunks.
     alignatt -- ``python -m infinisst_tpu_torch.bench --mode alignatt``
                 (12 chunks, 3 untimed) and ``--early-stop``: exit 0, the
                 JSON line, each chunk's wall, beam steps, prompt bucket
                 and prompt length; launches w8a8_gemm = steps x (7L + 1),
                 row_quant_int8 = steps x (4L + 1), decode_attention =
                 (steps - calls) x 2L, summed over the calls, each > 0 in
                 parity (the early stop may stop every call at its first
                 step, with no beam forward; its RTF then times a prefill
                 a call).  decode_attention (prefix of pbucket + 64 slots
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
                 torch.matmul projections, decode_attention in the beam
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
                 subprocesses; each run's launches held to its model
                 forwards (w8a8_gemm 7n + 1, row_quant_int8 4n + 1 a
                 forward of n layers, decode_attention 2n a beam step and
                 n a tree verify, none in a decode_step).
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
                 preset on the card and two ``serve.client`` processes (m=1
                 and m=2) over localhost streaming the CLI's two talks:
                 both streams finish.
 12. the training path (plain torch: JAX's training forward calls no
     Pallas kernel, so every kernel's launches there are 0):
     train tiny -- the dryrun preset in float32: stage 1, stage 2 with
                 grad_acc_steps 2 and stage 0 with cpo_beta 0.5, 4 steps
                 each of make_train_step on the same batches on the card
                 and on the CPU: per-step loss and grad norm within
                 TINY_RTOL, the parameters after the last step within the
                 CPU test's tolerance, frozen leaves bitwise unchanged.
     train flagship -- Trainer.fit on the flagship preset in bfloat16,
                 stage 1, remat, encoder dropout 0.1, over synthetic TSV
                 + wav rows of 28.8 s under build/ (two rows a batch,
                 collator 4 at m = 1), 3 steps: finite losses, every LLM
                 leaf bitwise unchanged, w2v2 and adapter moved, no kernel
                 launched; step walls, peak memory, the final save's size
                 and wall (after checking the free space); then a second
                 Trainer with max_steps=4 restores step 3 and takes one
                 step.  The run directory is removed.
     train flagship stage 2 -- Trainer.fit on the same rows at stage 2
                 (the adapter and the 8B LLM trained, the encoder frozen),
                 bfloat16, remat, 3 steps, no checkpoint: finite losses,
                 every w2v2 leaf bitwise unchanged, the adapter and every
                 LLM matrix moved, no kernel launched; the step walls, the
                 peak memory and the bytes of the parameters, gradients
                 and AdamW moments, counted from the leaves.
     train main -- ``python -m infinisst_tpu_torch.train.main
                 --model_preset dryrun --max_steps 3`` on the card in a
                 subprocess: metrics.jsonl and the checkpoint.
     train bench -- ``python -m infinisst_tpu_torch.bench --mode train``
                 and ``--mode train-io`` in subprocesses: their JSON lines
                 (bench.py's keys), values finite and positive; then the
                 bench's step in this process: synced walls, the host's
                 dispatch time, one step under the profiler.
 13. the tools:
     fidelity -- ``tools.quant_fidelity.main --steps 600`` in this process:
                 the probe's Llama (D=256, L=4, V=512) trained on the card,
                 every variant's flip rates, greedy divergence and beam-4
                 winner changes beside docs/quant_fidelity.json (the JAX
                 tool's); each variant's kernels launched (w8:
                 w8_bf16_gemm; w8a8: row_quant_int8 + w8a8_gemm; grouped:
                 group_quant_int8 + w8a8_grouped_gemm; decode_attention in
                 every beam step), the two groups-of-8 variants refused by
                 w8a8_grouped_gemm and not run; then every int8 kernel
                 bitwise against its plain version on the trained weights
                 at the prefill's 512 rows and a beam step's 4
                 (w8_bf16_gemm within 1e-5), timed at the prefill's shape,
                 and decode_attention at the beam step's two blocks.
     distill tiny -- the probe's Llama trained 150 steps on the 64 x 64
                 corpus, 8 prompts rolled out, an adapter distilled at
                 d = 1; speculative greedy with and without it in float32
                 and W8A8: KL and agreement, tokens unchanged, float32
                 acceptance doubled, w8a8_gemm launched.
     distill flagship -- ``python -m infinisst_tpu_torch.tools.
                 distill_adapter --model-preset flagship`` (8B float32,
                 rank 2048, d = 8, 20 steps) in a subprocess: the KL falls,
                 the .npz loads at d = 8 only; then the flagship W8A8
                 agent, speculative d = 8 with the guard off, 4 chunks with
                 and without the adapter: the same tokens, the int8
                 kernels launched, both acceptance rates.
     profiling -- ``core.profiling``: timed and StepTimer around w8a8_gemm
                 with ``sync_on``, device_trace over one W8A8 prefill of
                 the probe's model (the Chrome trace names the kernels).
 14. one JSON ``kernels`` line (the speculative paths' launches and times
     under ``spec`` and ``spec_serve`` of w8a8_gemm, row_quant_int8 and
     decode_attention; the training path's launches, 0, under
     ``train``; the mesh path's, by the agent and the dryrun, under
     ``mesh``; the tools' launches by phase and the times at the
     probe's shapes under ``tools``), then the card line, then the
     result line.

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
TIMED_TRIALS = 5


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


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def plan_line(K, M, D, O, sms):
    """Print and return the split-K plan both tensor-core GEMMs take."""
    plan = K.gemm_plan(M, D, O, sms)
    print(f"  {'':17s} plan: {plan.rows} rows a tile x {plan.n_mtiles} row "
          f"tile(s), {plan.n_split} split(s) of {plan.k_split} values of D, "
          f"{plan.n_mtiles * plan.n_otiles * plan.n_split} blocks",
          flush=True)
    return plan


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
                 (79, 4096, 1024, 64), (1, 3072, 512, 96), (61, 768, 256, 96)]


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
            lib = None
            if M > 16:  # torch._int_mm's shape rule; then the scale epilogue
                lib = cuda_time_ms(
                    lambda i: (torch._int_mm(yq, ws[i % n_w]).float() * ys
                               * s).to(torch.bfloat16), 20
                )
            bms, by = bound_ms(M * D + M * 4 + D * O + O * 4 + M * O * 2,
                               2.0 * M * D * O, INT8_OPS_PER_S)
            note("w8a8_gemm", (M, D, O), 0.0, ms, pms, lib, bms, by)
            plan = plan_line(K, M, D, O, sms)
            if lib is not None:
                print(f"  {'':17s} kernel / (torch._int_mm + epilogue) "
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
            print(f"  {'':17s} the same plan as w8a8_gemm; kernel / "
                  f"_weight_int8pack_mm "
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
            gp = K.grouped_gemm_plan(M, D, O, G, sms)
            print(f"  {'':17s} plan: {gp.rows} rows x {gp.tile_o} channels "
                  f"a tile, {gp.n_split} split(s) of {gp.k_split // GROUP} "
                  f"groups, {gp.n_mtiles * gp.n_otiles * gp.n_split} blocks; "
                  f"w8a8_gemm on the same bytes {w8_ms:.5f} ms (grouped / "
                  f"w8a8_gemm {statistics.median(ms) / w8_ms:.3f})",
                  flush=True)
        del ws, wts
        torch.cuda.empty_cache()

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
    # other group sizes (whole 32-byte MMA runs: 32, 64, and 96, whose
    # groups straddle the 128-byte stages), ragged O and M, split and not
    for M, D, O, gs in GROUPED_EXTRA:
        w = torch.randint(-127, 128, (O, D), generator=gen, device=dev,
                          dtype=torch.int8)
        sg = torch.rand((D // gs, O), generator=gen, device=dev) * 1e-3
        for dt in (torch.bfloat16, torch.float32):
            y = (torch.randn((M, D), generator=gen, device=dev) * 2.0).to(dt)
            check_grouped(K, y, w, sg, gs, f"M={M} D={D} O={O} gs={gs} {dt}",
                          {dt, torch.float32})
    print("  float32 inputs: all five matmul kernels agree with their plain "
          "versions (w8_bf16_gemm at every shape above)", flush=True)


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


# per forward by function: decode_attention launches a layer (the beam
# step's two blocks, the tree verify's prefix; a decode_step attends in
# plain torch)
ATT_PER_LAYER = {"decode_step": 0, "beam_token_step": 2, "beam_tree_step": 1}


def expected_launches(forwards) -> dict:
    """The kernel launches the bench's model forwards ({"fn L=n": count})
    must make at the flagship W8A8 with an int8 (full or shortlist) head:
    7n + 1 w8a8_gemm and 4n + 1 row_quant_int8 a forward of n layers,
    decode_attention by ATT_PER_LAYER, no other kernel."""
    want = dict.fromkeys(("w8a8_gemm", "row_quant_int8", "decode_attention",
                          "w8_bf16_gemm", "group_quant_int8",
                          "w8a8_grouped_gemm"), 0)
    for key, n in forwards.items():
        fn, L = key.split(" L=")
        L = int(L)
        want["w8a8_gemm"] += n * (7 * L + 1)
        want["row_quant_int8"] += n * (4 * L + 1)
        want["decode_attention"] += n * L * ATT_PER_LAYER[fn]
    return want


def run_bench_line(extra, label, metric, keys):
    """``python -m infinisst_tpu_torch.bench`` + ``extra`` in a subprocess:
    exit 0, its last stdout line a JSON line with ``metric`` and
    ``keys``, its launches those its model forwards make
    (expected_launches).  Returns (result, launches, forwards)."""
    cmd = [sys.executable, "-m", "infinisst_tpu_torch.bench"] + extra
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    for line in out.stderr.strip().splitlines()[-8:]:
        print(f"[{label}]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[{label}] {' '.join(cmd[1:])} exited {out.returncode}")
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
    print(f"[{label}] forwards {fwd}: launches {got} (7n + 1 w8a8_gemm, "
          "4n + 1 row_quant_int8 a forward of n layers)", flush=True)
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
POOL_PREFIX = ("pool prefix", 32, 1280)  # its Notes shape key


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


def check_attention(dev, notes):
    import torch

    from infinisst_tpu_torch.core.presets import flagship_config

    gen = torch.Generator(device=dev).manual_seed(2)
    for case in _att_cases():
        att_case(dev, gen, notes, *case, dtype=torch.bfloat16, timed=True)
    # float32 (the tiny model's and the tests' dtype), the beam step's,
    # the pool's and AlignAtt's blocks
    for case in _att_cases()[:6]:
        att_case(dev, gen, notes, *case, dtype=torch.float32, timed=False)
    a0, a1 = alignatt_span(flagship_config(), 360)
    check_probe(dev, "alignatt 64-target", 512, 447, a0, a1, (0, 20, 63))
    print("  library_ms: F.scaled_dot_product_attention(enable_gqa=True) over "
          "keys rotated beforehand -- it leaves out the rotation the kernel "
          "does", flush=True)


def alignatt_span(cfg, n_speech):
    """(a0, a1): the speech span of the flagship's offline prompt (the stub
    tokenizer) over ``n_speech`` speech tokens, the probe's keys."""
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    b = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    start = b.offline_prompt(n_speech, []).patch_start
    return start, start + n_speech


def check_probe(dev, label, cap, plen, a0, a1, gen_lens):
    """The AlignAtt probe of a beam step (bf16, the flagship's heads, 4
    beams): ``span_probe`` over the speech keys a0..a1-1 from the kernels'
    log-sum-exps (the prefix, ``plen`` valid of ``cap`` slots, and the
    per-beam block of 64 slots at key offset ``plen``, two launches)
    equals the probe from the plain version's, at each generation length
    of ``gen_lens``."""
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
        for kind, fn in (("kernel", A.decode_attention),
                         ("plain", A.decode_attention_plain)):
            _, lp = fn(q, pk, pv, pl, qp, inv, None, True)
            _, lg = fn(q, gk, gv, gvl, qp, inv, off, True)
            probes[kind] = L.span_probe(q, pk, a0, a1, qp, inv,
                                        torch.logaddexp(lp, lg)).tolist()
        if probes["kernel"] != probes["plain"]:
            fail(f"the {label} probe (span {a0}..{a1}, {plen} valid of "
                 f"{cap}) from decode_attention's lse differs from the "
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
    """decode_attention at the shapes the offline calls ``calls`` ran: for
    each (prompt bucket, prompt length) with a beam forward, the prefix
    (4 beams over one cache of pbucket + G slots, prompt length valid)
    and the per-beam block (G slots at key offset prompt length, valid
    1..steps - 1), output and lse within ATT_RTOL, and the probe over the
    call's speech span at gen_len 0, the middle and the last; with
    ``timed``, the shape with the most beam forwards timed into ``notes``.
    Returns that shape's (prefix, per-beam) Notes keys, or None when no
    call ran a beam forward.  ``where`` names the phase in the printout
    (default ``label``)."""
    import torch

    from infinisst_tpu_torch.core.presets import flagship_config

    gen = torch.Generator(device=dev).manual_seed(11)
    G = DECODE_BUF_TOKENS
    cfg = flagship_config()
    shapes = offline_shapes(calls)
    run = {k: v for k, v in shapes.items() if v[0] > 1}
    where = where or label
    if not run:
        print(f"[{where}] no call ran a beam forward: no decode_attention "
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
        att_case(dev, gen, notes, f"{tag} prefix", 4, 1, cap, [plen], None,
                 True, torch.bfloat16, is_top, q_pos=plen + last)
        att_case(dev, gen, notes, f"{tag} per-beam", 4, 4, G, spread,
                 [plen] * 4, True, torch.bfloat16, is_top,
                 q_pos=plen + last)
        a0, a1 = alignatt_span(cfg, 12 * units)
        check_probe(dev, tag, cap, plen, a0, a1,
                    sorted({0, last // 2, last}))
    print(f"[{where}] decode_attention held at the {len(run)} (prompt "
          f"length, cache slots) pairs its calls ran: "
          f"{[(k[1], k[0] + G) for k in sorted(run)]}"
          + (f"; timed at {top[1]} valid of {top[0] + G}" if timed else ""),
          flush=True)
    tag = f"{label} {top[1]}/{top[0] + G}"
    return ((f"{tag} prefix", 4, top[0] + G), (f"{tag} per-beam", 4, G))


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


def _tiny_pool(dev, params):
    """The tiny pool on the CPU and on the card: an m=1 and an m=2 slot,
    slot 0 switched to m=2 at tick 3, six ticks of one 960 ms unit each
    (the last finishes both streams).  Returns one record a tick, (the
    slots that ticked, {device: (tokens, valid_len, evictions)}, {device:
    the prefill's last logits}), and the two engines."""
    import numpy as np

    from infinisst_tpu_torch.decode import beam as beam_mod

    engines = {d: tiny_engine(d, params) for d in ("cpu", dev)}
    for e in engines.values():
        e.open_stream("a", multiplier=1)
        e.open_stream("b", multiplier=2)
    rng = np.random.RandomState(7)
    unit = engines["cpu"].stream.chunk_samples(1)
    search = beam_mod.batched_beam_search
    records = []
    for t in range(6):
        audio = [rng.randn(unit).astype(np.float32) * 0.1 for _ in range(2)]
        state, last = {}, {}
        for d, e in engines.items():
            if t == 3:
                e.update_multiplier(0, 2)
            for slot in (0, 1):
                e.push_audio(slot, audio[slot], finished=(t == 5))

            def recorded(p, c, dec, logits, *a, _d=d, **kw):
                last[_d] = logits.float().cpu()
                return search(p, c, dec, logits, *a, **kw)

            beam_mod.batched_beam_search = recorded
            try:
                e.tick()
            finally:
                beam_mod.batched_beam_search = search
            state[d] = ([list(s.target_ids) for s in e.slots],
                        e.valid_len_host.tolist(), e.evictions)
        records.append((engines[dev].last_ticked, state, last))
    return records, engines


def check_serve_tiny(dev, f32_params, w8a8_params):
    """The tiny float32 pool (the weights of check_tiny) on the card
    against the CPU through a trim: every slot's tokens and the host
    mirrors equal after every tick.  Then the W8A8 pool the same way,
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
          f"{counts}, decode_attention by shape "
          f"{dict(_kernel_modules()[1].launch_shapes)}", flush=True)
    if not (card.evictions and all(s.done for s in card.slots)):
        fail("[serve tiny] the streams did not trim and finish")
    if _kernel_modules()[1].launch_shapes.get("B=4 Bc=2", 0) <= 0:
        fail("[serve tiny] the pool prefix did not launch decode_attention")
    differ = None
    for t, (_, state, last) in enumerate(_tiny_pool(dev, w8a8_params)[0]):
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
    if counts["decode_attention"] <= 0:
        fail("[alignatt tiny] the beam step did not launch decode_attention")
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
        _sync(dev)
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        _sync(dev)
        dt = time.perf_counter() - t0
        res = agent.last_result
        n_fwd = res.steps  # 1 prefill + (steps - 1) beam forwards
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


# (module, function) of each stage of the chunk step, in the order the
# step runs them; beam_token_step runs inside beam_search
STAGES = (
    ("infinisst_tpu_torch.models.llama", "evict_cache"),
    ("infinisst_tpu_torch.models.speech_llm", "encode_chunk"),
    ("infinisst_tpu_torch.models.speech_llm", "splice_speech"),
    ("infinisst_tpu_torch.models.llama", "decode_step"),
    ("infinisst_tpu_torch.decode.beam", "beam_search"),
    ("infinisst_tpu_torch.models.llama", "beam_token_step"),
)


# the serving engine's tick (serve/engine.py); beam_token_step runs inside
# batched_beam_search
SERVE_STAGES = (
    ("infinisst_tpu_torch.models.llama", "evict_cache"),
    ("infinisst_tpu_torch.models.speech_llm", "encode_chunk"),
    ("infinisst_tpu_torch.models.llama", "decode_step"),
    ("infinisst_tpu_torch.decode.beam", "batched_beam_search"),
    ("infinisst_tpu_torch.models.llama", "beam_token_step"),
)


# the AlignAtt call (agents/alignatt.py); beam_token_step runs inside
# beam_search.  A third element labels a stage whose function name is
# another stage's.
ALIGNATT_STAGES = (
    ("infinisst_tpu_torch.models.wav2vec2", "forward", "encoder"),
    ("infinisst_tpu_torch.models.adapter", "forward", "adapter"),
    ("infinisst_tpu_torch.models.llama", "decode_step", "prefill"),
    ("infinisst_tpu_torch.decode.beam", "beam_search"),
    ("infinisst_tpu_torch.models.llama", "beam_token_step"),
)


def stage_label(stage) -> str:
    return stage[2] if len(stage) > 2 else stage[1]


@contextlib.contextmanager
def wrapped_stages(wrap, stages=STAGES):
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

    with wrapped_stages(wrap, stages):
        _sync(dev)
        t0 = time.perf_counter()
        step()
        _sync(dev)
        wall = time.perf_counter() - t0
    return spent, wall


def stage_chunk(dev, r):
    """One more chunk with a synchronise before and after each stage: the
    wall time of each stage, host and device together."""
    audio = _next_audio(r)
    spent, wall = timed_stages(
        dev, lambda: r["agent"].push(audio, finished=False), STAGES)
    print(f"[stages] one chunk with a synchronise around each stage: wall "
          f"{wall * 1e3:.2f} ms", flush=True)
    for stage in STAGES:
        name = stage_label(stage)
        n, t = spent.get(name, (0, 0.0))
        print(f"[stages]   {name:16s} calls {n:2d}  {t * 1e3:9.2f} ms",
              flush=True)
    beam = spent.get("beam_search", (0, 0.0))[1]
    steps = spent.get("beam_token_step", (0, 0.0))[1]
    top = sum(t for name, (n, t) in spent.items() if name != "beam_token_step")
    print(f"[stages]   beam_search outside beam_token_step (log-softmax, "
          f"processors, top-2B, bookkeeping): {(beam - steps) * 1e3:.2f} ms; "
          f"outside every stage: {(wall - top) * 1e3:.2f} ms", flush=True)


def profile_chunk(dev, r, label="profile"):
    """One more chunk under torch.profiler: wall time, device kernel time
    by kernel name and by stage, and the device's idle share, both against
    the profiled wall and against the median unprofiled chunk wall; each
    line starts with ``[label]``."""
    audio = _next_audio(r)
    med = sorted(r["times"][1:])[(len(r["times"]) - 1) // 2] * 1e3
    profile_run(dev, lambda: r["agent"].push(audio, finished=False), STAGES,
                label, med, "chunk")


def profile_run(dev, step, stages, label, med, what):
    """``step()`` under torch.profiler, as ``profile_chunk`` describes;
    ``med`` is the median unprofiled wall (ms) of such a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def wrap(name, fn):
        def ranged(*args, **kw):
            with record_function(f"stage::{name}"):
                return fn(*args, **kw)
        return ranged

    _sync(dev)
    with wrapped_stages(wrap, stages), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        _sync(dev)
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
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
    groups = {"w8a8_grouped_gemm": 0.0, "group_quant_int8": 0.0,
              "w8a8_gemm": 0.0, "row_quant_int8": 0.0, "w8_bf16_gemm": 0.0,
              "decode_attention": 0.0, "other": 0.0}
    for k, t in by_name.items():
        g = next((g for g in groups if g in k), "other")
        groups[g] += t
    print(f"[{label}] device ms by kernel group: "
          f"{ {k: round(v, 3) for k, v in groups.items()} }", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for k, t in top:
        print(f"[{label}]   {t:9.3f} ms  {k[:90]}", flush=True)


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
    # one GEMM per projection and the head; one row quantization per
    # distinct input (q/k/v share one, gate/up another)
    per_fwd = {"w8a8_gemm": 7 * L + 1, "row_quant_int8": 4 * L + 1}
    for name, n in per_fwd.items():
        if r["counts"][name] != r["forwards"] * n:
            fail(f"[flagship] {name} launched {r['counts'][name]} times, "
                 f"expected {r['forwards']} forwards x {n}")
    # each beam forward launches decode_attention twice per layer: the
    # shared prefix block and the per-beam block, merged by their lse
    beam_fwd = r["forwards"] - r["chunks"]
    if r["counts"]["decode_attention"] != beam_fwd * L * 2:
        fail(f"[flagship] decode_attention launched "
             f"{r['counts']['decode_attention']} times, expected "
             f"{beam_fwd} beam forwards x {L} layers x 2 blocks")
    unused = ("w8_bf16_gemm", "group_quant_int8", "w8a8_grouped_gemm")
    if any(r["counts"][k] for k in unused):
        fail(f"[flagship] {unused} ran on the per-channel W8A8 path")
    # chunk 0 carries one-time set-up (cuBLAS handles, allocator)
    rtf = sorted(t / r["chunk_sec"] for t in r["times"][1:])
    n = len(rtf)
    print(f"[flagship] chunks {r['chunks']} (ring wrap after 12, first "
          f"eviction decided after chunk {r['evicted_at']}); forwards "
          f"{r['forwards']} ({beam_fwd} beam forwards); launches "
          f"{r['counts']} = forwards x {per_fwd['w8a8_gemm']} w8a8_gemm, "
          f"forwards x {per_fwd['row_quant_int8']} row_quant_int8 (one per "
          f"shared input) and beam forwards x {L} layers x 2 "
          f"decode_attention launches (the prefix block and the per-beam "
          f"block, two launches per layer)", flush=True)
    print(f"[flagship] RTF over chunks 1..{n} (bring-up reading, not a "
          f"benchmark): median {rtf[n // 2]:.4f}, "
          f"{100 * (n - 10) // n}th percentile {rtf[n - 11]:.4f} "
          f"(10 chunks above it), mean {sum(rtf) / n:.4f}, min "
          f"{rtf[0]:.4f}, max {rtf[-1]:.4f}; chunk 0 "
          f"{r['times'][0] / r['chunk_sec']:.4f}", flush=True)
    for name in ("w8a8_gemm", "row_quant_int8", "decode_attention"):
        paths[name] = ("flagship W8A8 stream", r["counts"])
    stage_chunk(dev, r)
    profile_chunk(dev, r)
    check_multiplier(dev, r)
    del r
    torch.cuda.empty_cache()
    check_serve_profile(dev, cfg, params)
    check_alignatt_profile(dev, cfg, params)
    return cfg, params


def check_alignatt_profile(dev, cfg, params):
    """The flagship W8A8 weights in the bench's AlignAtt agent: its first
    call (one 960 ms chunk padded to the 28.8 s cap shape, 24 beam steps),
    then the same call on a fresh agent under torch.profiler (device time
    by stage: encoder, adapter, prefill, beam steps); then a call over
    28.8 s of audio and one more chunk with a synchronise around each
    stage (64 beam steps, the parity mode's steady state)."""
    import numpy as np
    import torch

    from infinisst_tpu_torch import bench

    first = np.random.RandomState(3).randn(
        15360).astype(np.float32) * 0.1

    def describe(agent, wall, what):
        c, res = agent.last_call, agent.last_result
        print(f"[alignatt profile] {what} over {len(agent.states.source)} "
              f"samples: {wall * 1e3:.2f} ms, {res.steps} beam steps "
              f"(max_steps {c['max_steps']}), audio units {c['n_units']}, "
              f"prompt {c['prompt_len']} in a bucket of "
              f"{c['prompt_bucket']}", flush=True)

    def timed_push(agent, audio):
        _sync(dev)
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        _sync(dev)
        return time.perf_counter() - t0

    agent = bench.offline_agent("alignatt", False, cfg, params, dev)
    wall = timed_push(agent, first)
    describe(agent, wall, "first call")
    fresh = bench.offline_agent("alignatt", False, cfg, params, dev)
    profile_run(dev, lambda: fresh.push(first, finished=False),
                ALIGNATT_STAGES, "alignatt profile", wall * 1e3,
                "first call")
    describe(fresh, wall, "the profiled call (its unprofiled twin's wall)")
    del fresh
    rng = np.random.RandomState(4)
    wall = timed_push(agent, rng.randn(29 * 15360).astype(np.float32) * 0.1)
    describe(agent, wall, "call")
    spent, wall = timed_stages(
        dev, lambda: agent.push(rng.randn(15360).astype(np.float32) * 0.1,
                                finished=False), ALIGNATT_STAGES)
    steps = agent.last_result.steps
    print(f"[alignatt stages] one call with a synchronise around each "
          f"stage: wall {wall * 1e3:.2f} ms, {steps} beam steps", flush=True)
    for stage in ALIGNATT_STAGES:
        name = stage_label(stage)
        n, t = spent.get(name, (0, 0.0))
        print(f"[alignatt stages]   {name:16s} calls {n:2d}  "
              f"{t * 1e3:9.2f} ms", flush=True)
    beam = spent.get("beam_search", (0, 0.0))[1]
    tok = spent.get("beam_token_step", (0, 0.0))
    print(f"[alignatt stages]   beam_search outside beam_token_step "
          f"{(beam - tok[1]) * 1e3:.2f} ms; "
          f"{tok[1] / max(tok[0], 1) * 1e3:.2f} ms a beam step", flush=True)
    del agent
    torch.cuda.empty_cache()


def check_serve_profile(dev, cfg, params):
    """The flagship W8A8 weights in a ServingEngine (pool 8, beam 4, m=1,
    the bench's serve defaults): five ticks of one chunk of seeded noise
    per slot (tick wall, forwards, tokens), one tick with a synchronise
    around each stage, one under torch.profiler, and the trim alone: one
    evict_cache over the whole pool cache, timed with CUDA events."""
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
    spent, wall = timed_stages(dev, tick, SERVE_STAGES)
    print(f"[serve stages] one tick with a synchronise around each stage: "
          f"wall {wall * 1e3:.2f} ms (median unsynchronised tick {med:.2f} "
          f"ms)", flush=True)
    for _, name in SERVE_STAGES:
        n, t = spent.get(name, (0, 0.0))
        print(f"[serve stages]   {name:19s} calls {n:2d}  {t * 1e3:9.2f} ms",
              flush=True)
    beam = spent.get("batched_beam_search", (0, 0.0))[1]
    steps = spent.get("beam_token_step", (0, 0.0))[1]
    print(f"[serve stages]   batched_beam_search outside beam_token_step "
          f"(log-softmax, processors, top-2B, bookkeeping): "
          f"{(beam - steps) * 1e3:.2f} ms", flush=True)
    profile_run(dev, tick, SERVE_STAGES, "serve profile", med, "tick")
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


def check_weight_only(dev, paths, speech):
    import torch

    from infinisst_tpu_torch.bench import flagship_params

    print("[weight_only] 8B {'q_kmajor','scale'} projections", flush=True)
    cfg, params = flagship_params(dev, act_int8=False, speech=speech)
    r = stream_8b(dev, cfg, params, min_chunks=3, max_chunks=3,
                  need_evict=False, label="w8")
    want = r["forwards"] * 7 * r["n_layers"]
    c = r["counts"]
    if not (c["w8_bf16_gemm"] == want
            and c["w8a8_gemm"] == c["row_quant_int8"] == r["forwards"]):
        fail(f"[weight_only] launches {c}, expected w8_bf16_gemm {want} "
             f"and the W8A8 head {r['forwards']}")
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
    r = stream_8b(dev, cfg, params, min_chunks=3, max_chunks=3,
                  need_evict=False, label="g128")
    L, c = r["n_layers"], r["counts"]
    if not (c["w8a8_grouped_gemm"] == r["forwards"] * 7 * L
            and c["group_quant_int8"] == r["forwards"] * 4 * L
            and c["w8a8_gemm"] == c["row_quant_int8"] == r["forwards"]
            and c["w8_bf16_gemm"] == 0):
        fail(f"[group128] launches {c}, expected w8a8_grouped_gemm "
             f"forwards x {7 * L}, group_quant_int8 forwards x {4 * L} (one "
             f"per shared input) and the per-channel head {r['forwards']}")
    rtf = [t / r["chunk_sec"] for t in r["times"][1:]]
    print(f"[group128] chunks {r['chunks']}; forwards {r['forwards']}; "
          f"launches {c}; RTF chunks 1..: {[round(x, 4) for x in rtf]} "
          "(bring-up reading)", flush=True)
    for name in ("w8a8_grouped_gemm", "group_quant_int8"):
        paths[name] = ("group128 stream", c)
    profile_chunk(dev, r, label="g128 profile")
    del params, r
    torch.cuda.empty_cache()


def check_multiplier(dev, r):
    """On the flagship stream: update_multiplier(2), then (4), one chunk
    at each.  The encoder takes 96, then 192 frames; decode_attention is
    launched twice per layer per beam forward, the GEMMs 7L + 1 times a
    forward."""
    import numpy as np

    agent = r["agent"]
    L = r["n_layers"]
    for m in (2, 4):
        agent.update_multiplier(m)
        frames = int(agent.enc_state.n_frames[0])
        audio = r["rng"].randn(agent.chunk_samples).astype(np.float32) * 0.1
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        _sync(dev)
        dt = time.perf_counter() - t0
        counts = launch_counts()
        steps = agent.last_result.steps  # 1 prefill + steps - 1 beam forwards
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
        if counts["decode_attention"] != (steps - 1) * L * 2:
            fail(f"[multiplier] m={m}: decode_attention launched "
                 f"{counts['decode_attention']} times, expected "
                 f"{steps - 1} beam forwards x {L} layers x 2")
        if counts["w8a8_gemm"] != steps * (7 * L + 1):
            fail(f"[multiplier] m={m}: w8a8_gemm launched "
                 f"{counts['w8a8_gemm']} times, expected {steps} forwards "
                 f"x {7 * L + 1}")


def check_bench():
    """``python -m infinisst_tpu_torch.bench`` with its defaults, in a
    subprocess: exit 0, and its last stdout line is the JSON line of
    bench.py with metric streaming_rtf_m1_beam4_8b_int8 over 9 timed
    chunks."""
    cmd = [sys.executable, "-m", "infinisst_tpu_torch.bench"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    for line in out.stderr.strip().splitlines()[-16:]:
        print(f"[bench]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[bench] {' '.join(cmd[1:])} exited {out.returncode}")
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
            "w8a8_gemm", "row_quant_int8", "decode_attention")):
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
    """``python -m infinisst_tpu_torch.bench --mode serve`` + ``extra`` in
    a subprocess: exit 0, its last stdout line the serve JSON line with
    ``metric``, and its launches on stderr those of the forwards it ran:
    decode_attention token forwards x L x 2 (the prefix at B=32 Bc=8 and
    the per-beam block at B=32 Bc=32, L each), w8a8_gemm and
    row_quant_int8 (7L + 1) and (4L + 1) a forward, no other kernel.
    Returns (result, launches, launches by shape, forwards)."""
    cmd = [sys.executable, "-m", "infinisst_tpu_torch.bench", "--mode",
           "serve"] + extra
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    for line in out.stderr.strip().splitlines()[-24:]:
        print(f"[serve]   {line}", flush=True)
    if out.returncode != 0:
        fail(f"[serve] {' '.join(cmd[1:])} exited {out.returncode}")
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
    shapes = _stderr_json(out.stderr, "decode_attention launches by shape ")
    fwd = _stderr_json(out.stderr, "engine forwards ")
    if counts is None or shapes is None or fwd is None:
        fail("[serve] the bench did not report its launches and forwards")
    tok, total = fwd["token"], fwd["prefill"] + fwd["token"]
    L = n_layers
    want = {"decode_attention": tok * L * 2, "w8a8_gemm": total * (7 * L + 1),
            "row_quant_int8": total * (4 * L + 1), "w8_bf16_gemm": 0,
            "group_quant_int8": 0, "w8a8_grouped_gemm": 0}
    got = {k: counts.get(k, 0) for k in want}
    want_shapes = {"B=32 Bc=8": tok * L, "B=32 Bc=32": tok * L}
    if got != want or shapes != want_shapes or tok <= 0:
        fail(f"[serve] launches {got} by shape {shapes} for forwards {fwd}; "
             f"expected {want} and {want_shapes}")
    print(f"[serve] {json.dumps(result)}", flush=True)
    print(f"[serve] forwards {fwd}: launches {got}, decode_attention by "
          f"shape {shapes} (the pool prefix at B=32 Bc=8: 8 caches, each "
          "read by its slot's 4 beams)", flush=True)
    return result, counts, shapes, fwd


def check_serve(paths):
    """The port bench's serve mode at its defaults (pool 8, beam 4, m=1,
    12 timed ticks), then a mixed (1, 2) pool of 2 chunks; row 5's path
    is the first run's pool prefix."""
    _, counts, shapes, _ = run_serve_bench([], SERVE_METRIC)
    paths["decode_attention_pool"] = ("serve bench (pool 8, beam 4)", {
        "decode_attention": shapes["B=32 Bc=8"]})
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
    runs one prefill and steps - 1 beam forwards, so w8a8_gemm (7L + 1)
    and row_quant_int8 (4L + 1) a forward, decode_attention 2L a beam
    forward, and no other kernel; each of the three launched unless
    ``beam_forwards`` is false (calls may then all stop at their first
    step).  Every prompt bucket (the prefill's rows) must be among the
    rows [kernels] held.  Returns the launches."""
    L = n_layers
    steps = sum(c[1] for c in calls)
    want = {"w8a8_gemm": steps * (7 * L + 1),
            "row_quant_int8": steps * (4 * L + 1),
            "decode_attention": (steps - len(calls)) * L * 2,
            "w8_bf16_gemm": 0, "group_quant_int8": 0,
            "w8a8_grouped_gemm": 0}
    got = {k: counts.get(k, 0) for k in want}
    launched = ("w8a8_gemm", "row_quant_int8") + (
        ("decode_attention",) if beam_forwards else ())
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
          f"{7 * L + 1}, steps x {4 * L + 1} and (steps - calls) x {2 * L}",
          flush=True)
    return got


def run_offline_bench(extra, metric, label, beam_forwards=True):
    """``python -m infinisst_tpu_torch.bench`` + ``extra`` (an offline
    mode) in a subprocess: exit 0, its last stdout line the JSON line with
    ``metric``, each chunk's wall, beam steps and prompt bucket re-printed,
    and its launches those of the forwards its calls ran
    (``check_offline_launches``).  Returns (result, launches, chunks:
    bench.run_offline's records)."""
    cmd = [sys.executable, "-m", "infinisst_tpu_torch.bench"] + extra
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    chunks = []
    for line in out.stderr.splitlines():
        m = CHUNK_LINE.match(line)
        if m:
            chunks.append((float(m[2]),) + tuple(int(m[k]) for k in
                                                 range(3, 10)))
        if m or line.startswith(("chunks=", "kernel launches",
                                 "decode_attention launches", "alignatt",
                                 "streamatt")):
            print(f"[{label}]   {line}", flush=True)
    if out.returncode != 0:
        for line in out.stderr.strip().splitlines()[-12:]:
            print(f"[{label}]   {line}", flush=True)
        fail(f"[{label}] {' '.join(cmd[1:])} exited {out.returncode}")
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
    prefill and the decode_attention shapes ``keys`` times."""
    bucket = statistics.mode(c[3] for c in chunks)
    shapes = {"w8a8_gemm": (bucket, REPORT_SHAPE[1], REPORT_SHAPE[2]),
              "row_quant_int8": (bucket, REPORT_SHAPE[1], 0),
              "decode_attention": keys}
    for name, shape in shapes.items():
        paths[f"{mode} {name}"] = (f"bench --mode {mode}", counts, shape)


def check_alignatt(dev, notes, paths):
    """The port bench's AlignAtt mode (12 chunks, 3 untimed), in parity
    and with --early-stop; decode_attention and the probe held at the
    shapes the parity calls ran (hold_offline_attention), timed at the
    one with the most beam forwards.  The early stop may end every call at
    its first step (the prefill's probe already in the stop zone), with no
    beam forward: its decode_attention launches may then be 0, and its
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
    """The port bench's StreamAtt mode (40 chunks, timed from 32) in a
    subprocess; decode_attention and the probe held at the shapes its
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
    max_speech_duration; a cut by that rule at least once; decode_attention
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


def check_server(d, talks):
    """The port's server at the dryrun preset (pool 2, beam 4,
    multipliers 1 and 2) on the card and two ``serve.client`` processes,
    at m=1 and m=2, streaming the CLI's two talks over localhost: both
    print their FINAL line and exit 0; the server is stopped after."""
    import socket

    port = _free_port()
    log_path = os.path.join(d, "server.log")
    with open(talks[0]) as f:
        wavs = f.read().split()
    with open(log_path, "w") as log:
        server = subprocess.Popen(
            [sys.executable, "-m", "infinisst_tpu_torch.serve.server",
             "--model-preset", "dryrun", "--port", str(port),
             "--pool-size", "2", "--multipliers", "1,2"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
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
        if device == "cuda" and counts["decode_attention"] <= 0:
            fail("[cli ckpt] the beam step did not launch decode_attention")
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
    if counts["decode_attention"] <= 0:
        fail("[cli ckpt] the StreamAtt beam step did not launch "
             "decode_attention")


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
    if counts["decode_attention"] <= 0:
        fail("[cli flagship] the beam step did not launch decode_attention")


# ---------------------------------------------------------------------------
# the training path: plain torch (JAX's training forward calls no Pallas
# kernel), so every kernel's launches there must be 0

TRAIN_LR = 1e-3
TRAIN_TINY_CASES = (  # label, freeze, grad_acc_steps, cpo_beta, schedule
    ("stage 1", "stage1", 1, 0.0, "cosine"),
    ("stage 2, grad_acc_steps 2", "stage2", 2, 0.0, "constant"),
    ("stage 0, cpo_beta 0.5", "stage0", 1, 0.5, "cosine"),
)
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


def _flagship_trainer(dev, d, max_steps, stage=1, run="run"):
    """A Trainer on the flagship preset (random bfloat16 weights, as
    bench.py's bench_train builds them), ``stage`` (1 by default), remat,
    encoder dropout 0.1 (applied at stage 1 only), over the TSV in ``d``:
    collator 4 at m = 1, two 28.8 s rows a batch, log_step 1, save_step
    0, under ``d/run``.  Its steps and saves are timed (the step
    synchronised)."""
    import torch

    from infinisst_tpu_torch.core.presets import flagship_config
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.train.main import random_params
    from infinisst_tpu_torch.train.trainer import Trainer, TrainerArgs

    cfg = flagship_config()
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
    step_fn, save_fn = t._get_step_fn(1), t._save
    t.walls, t.save_walls = [], []

    def timed_step(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        t.walls.append(time.perf_counter() - t0)
        return out

    def timed_save(step):
        t0 = time.perf_counter()
        save_fn(step)
        t.save_walls.append(time.perf_counter() - t0)

    t._step_fns[1], t._save = timed_step, timed_save
    return t


def check_train_flagship(dev, paths, d):
    """Trainer.fit on the flagship (Llama-3.1-8B + wav2vec2-large) in
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
        t = _flagship_trainer(dev, d, 3)
        state_bytes = _tree_bytes(t.state.params) + _tree_bytes(
            t.state.opt_state)
        free = shutil.disk_usage(build).free
        df = subprocess.run(["df", "-h", build], capture_output=True,
                            text=True).stdout.strip().splitlines()
        print(f"[train flagship] state {state_bytes / 1e9:.2f} GB a "
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
                          "bf16, 3 steps", counts)
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

        t2 = _flagship_trainer(dev, d, 4)
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
    Nothing is saved, and the run directory is removed afterwards."""
    import gc

    import torch

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
        del t, params, enc, sample
    finally:
        shutil.rmtree(run, ignore_errors=True)
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


def check_mesh_step(dev, mesh):
    """The sharded train step at mesh (1, 1) on the dryrun preset (float32,
    stage 2, remat, 3 of [train tiny]'s batches) against
    ``make_train_step`` without a mesh: losses, grad norms and every
    parameter bitwise equal (at world size 1 no reduction is reordered).
    Deterministic algorithms are on for the check (the embedding's and
    the convolutions' backward passes otherwise accumulate in any
    order); a second run without the mesh shows the card repeats
    itself."""
    import torch

    from infinisst_tpu_torch.core.presets import dryrun_config
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.train import step as tstep
    from infinisst_tpu_torch.train.main import random_params
    from infinisst_tpu_torch.train.trainer import BATCH_KEYS

    cfg = dryrun_config()
    host = train_tiny_batches(cfg, n=3)
    base = random_params(cfg, "cpu", torch.float32)
    freeze = tstep.FreezeConfig.stage2()

    def run(with_mesh):
        params = tstep.tree_map(lambda t: t.clone().to(dev), base)
        plan = None
        if with_mesh:
            params, lay = pmesh.shard_params(
                params, mesh, pmesh.model_param_specs(cfg), cfg=cfg)
            plan = tstep.MeshPlan(mesh, lay, False, tstep.tree_leaves(
                tstep.trainable_mask(params, freeze)))
        tx = tstep.make_optimizer(tstep.OptimConfig(
            learning_rate=TRAIN_LR, warmup_steps=1, total_steps=6),
            params, freeze)
        state = tstep.init_train_state(params, tx, plan)
        step = tstep.make_train_step(cfg, tx, 48, 96, freeze=freeze,
                                     remat=True, plan=plan)
        metrics = []
        for b in host:
            state, m = step(state, tstep.Batch(**{
                k: torch.from_numpy(b[k]).to(dev) for k in BATCH_KEYS}))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, tstep.tree_leaves(state.params)

    prev = torch.are_deterministic_algorithms_enabled()
    prev_cudnn = torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        plain = run(False)
        sharded = run(True)
        again = run(False)
    finally:
        torch.use_deterministic_algorithms(prev)
        torch.backends.cudnn.deterministic = prev_cudnn
    for label, other in (("the plain step run again", again),
                         ("the sharded step at (1, 1)", sharded)):
        if other[0] != plain[0] or not all(
                torch.equal(a, b) for a, b in zip(other[1], plain[1])):
            fail(f"[mesh] {label} is not bitwise the plain step: metrics "
                 f"{other[0]} against {plain[0]}")
    print(f"[mesh] sharded train step at (1, 1), dryrun float32 stage 2, 3 "
          f"steps: losses and grad norms {plain[0]} and every parameter "
          f"bitwise those of make_train_step without a mesh", flush=True)


def check_mesh(dev, cfg, params, d, paths):
    """The mesh path on the card at world size 1 (one H100: NCCL refuses
    two ranks on one card, so the multi-rank checks run on the CPU under
    gloo, tests/test_torch_parallel.py):

    1. in this process, a world-1 NCCL group: the flagship W8A8 agent
       (``[flagship]``'s weights) through the mesh path (``shard_params``
       at (1, 1), ``tensor_parallel``), 4 chunks: the target ids of the
       agent without a mesh after every chunk, and w8a8_gemm,
       row_quant_int8 and decode_attention launched;
    2. in the same group, ``check_mesh_step``;
    3. ``torchrun --standalone --nproc_per_node 1 -m
       infinisst_tpu_torch.parallel.dryrun``: the five parts at mesh (1, 1)
       under NCCL, exit 0 and the summary line, its launches;
    4. ``torchrun ... -m infinisst_tpu_torch.train.main --model_preset
       dryrun --n_data 1 --max_steps 3``: metrics.jsonl with three finite
       losses and the checkpoint of step 3."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from infinisst_tpu_torch.bench import write_train_tsv
    from infinisst_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = pmesh.make_mesh(1, 1, dev)
        local, _ = pmesh.shard_params(params, mesh,
                                      pmesh.model_param_specs(cfg), cfg=cfg)
        want, _ = _agent_tokens(dev, cfg, params, 4)
        got, counts = _agent_tokens(dev, cfg, local, 4, mesh=mesh)
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                fail(f"[mesh] chunk {i}: target ids {g} through the mesh "
                     f"path, {w} without it")
        for k in ("w8a8_gemm", "row_quant_int8", "decode_attention"):
            if counts[k] <= 0:
                fail(f"[mesh] {k} was not launched on the mesh path")
        print(f"[mesh] flagship W8A8 agent through the mesh path at (1, 1): "
              f"4 chunks, {len(got[-1])} target ids, equal to the agent "
              f"without a mesh after every chunk; launches {counts} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del local
        torch.cuda.empty_cache()
        check_mesh_step(dev, mesh)
    finally:
        dist.destroy_process_group()

    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    t1 = time.perf_counter()
    out = subprocess.run(torchrun + ["-m", "infinisst_tpu_torch.parallel.dryrun"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    lines = (out.stdout + out.stderr).strip().splitlines()
    for line in lines[-3:]:
        print(f"[mesh]   {line}", flush=True)
    summary = [x for x in out.stdout.splitlines()
               if x.startswith("dryrun_multichip OK: mesh=(1x1) devices=1")]
    if out.returncode != 0 or not summary:
        fail(f"[mesh] the dryrun exited {out.returncode} without its summary")
    dry = _stderr_json(out.stderr, "kernel launches ")
    if dry.get("decode_attention", 0) <= 0:
        fail(f"[mesh] the dryrun's pool ticks launched no decode_attention: "
             f"{dry}")
    shapes = _stderr_json(out.stderr, "decode_attention launches by shape ")
    print(f"[mesh] dryrun under torchrun (NCCL, world 1): exit 0, launches "
          f"{dry}, decode_attention by shape {shapes} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)

    t2 = time.perf_counter()
    data = os.path.join(d, "mesh_main")
    os.makedirs(data)
    write_train_tsv(data, 6, 2, np.random.RandomState(1), words_per_unit=0)
    run = os.path.join(data, "run")
    out = subprocess.run(
        torchrun + ["-m", "infinisst_tpu_torch.train.main",
                    "--model_preset", "dryrun", "--n_data", "1",
                    "--max_steps", "3", "--data_path", data,
                    "--data_split_train", "tr", "--data_split_eval", "tr",
                    "--eval_step", "0", "--log_step", "1", "--save_step", "0",
                    "--grad_acc_steps", "1", "--train_bsz", "300",
                    "--max_cache_size", "96", "--save_dir", run],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
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
          f"{[round(x, 4) for x in losses]}, checkpoint of step 3 "
          f"({time.perf_counter() - t2:.1f} s)", flush=True)
    paths["mesh"] = (
        "[mesh] the flagship W8A8 agent at mesh (1, 1), 4 chunks; the "
        "dryrun under torchrun at (1, 1)", {"agent": counts, "dryrun": dry})


def check_train_main(d):
    """``python -m infinisst_tpu_torch.train.main --model_preset dryrun
    --max_steps 3`` on the card in a subprocess over a dryrun TSV (rows
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
    cmd = [sys.executable, "-m", "infinisst_tpu_torch.train.main",
           "--model_preset", "dryrun", "--max_steps", "3",
           "--data_path", data, "--data_split_train", "tr",
           "--data_split_eval", "tr", "--eval_step", "3", "--log_step", "1",
           "--save_step", "0", "--grad_acc_steps", "1", "--train_bsz", "300",
           "--max_cache_size", "96", "--save_dir", run]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
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
    train-io`` in subprocesses: exit 0, the JSON line of bench.py's row
    (its metric and keys), the value finite and positive; returns the two
    lines."""
    out_lines = {}
    for mode, metric, keys in (("train", TRAIN_METRIC, TRAIN_KEYS),
                               ("train-io", TRAIN_IO_METRIC, TRAIN_IO_KEYS)):
        label = f"train bench {mode}"
        cmd = [sys.executable, "-m", "infinisst_tpu_torch.bench", "--mode",
               mode]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
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
    remat) in this process: the synced walls of 4 steps after a warm-up,
    the host's time to return from a step without a synchronise (its
    dispatch), and one step under the profiler."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.bench import train_batch, train_params
    from infinisst_tpu_torch.core.presets import bench_1chip_config
    from infinisst_tpu_torch.train import step as tstep

    cfg = bench_1chip_config()
    params, freeze, tx = train_params(cfg, dev)
    state = tstep.init_train_state(params, tx)
    batch = train_batch(2, 30, dev, np.random.RandomState(0))
    step = tstep.make_train_step(cfg, tx, 48, 576, freeze=freeze, remat=True)
    walls = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    dispatch = time.perf_counter() - t0
    torch.cuda.synchronize()
    med = statistics.median(walls[1:])
    print(f"[train bench profile] 1.5B stage-1 step: synced walls "
          f"{[round(w, 3) for w in walls]} s (the first warms up); the "
          f"host returns from a step after {dispatch:.3f} s without a "
          f"synchronise ({dispatch / med:.2f} of the median wall)",
          flush=True)
    profile_run(dev, lambda: step(state, batch), TRAIN_STAGES,
                "train bench profile", med * 1e3, "step")


# ---------------------------------------------------------------------------
# the tools: the int8 fidelity probe, draft distillation, profiling

FIDELITY_STEPS = 600  # the JAX tool's default
FIDELITY_DOC = "docs/quant_fidelity.json"  # the JAX tool's table
# the kernels each variant's probe must launch (the float32 reference and
# every variant run decode_attention in their beam steps)
FIDELITY_KERNELS = {
    "bf16": ("decode_attention",),
    "w8": ("w8_bf16_gemm", "decode_attention"),
    "w8a8": ("row_quant_int8", "w8a8_gemm", "decode_attention"),
    "w8a8_g128": ("group_quant_int8", "w8a8_grouped_gemm",
                  "decode_attention"),
    "w8a8_g128_projonly": ("group_quant_int8", "w8a8_grouped_gemm",
                           "row_quant_int8", "w8a8_gemm",
                           "decode_attention"),
    "w8a8_8groups_like_g512": ("group_quant_int8", "w8a8_grouped_gemm",
                               "decode_attention"),
}
# groups of 8: w8a8_grouped_gemm takes whole runs of 32 int8 values
FIDELITY_NOT_RUN = {"w8a8_32groups_like_g128", "w8a8_32groups_projonly"}
FIDELITY_COLS = ("train_flip_rate", "held_flip_rate", "held_dlogit_p99",
                 "greedy_match_32", "beam4_winner_changed")
# the probe's prefill (8 x 64 rows into wq): the kernels line's tools shape
TOOL_SHAPE = (512, 256, 256)
# its beam step's decode_attention: 4 beams over the 8-token prompt's cache
# (32 slots) and their own block of 24 slots, 12 tokens in
TOOL_ATT_CASES = (("fidelity beam prefix", 4, 1, 32, [20], None, True),
                  ("fidelity per-beam block", 4, 4, 24, [12] * 4, [20] * 4,
                   True))
TOOL_ATT_SHAPE = ("fidelity beam prefix", 4, 32)
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
    W8A8 per-channel, weight-only and grouped by 128 and by 32; the
    activations are the trained model's layer-0 inputs."""
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
    grouped = (("w8a8_g128", 128), ("w8a8_8groups_like_g512", 32))
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
    torch.cuda.synchronize()
    print(f"  {n} kernel calls at the probe's shapes agree with their "
          "plain versions (bitwise but w8_bf16_gemm)", flush=True)
    return var, y


def time_tool_kernels(dev, notes, var, y):
    """Each kernel's time at the probe's prefill (TOOL_SHAPE, float32, as
    the tool runs them), beside its plain version, the library call and
    the bound; decode_attention at the probe's beam step (within
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
    gen = torch.Generator(device=dev).manual_seed(17)
    H, KV, Dh = 4, 4, 64  # the probe's Llama
    for case in TOOL_ATT_CASES:
        att_case(dev, gen, notes, *case, dtype=torch.float32, timed=True,
                 heads=(H, KV, Dh))


def check_fidelity(dev, notes, paths):
    """``tools.quant_fidelity.main`` on the card in this process at 600
    training steps: each variant's kernels launched, the groups-of-8
    variants refused by the grouped GEMM (not routed to the plain
    versions), the card's rates beside the JAX tool's table; then the
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
    if set(results["not_run"]) != FIDELITY_NOT_RUN:
        fail(f"[fidelity] variants not run: {results['not_run']}")
    for name, why in results["not_run"].items():
        print(f"  {name}: not run on the card: {why}", flush=True)
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


def check_distill_flagship(dev, paths):
    """``tools.distill_adapter`` at the flagship's full width (8B float32,
    V = 128256, rank 2048, d = 8) in a subprocess: the logged KL falls,
    the .npz loads at d = 8 and is refused at 4.  Then the flagship W8A8
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
        cmd = [sys.executable, "-m", "infinisst_tpu_torch.tools.distill_adapter",
               "--model-preset", "flagship", "--prompts", prompts,
               "--prompt-tokens", "16", "--gen-len", "16", "--batch-size", "2",
               "--draft-layers", "8", "--rank", "2048", "--steps", "20",
               "--out", out]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        wall = time.perf_counter() - t0
        print(r.stderr[-3000:], flush=True)
        if r.returncode != 0:
            fail(f"[distill flagship] the tool exited {r.returncode}")
        kls = [float(m.group(1)) for m in re.finditer(
            r"^step \d+: kl (\S+) top1-agree", r.stderr, re.M)]
        peak = re.search(r"^peak memory (\S+) GiB", r.stderr, re.M)
        print(f"[distill flagship] tool wall {wall:.1f} s, peak memory "
              f"{peak.group(1) if peak else '?'} GiB, kl {kls}; "
              f"{r.stdout.strip()}", flush=True)
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


PORT_KERNEL_NAMES = ("row_quant_int8_kernel", "w8a8_gemm_tc_kernel",
                     "w8_bf16_gemm_tc_kernel", "group_quant_int8_kernel",
                     "w8a8_grouped_gemm_tc_kernel", "decode_attention_kernel")


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
        if not {"row_quant_int8_kernel", "w8a8_gemm_tc_kernel"} <= set(seen):
            fail("[profiling] the trace names no port kernel")
    finally:
        shutil.rmtree(d, ignore_errors=True)


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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.load_all()
    print(f"[build] {', '.join(_build.SOURCES)} built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)

    notes = Notes()
    with phase("kernels"):
        print("[kernels] against their plain versions on the card",
              flush=True)
        check_kernels(dev, notes)
    with phase("attention"):
        print("[attention] decode_attention against its plain version on "
              "the card", flush=True)
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

    paths = {}
    with phase("flagship"):
        cfg, params = check_flagship(dev, paths)
    with phase("streamatt"):
        check_streamatt(dev, cfg, params)
    mesh_dir = tempfile.mkdtemp(prefix="mesh_", dir=os.path.join(ROOT,
                                                                "build"))
    try:
        with phase("mesh"):
            check_mesh(dev, cfg, params, mesh_dir, paths)
    finally:
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
    try:
        wavs = write_talks(cli_dir)
        with phase("cli ckpt"):
            check_cli_ckpt(cli_dir, wavs)
        with phase("cli flagship"):
            check_cli_flagship(cli_dir, wavs)
        with phase("server"):
            check_server(cli_dir, wavs)
        torch.cuda.empty_cache()
        with phase("train tiny"):
            print("[train tiny] dryrun float32 train steps: card against "
                  "CPU", flush=True)
            check_train_tiny(dev)
        import numpy as np

        from infinisst_tpu_torch.bench import write_train_tsv

        train_dir = tempfile.mkdtemp(prefix="train_flagship_",
                                     dir=os.path.join(ROOT, "build"))
        try:
            write_train_tsv(train_dir, 6, 30, np.random.RandomState(0))
            with phase("train flagship"):
                check_train_flagship(dev, paths, train_dir)
            with phase("train flagship stage 2"):
                check_train_flagship_stage2(dev, train_dir)
        finally:
            shutil.rmtree(train_dir, ignore_errors=True)
        with phase("train main"):
            check_train_main(cli_dir)
        with phase("train bench"):
            check_train_bench()
            profile_train_bench(dev)
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    with phase("fidelity"):
        print("[fidelity] tools.quant_fidelity on the card: int8 token "
              "flips on a trained model", flush=True)
        fidelity_params = check_fidelity(dev, notes, paths)
    with phase("distill tiny"):
        check_distill_tiny(dev, paths)
    with phase("distill flagship"):
        check_distill_flagship(dev, paths)
    with phase("profiling"):
        check_profiling(dev, fidelity_params)
    del fidelity_params

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
        "w8a8_grouped_gemm": (
            g_src, "infinisst_tpu/kernels/quant_matmul.py:191", REPORT_SHAPE),
        "decode_attention": (
            "infinisst_tpu_torch/csrc/decode_attention.cu",
            "infinisst_tpu/kernels/decode_attention.py:57",
            ("beam prefix", 4, 1280)),
    }
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
        if "launch_floor_ms" in t:  # the yardstick of a latency-bound kernel
            entries[-1]["launch_floor_ms"] = t["launch_floor_ms"]
        # the training path runs no kernel (JAX's offline forward calls no
        # Pallas kernel): its launches, 0, checked in [train flagship]
        train_path, train_counts = paths["train"]
        entries[-1]["train"] = {"launches": train_counts.get(name, 0),
                                "path": train_path}
        # the mesh path at world size 1: the flagship agent in this
        # process, the dryrun under torchrun
        mesh_path, mesh_counts = paths["mesh"]
        entries[-1]["mesh"] = {
            "launches": {k: c.get(name, 0) for k, c in mesh_counts.items()},
            "path": mesh_path}
    # decode_attention_batched (decode_attention.py:287), the same kernel:
    # the serving pool's prefix, 8 caches each read by its slot's 4 beams
    t = notes.rows["decode_attention"]["shapes"][POOL_PREFIX]
    path, counts = paths["decode_attention_pool"]
    entry = next(e for e in entries if e["name"] == "decode_attention")
    entry["pool_prefix"] = {
        "replaces": "infinisst_tpu/kernels/decode_attention.py:228",
        "launches": counts["decode_attention"], "path": path,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": {"B": POOL_PREFIX[1], "Bc": 8, "C": POOL_PREFIX[2]}}
    if counts["decode_attention"] <= 0:
        fail("decode_attention was not launched at the pool prefix")
    # the offline paths (bench --mode alignatt and streamatt): their
    # launches, and the kernels' times at their shapes (the modal prompt
    # bucket's prefill; decode_attention's prefix and per-beam block at the
    # (prompt length, cache slots) with the most beam forwards)
    for mode in ("alignatt", "streamatt"):
        for e in entries:
            key = f"{mode} {e['name']}"
            if key not in paths:
                continue
            path, counts, shape = paths[key]
            if e["name"] == "decode_attention":
                shape, beam_key = shape
            t = notes.rows[e["name"]]["shapes"][shape]
            e[mode] = {
                "launches": counts[e["name"]], "path": path,
                "shape": [x for x in shape if x != 0],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
            if e["name"] == "decode_attention":
                t = notes.rows[e["name"]]["shapes"][beam_key]
                e[mode]["per_beam_block"] = {
                    "shape": list(beam_key), **{k: t[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")}}
    # the speculative stack (bench --speculative, --spec-beam, --do-sample
    # and the speculative pool): its launches, and the times at its shapes
    # (a verify's gate/up, its row quantization, the tree verify's prefix)
    spec_shapes = {"w8a8_gemm": SPEC_SHAPE,
                   "row_quant_int8": (SPEC_SHAPE[0], SPEC_SHAPE[1], 0),
                   "decode_attention": SPEC_ATT_SHAPE}
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
    # float32; decode_attention at its beam step's prefix)
    tool_shapes = {"row_quant_int8": ("tools", TOOL_SHAPE[0], TOOL_SHAPE[1],
                                      0),
                   "group_quant_int8": ("tools", TOOL_SHAPE[0],
                                        TOOL_SHAPE[1], 0),
                   "decode_attention": TOOL_ATT_SHAPE}
    for e in entries:
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
        if paths["fidelity"][1][e["name"]] <= 0:
            fail(f"{e['name']} was not launched on the fidelity probe")
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
