"""The memory plan of the flagship's training step on every (data, model)
mesh of a world size, and of its serving pool split over 'data'; the
port's counterpart of the root ``tools_memplan.py``.

For each (d, m) with d x m = ``--world`` (the world size under
``torchrun``), a stage 2 and a stage 1 row (stage 2: frozen w2v2, the
adapter and the LLM trained; stage 1: the LLM frozen), and one serving
row (the W8A8 pool split over 'data' at d = world, m = 1: 8 rows of
beam 4 a rank).  A row gives:

- the bytes per rank of the parameters, the gradients and the optimizer
  state (AdamW's two moments, in the leaves' dtype) under the layouts
  ``parallel.mesh.shard_params`` uses (``zero`` where d > 1: FSDP),
  reckoned from the parameter tree on the meta device (no 8B tensor is
  made; JAX's ``abstract_params``); for the pool, the parameters (int8
  leaves whole, the float leaves split over 'data') and the pool's
  state of a rank's rows (encoder ring, decoder cache, windows);
- the heavy leaves' sanitised specs (JAX's ``heavy_leaf_specs``);
- under ``torchrun`` with ``--measure`` (one process a card), each
  rank's measured peak (``torch.cuda.max_memory_allocated``) and step
  walls for real steps (the captured ``TrainProgram``, as ``Trainer``
  runs it) at ``plan_mesh``'s defaults (2 rows a rank of
  ``--audio-s`` 20 s, ``--seq-len`` 384, ``--multiplier`` 4, remat;
  bf16 parameters on seeded random weights), and for the pool one
  tick's peak and wall.

The budget is the card's own memory (``torch.cuda.get_device_properties``)
where a card is used, else null.  The plan is written as JSON to
``--out`` (and printed).

    python -m infinisst_tpu_torch.tools.memplan --world 4 --out plan.json
    torchrun --standalone --nproc_per_node 4 \\
        -m infinisst_tpu_torch.tools.memplan --measure --out plan.json

``--model-preset dryrun --device cpu`` runs on the CPU (gloo ranks; no
peak is measured there: "not measured").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HEAVY = (("llama", "lm_head"), ("llama", "embed"),
         ("llama", "layers", "w_up"), ("llama", "layers", "wq"))


def meshes_of(world: int):
    """Every (d, m) with d x m = world, the most data-parallel first."""
    return [(world // m, m) for m in range(1, world + 1) if world % m == 0]


def meta_params(cfg, dtype=torch.bfloat16, quantized=False):
    """The parameter tree on the meta device (shapes and dtypes only):
    float, or the W8A8 serving layout (int8 projections and head)."""
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.models.quant import init_quantized_llama

    llama = (init_quantized_llama(cfg.llama, None, "meta",
                                  embed_dtype=dtype, act_int8=True,
                                  lm_head_int8=True) if quantized
             else L.init_params(cfg.llama, None, "meta", dtype))
    return {"w2v2": W.init_params(cfg.w2v2, None, "meta", dtype),
            "adapter": A.init_params(cfg.adapter, None, "meta", dtype),
            "llama": llama}


def _freeze(stage: int):
    from infinisst_tpu_torch.train import step as tstep

    return (tstep.FreezeConfig.stage1() if stage == 1
            else tstep.FreezeConfig.stage2())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local_params(cfg, params, d, m):
    """(rank 0's params, layouts) of whole ``params`` on a (d, m)
    mapping mesh (every rank holds as many bytes)."""
    from infinisst_tpu_torch.parallel import mesh as pmesh

    sizes = {"data": d, "model": m}
    return pmesh.shard_params(
        params, sizes, pmesh.model_param_specs(cfg, zero=d > 1),
        cfg=None if m == 1 else cfg,
        ranks={"data": 0, "model": 0})


def heavy_leaf_specs(lay) -> dict:
    out = {}
    for path in HEAVY:
        node = lay
        for k in path:
            node = node[k]
        out[".".join(path)] = str(tuple(node.spec))
    return out


def reckon(cfg, d: int, m: int, stage: int = 2, dtype=torch.bfloat16):
    """The row of the training step at (d, m): bytes per rank of the
    parameters, gradients (one a trained leaf, its shard) and AdamW's
    moments, from the layouts on the meta device."""
    from infinisst_tpu_torch.train import step as tstep

    whole = meta_params(cfg, dtype)
    local, lay = _local_params(cfg, whole, d, m)
    leaves = tstep.tree_leaves(local)
    mask = tstep.tree_leaves(tstep.trainable_mask(local, _freeze(stage)))
    p = sum(_nbytes(t) for t in leaves)
    g = sum(_nbytes(t) for t, t_ in zip(leaves, mask) if t_)
    return {"stage": stage, "mesh": f"dp{d}xtp{m}", "zero": d > 1,
            "param_dtype": str(dtype).replace("torch.", ""),
            "param_bytes_per_rank": p, "grad_bytes_per_rank": g,
            "opt_bytes_per_rank": 2 * g,
            "state_bytes_per_rank": p + 3 * g,
            "heavy_leaf_specs": heavy_leaf_specs(lay)}


def reckon_serve(cfg, d: int, pool_per_rank: int, beam: int, stream,
                 dtype=torch.bfloat16):
    """The row of the W8A8 pool of ``pool_per_rank`` x d rows split over
    d data ranks (m = 1): the parameters a rank holds (int8 leaves whole,
    float leaves split over 'data') and its rows' state."""
    from infinisst_tpu_torch.streaming.state import (
        init_decoder_state,
        init_encoder_state,
    )
    from infinisst_tpu_torch.train import step as tstep

    local, _ = _local_params(cfg, meta_params(cfg, dtype, True), d, 1)
    p = sum(_nbytes(t) for t in tstep.tree_leaves(local))
    w, ll = cfg.w2v2, cfg.llama
    enc = init_encoder_state(w.encoder_layers, pool_per_rank,
                             stream.max_cache_frames,
                             w.encoder_attention_heads, w.head_dim, dtype,
                             "meta")
    dec = init_decoder_state(ll.num_layers, pool_per_rank,
                             stream.llm_cache_capacity, ll.num_kv_heads,
                             ll.head_dim, dtype, "meta")
    s = sum(_nbytes(t) for t in (enc.k, enc.v, dec.k, dec.v))
    s += pool_per_rank * stream.conv_window_samples(1) * 4
    return {"recipe": f"serve pool={pool_per_rank * d} beam={beam} W8A8 "
                      f"(int8 projections and head), split over data {d}",
            "mesh": f"dp{d}xtp1", "pool_size": pool_per_rank * d,
            "rows_per_rank": pool_per_rank, "beam": beam,
            "param_bytes_per_rank": p, "pool_state_bytes_per_rank": s,
            "state_bytes_per_rank": p + s}


# -- measured, under torchrun ------------------------------------------------

def _batch(cfg, rows: int, audio_s: float, seq_len: int, device, seed=0):
    """A stage 2-shaped batch: ``rows`` rows of ``audio_s`` s of seeded
    noise, the speech tokens' patch span, then transcript ids (labels)."""
    from infinisst_tpu_torch.core.config import (
        CONV_LEFT_CONTEXT,
        SAMPLES_PER_FRAME,
    )
    from infinisst_tpu_torch.train.step import Batch

    rng = np.random.RandomState(seed)
    n_frames = int(audio_s * 50)
    sp = n_frames // 4
    if sp + 8 > seq_len:
        raise ValueError(f"{sp} speech tokens do not fit seq_len {seq_len}")
    V = cfg.llama.vocab_size
    ids = rng.randint(10, min(V, 30000), size=(rows, seq_len))
    pm = np.zeros((rows, seq_len), bool)
    pm[:, 2:2 + sp] = True
    ids[pm] = cfg.tokens.sp_patch % V
    labels = np.where(np.arange(seq_len)[None] >= sp + 4, ids, -100)
    n_samples = CONV_LEFT_CONTEXT + n_frames * SAMPLES_PER_FRAME
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return Batch(
        speech=t((rng.randn(rows, n_samples) * 0.1).astype(np.float32)),
        frame_lengths=t(np.full((rows,), n_frames, np.int32)),
        input_ids=t(ids.astype(np.int32)), labels=t(labels.astype(np.int32)),
        attention_mask=t(np.ones((rows, seq_len), np.int32)),
        patch_mask=t(pm))


def _to(tree, device):
    """``tree`` copied to ``device``, its 'data' shards marked again."""
    from infinisst_tpu_torch.parallel import collectives as par
    from infinisst_tpu_torch.train.step import tree_map

    def one(t):
        out = t.to(device)
        d = par.data_dim(t)
        return out if d is None else par.mark_data_shard(out, d)

    return tree_map(one, tree)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_reset(device):
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    if device.type != "cuda":
        return None
    _sync(device)
    return int(torch.cuda.max_memory_allocated(device))


def measure_step(cfg, whole_host, d, m, stage, device, *, rows_per_rank,
                 audio_s, seq_len, multiplier, block_frames=48,
                 max_cache_frames=576, n_steps=3):
    """``n_steps`` real sharded steps at (d, m) (a collective: every rank
    of the process group calls it), run as ``Trainer`` runs them: the
    ``TrainProgram``, captured on a card (its first step the warm-up and
    the capture).  This rank's peak and step walls."""
    import gc

    from infinisst_tpu_torch.core import graphs
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.train import step as tstep

    mesh = pmesh.make_mesh(d, m, device)
    local, lay = pmesh.shard_params(
        whole_host, mesh, pmesh.model_param_specs(cfg, zero=d > 1), cfg=cfg)
    params = _to(local, device)
    del local
    freeze = _freeze(stage)
    tx = tstep.make_optimizer(tstep.OptimConfig(
        total_steps=100_000, warmup_steps=1000), params, freeze)
    state = tstep.init_train_state(params, tx)
    program = tstep.TrainProgram(
        cfg, tx, block_frames, max_cache_frames, device, freeze=freeze,
        remat=True, plan=tstep.MeshPlan(mesh, lay))
    batch = _batch(cfg, rows_per_rank * d, audio_s, seq_len, device)
    _peak_reset(device)
    walls, losses = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, met = program(state, batch, multiplier)
        losses.append(graphs.read(met["packed"])[0])  # a sync
        walls.append(time.perf_counter() - t0)
    peak = _peak(device)
    del state, params, program, tx, met
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"dp{d}xtp{m} stage {stage}: losses {losses}")
    return {"peak_bytes": peak, "step_s": walls, "loss": losses}


def measure_serve(cfg, d, pool_per_rank, beam, stream, device):
    """One warm and one measured tick of the W8A8 pool of ``cfg`` split
    over d data ranks (every slot streaming seeded noise), from
    FSDP-sharded float leaves: this rank's peak and the tick's wall."""
    import gc

    from infinisst_tpu_torch.bench import flagship_params
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel
    from infinisst_tpu_torch.serve.engine import ServingEngine

    mesh = pmesh.make_mesh(d, 1, device)
    _, params = flagship_params(device, cfg=cfg)
    params, _ = pmesh.shard_params(params, mesh,
                                   pmesh.model_param_specs(cfg, zero=d > 1))
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    rng = np.random.RandomState(0)
    with torch.no_grad(), tensor_parallel(mesh):
        eng = ServingEngine(params, cfg, stream,
                            {("English", "German"): builder},
                            pool_size=pool_per_rank * d, beam=beam,
                            dtype=torch.bfloat16, device=device)
        slots = [eng.open_stream(f"s{i}") for i in range(eng.pool)]
        walls = []
        for i in range(2):
            for s in slots:
                eng.push_audio(s, (rng.randn(stream.chunk_samples(1))
                                   * 0.1).astype(np.float32))
            if i == 1:
                _peak_reset(device)
            t0 = time.perf_counter()
            eng.tick()
            _sync(device)
            walls.append(time.perf_counter() - t0)
        peak = _peak(device)
    del eng, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"peak_bytes": peak, "tick_s": walls[1]}


def _gather(obj):
    """``obj`` from every rank, on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def plan(cfg, world: int, device=None, *, stages=(2, 1), rows_per_rank=2,
         audio_s=20.0, seq_len=384, multiplier=4, pool_per_rank=8, beam=4,
         serve=True):
    """The plan's dict.  With ``device`` (under an initialised process
    group of ``world`` ranks) every row is also measured."""
    from infinisst_tpu_torch.core.config import StreamConfig

    stream = StreamConfig()
    budget = None
    if device is not None and device.type == "cuda":
        budget = int(torch.cuda.get_device_properties(device).total_memory)
    whole_host = None
    if device is not None:
        from infinisst_tpu_torch.train.main import random_params
        from infinisst_tpu_torch.train.step import tree_map

        whole_host = tree_map(lambda t: t.to("cpu"), random_params(
            cfg, device, torch.bfloat16))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    shape = dict(rows_per_rank=rows_per_rank, audio_s=audio_s,
                 seq_len=seq_len, multiplier=multiplier)
    out = {"world": world, "budget_bytes_per_rank": budget,
           "device": (torch.cuda.get_device_name(device) if budget
                      else None),
           "step_shape": shape, "recipe": (
               "bf16 parameters, remat, zero (FSDP) where data > 1; "
               "AdamW moments in the leaves' dtype")}
    for stage in stages:
        rows = []
        for d, m in meshes_of(world):
            row = reckon(cfg, d, m, stage)
            row["global_batch_rows"] = rows_per_rank * d
            if device is not None:
                got = _gather(measure_step(cfg, whole_host, d, m, stage,
                                           device, **shape))
                row["measured_peak_bytes_per_rank"] = [
                    g["peak_bytes"] for g in got]
                row["step_s_rank0"] = got[0]["step_s"]
                row["loss"] = got[0]["loss"]
            ref = max(row.get("measured_peak_bytes_per_rank") or [0]) or \
                row["state_bytes_per_rank"]
            row["fits_budget"] = None if budget is None else ref < budget
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
        out["meshes" if stage == 2 else f"stage{stage}_meshes"] = rows
    if serve:
        row = reckon_serve(cfg, world, pool_per_rank, beam, stream)
        if device is not None:
            got = _gather(measure_serve(cfg, world, pool_per_rank, beam,
                                        stream, device))
            row["measured_peak_bytes_per_rank"] = [g["peak_bytes"]
                                                   for g in got]
            row["tick_s_rank0"] = got[0]["tick_s"]
        print(json.dumps(row), file=sys.stderr, flush=True)
        out["serve_pools"] = [row]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="world size to plan (default: torchrun's)")
    ap.add_argument("--measure", action="store_true",
                    help="also run each row under torchrun and measure it")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model-preset", default="flagship",
                    choices=("flagship", "dryrun"))
    ap.add_argument("--stages", default="2,1")
    ap.add_argument("--audio-s", type=float, default=20.0)
    ap.add_argument("--seq-len", type=int, default=384)
    ap.add_argument("--multiplier", type=int, default=4)
    ap.add_argument("--no-serve", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from infinisst_tpu_torch.core.presets import PRESETS

    cfg = PRESETS[args.model_preset]()
    device, world = None, args.world
    if args.measure:
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit("--measure runs under torchrun")
        import torch.distributed as dist

        from infinisst_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(args.device)
        world = dist.get_world_size()
    if world is None:
        raise SystemExit("give --world, or --measure under torchrun")
    try:
        out = plan(cfg, world, device,
                   stages=tuple(int(s) for s in args.stages.split(",")),
                   audio_s=args.audio_s, seq_len=args.seq_len,
                   multiplier=args.multiplier, serve=not args.no_serve)
        out["model"] = args.model_preset
        rank0 = device is None or torch.distributed.get_rank() == 0
        if rank0:
            text = json.dumps(out, indent=1)
            print(text, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "w") as f:
                    f.write(text + "\n")
    finally:
        if device is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
