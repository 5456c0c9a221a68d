"""The mesh dryrun: the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

On one (data x model) mesh over every rank of the process group
(``model_ax`` 4, else 2, else 1, whichever divides the world size), on
the dryrun preset in float32, it runs:

1. the full stage 2 training step (``make_train_step`` with no freeze,
   so every leaf's gradient is taken, under a stage 2 optimizer) with
   TP + DP/ZeRO shardings, on a tiny batch of B = 2 * data_ax rows;
2. a TP-sharded streaming prefill (``speech_llm.prefill_chunk``), one row
   per data rank;
3. a pooled ``ServingEngine`` tick (pool max(2, data_ax), beam 2,
   multipliers (1, 2)) on the trained parameters;
4. a speculative pool tick (layer-skip draft, k = 3, a shortlist head);
5. a speculative sampling pool tick;

and prints the JAX package's summary line (and, on stderr, the kernels'
launch counts).  The JAX dryrun splits the pools' rows and caches over
'data'; the port does not (ROADMAP §3), and ``ServingEngine`` refuses a
mesh whose 'data' size is above 1.  So parts 3-5 run on the mesh's
'model' slice, ``mesh["model"]``: each data rank serves a whole pool of
its own, tensor-parallel over its model ranks (said on stderr where
data_ax > 1).

    torchrun --standalone --nproc_per_node 8 \
        -m infinisst_tpu_torch.parallel.dryrun [--data D --model M] \
        [--device cpu]

The ranks are ``torchrun``'s processes: NCCL on ``cuda``, gloo on
``cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def mesh_axes(n_devices: int):
    """(data_ax, model_ax): model 4, else 2, else 1, whichever divides."""
    model_ax = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    return n_devices // model_ax, model_ax


def _tokens():
    from infinisst_tpu_torch.core.config import SpecialTokens

    return SpecialTokens(
        bos=1000, eot=1001, eos=1001, start_header=1002, end_header=1003,
        pad=1004, user=1005, assistant=1006, newline2=1007, sp_patch=1008,
        sp_start=1009, sp_end=1010, latency=(1011, 1012, 1013, 1014),
    )


def dryrun_multichip(device="cuda", data_ax=None, model_ax=None) -> str:
    """Run the five parts on the process group's ranks (on a mesh of
    ``mesh_axes(world size)`` unless both axes are given); returns (and
    rank 0 prints) the summary line."""
    import torch.distributed as dist

    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.presets import dryrun_config
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models import speech_llm
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel
    from infinisst_tpu_torch.serve.engine import ServingEngine
    from infinisst_tpu_torch.streaming.state import (
        init_decoder_state,
        init_encoder_state,
    )
    from infinisst_tpu_torch.train import step as tstep
    from infinisst_tpu_torch.train.main import random_params

    dev = torch.device(device)
    n_devices = dist.get_world_size()
    if data_ax is None or model_ax is None:
        data_ax, model_ax = mesh_axes(n_devices)
    mesh = pmesh.make_mesh(data=data_ax, model=model_ax, device=dev)

    cfg = dryrun_config()
    zero = data_ax > 1
    params = random_params(cfg, dev, torch.float32)
    specs = pmesh.model_param_specs(cfg, zero=zero)
    params, layouts = pmesh.shard_params(params, mesh, specs, cfg=cfg)
    freeze = tstep.FreezeConfig.stage2()
    plan = tstep.MeshPlan(mesh, layouts, zero, tstep.tree_leaves(
        tstep.trainable_mask(params, freeze)))

    tx = tstep.make_optimizer(
        tstep.OptimConfig(total_steps=100, warmup_steps=10), params, freeze)
    state = tstep.init_train_state(params, tx, plan)

    # tiny batch: B = data_ax * 2 rows, ~1.9 s of audio, a short transcript
    B = data_ax * 2
    n_frames = 96  # 2 chunks
    n_samples = 399 + n_frames * 320
    sp_tokens = n_frames // 4
    rng = np.random.RandomState(0)
    ids = np.full((B, sp_tokens + 12), 7, np.int32)
    ids[:, 2:2 + sp_tokens] = 1008 % cfg.llama.vocab_size
    patch_mask = ids == (1008 % cfg.llama.vocab_size)
    labels = np.where(np.arange(ids.shape[1])[None] >= sp_tokens + 4, ids,
                      -100).astype(np.int32)
    batch = tstep.Batch(
        speech=torch.from_numpy(
            rng.randn(B, n_samples).astype(np.float32) * 0.1).to(dev),
        frame_lengths=torch.full((B,), n_frames, dtype=torch.int32,
                                 device=dev),
        input_ids=torch.from_numpy(ids).to(dev),
        labels=torch.from_numpy(labels).to(dev),
        attention_mask=torch.ones(ids.shape, dtype=torch.int32, device=dev),
        patch_mask=torch.from_numpy(patch_mask).to(dev),
    )
    train_step = tstep.make_train_step(cfg, tx, block_frames=48,
                                       max_cache_frames=96, multiplier=1,
                                       plan=plan)
    state, metrics = train_step(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if state.step != 1:
        raise RuntimeError(f"the step count is {state.step}, not 1")

    # -- the TP-sharded streaming prefill, one row per data rank
    stream = StreamConfig(max_cache_frames=96, llm_cache_capacity=128)
    p = state.params
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10,
                                          hi=900), _tokens())
    pr = builder.chunk_prompt(1, first=True)
    ids_inf = torch.as_tensor(pr.ids % cfg.llama.vocab_size,
                              device=dev)[None]
    window = torch.zeros((1, stream.conv_window_samples(1)),
                         dtype=torch.float32, device=dev)
    with torch.no_grad(), tensor_parallel(mesh):
        enc = init_encoder_state(
            cfg.w2v2.encoder_layers, 1, stream.max_cache_frames,
            W.local_heads(p["w2v2"], cfg.w2v2), cfg.w2v2.head_dim,
            torch.float32, dev)
        dec = init_decoder_state(
            cfg.llama.num_layers, 1, stream.llm_cache_capacity,
            L.local_heads(p["llama"]["layers"], cfg.llama)[1],
            cfg.llama.head_dim, torch.float32, dev)
        logits, _ = speech_llm.prefill_chunk(
            p, cfg, speech_llm.StreamState(enc, dec), window, ids_inf,
            pr.patch_start, 48, stream.max_cache_frames)
    if not torch.isfinite(logits).all():
        raise RuntimeError("the TP prefill's logits are not finite")
    logits_shape = (data_ax,) + tuple(logits.shape[1:])

    # -- the pooled serving tick (mixed multipliers, beam 2), on the
    # 'model' slice: a pool's rows are not split over 'data'
    serve_mesh = mesh["model"]
    if data_ax > 1 and dist.get_rank() == 0:
        import sys

        print(f"dryrun: the serving pools are not split over 'data' "
              f"(ROADMAP §3): each of the {data_ax} data ranks serves its "
              "own pool", file=sys.stderr, flush=True)
    pool = max(2, data_ax)
    builders = {("English", "German"): builder}
    rng2 = np.random.RandomState(1)
    unit = stream.chunk_samples(1)
    with tensor_parallel(serve_mesh):
        eng = ServingEngine(p, cfg, stream, builders, pool_size=pool,
                            multiplier=1, dtype=torch.float32, beam=2,
                            multipliers=(1, 2), device=dev)
        s0 = eng.open_stream("dry0", multiplier=1)
        s1 = eng.open_stream("dry1", multiplier=2)
        for _ in range(2):
            eng.push_audio(s0, rng2.randn(unit).astype(np.float32) * 0.1)
            eng.push_audio(s1, rng2.randn(unit).astype(np.float32) * 0.1)
            eng.tick()
    n_served = len(eng.slots[s0].target_ids) + len(eng.slots[s1].target_ids)
    if eng.slots[s0].cache_len <= 0:
        raise RuntimeError("the serve tick made no m=1 prefill")

    # -- the speculative pool tick (layer-skip draft, shortlist head)
    with tensor_parallel(serve_mesh):
        eng_s = ServingEngine(
            p, cfg, stream, builders, pool_size=pool, multiplier=1,
            dtype=torch.float32, beam=1, device=dev, speculative=True,
            spec_draft_layers=max(1, cfg.llama.num_layers // 2), spec_k=3,
            spec_head_vocab=cfg.llama.vocab_size // 4)
        t0 = eng_s.open_stream("spec0", multiplier=1)
        for _ in range(2):
            eng_s.push_audio(t0, rng2.randn(unit).astype(np.float32) * 0.1)
            eng_s.tick()
    if eng_s.slots[t0].cache_len <= 0:
        raise RuntimeError("the speculative serve tick made no prefill")
    n_spec = len(eng_s.slots[t0].target_ids)

    # -- the speculative sampling pool tick
    with tensor_parallel(serve_mesh):
        eng_ss = ServingEngine(
            p, cfg, stream, builders, pool_size=pool, multiplier=1,
            dtype=torch.float32, beam=1, device=dev, speculative=True,
            spec_draft_layers=max(1, cfg.llama.num_layers // 2), spec_k=3,
            do_sample=True, temperature=1.2, top_k=8)
        u0 = eng_ss.open_stream("samp0", multiplier=1)
        eng_ss.push_audio(u0, rng2.randn(unit).astype(np.float32) * 0.1)
        eng_ss.tick()
    if eng_ss.slots[u0].cache_len <= 0:
        raise RuntimeError("the sampling pool made no prefill")
    n_samp = len(eng_ss.slots[u0].target_ids)

    line = (
        f"dryrun_multichip OK: mesh=({data_ax}x{model_ax}) "
        f"devices={n_devices} loss={loss:.4f} "
        f"grad_norm={float(metrics['grad_norm']):.4f} "
        f"tp-inference logits {logits_shape} finite; "
        f"pooled-serve tick (pool={pool}, mixed m=1/2, beam=2) ran, "
        f"{n_served} tokens served; speculative pool tick "
        f"(shortlist head, rounds={eng_s.spec_stats['rounds']}) served "
        f"{n_spec} tokens; sampling pool tick served {n_samp} tokens")
    if dist.get_rank() == 0:
        import json
        import sys

        from infinisst_tpu_torch.kernels import decode_attention as KA
        from infinisst_tpu_torch.kernels import quant_matmul as KQ

        print(line, flush=True)
        print("kernel launches "
              + json.dumps({**KQ.launch_counts, **KA.launch_counts}),
              file=sys.stderr, flush=True)
        print("decode_attention launches by shape "
              + json.dumps(dict(KA.launch_shapes)), file=sys.stderr,
              flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--model", type=int, default=None)
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("run under torchrun (--device cpu for gloo ranks)")
    import torch.distributed as dist

    from infinisst_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed(args.device)
    try:
        dryrun_multichip(dev, args.data, args.model)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
