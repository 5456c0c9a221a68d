"""Rank functions of ``tests/test_torch_parallel.py`` and ``spawn``, which
runs them on N CPU ranks under gloo, one spawned process a rank.

Each rank initialises the default group over a free localhost port with
its rank and the world size (nothing reads a cluster's environment),
runs one thread, calls ``fn(rank, world, *args)`` and sends back what it
returns (picklable).  The parent joins every rank within ``timeout``
seconds: a rank that fails, or a collective that hangs, kills them all
and raises, so that no process outlives the call (the suite runs with
no per-test timeout, and a hung collective must not stall it).

This module imports torch, numpy and the port only (no JAX), so that the
spawned ranks start quickly.  Each rank builds the (data, model) mesh
once and runs a list of jobs on it (``parallel/mesh_check.py``'s
functions, on the CPU); inputs arrive as numpy trees, results leave as
numpy, from every rank.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as _queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List

import numpy as np
import torch

from infinisst_tpu_torch.parallel import mesh_check as MC

KEYS = ("speech", "frame_lengths", "input_ids", "labels", "attention_mask",
        "patch_mask")
LR = MC.LR


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy().copy()


def train_run(cfg, params_np, batches, case, mesh=None, zero=False):
    """``mesh_check.train_run`` on the CPU from numpy inputs: the per-step
    (loss, grad norm) and the whole parameters after 3 steps (numpy)."""
    from infinisst_tpu_torch.train.step import Batch

    metrics, params = MC.train_run(
        cfg, to_torch(params_np),
        [Batch(**{k: torch.from_numpy(b[k]) for k in KEYS})
         for b in batches], case, "cpu", mesh, zero)
    return metrics, to_numpy(params)


def zero_collectives(cfg, params_np, batches, case, mesh):
    """One sharded ZeRO step of ``case`` on ``mesh``, counting the
    elements it all-gathers and reduce-scatters; returns them beside the
    elements of the trainable leaves that 'data' splits and of the frozen
    leaves."""
    import torch.distributed as dist

    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.train import step as TT

    freeze = MC.freeze_of(case[0])
    params, lay = pmesh.shard_params(
        to_torch(params_np), mesh, pmesh.model_param_specs(cfg, True),
        cfg=cfg)
    mask = TT.tree_leaves(TT.trainable_mask(params, freeze))
    plan = TT.MeshPlan(mesh, lay, True, mask)
    tx = TT.make_optimizer(TT.OptimConfig(learning_rate=LR), params, freeze)
    state = TT.init_train_state(params, tx, plan)
    step = TT.make_train_step(cfg, tx, MC.BLOCK, MC.CACHE, freeze=freeze,
                              plan=plan)
    batch = TT.Batch(**{k: torch.from_numpy(batches[0][k]) for k in KEYS})
    seen = {"gathered": 0, "scattered": 0}
    all_gather, reduce_scatter = dist.all_gather, dist.reduce_scatter

    def counted_all_gather(parts, t, *a, **k):
        seen["gathered"] += t.numel() * len(parts)
        return all_gather(parts, t, *a, **k)

    def counted_reduce_scatter(out, parts, *a, **k):
        seen["scattered"] += sum(p.numel() for p in parts)
        return reduce_scatter(out, parts, *a, **k)

    dist.all_gather = counted_all_gather
    dist.reduce_scatter = counted_reduce_scatter
    try:
        step(state, batch)
    finally:
        dist.all_gather, dist.reduce_scatter = all_gather, reduce_scatter
    leaves, lays = TT.tree_leaves(params), pmesh.layout_leaves(lay)
    return dict(seen, split_trainable=sum(
        t.numel() for t, lt, m in zip(leaves, lays, mask)
        if m and lt.data_dim is not None),
        frozen=sum(t.numel() for t, m in zip(leaves, mask) if not m))


def prefill(cfg, params_np, window, ids, patch_start, mesh=None):
    logits, n = MC.prefill(cfg, to_torch(params_np), torch.from_numpy(window),
                           torch.from_numpy(ids), patch_start, "cpu", mesh)
    return logits.numpy(), n


def agent_tokens(cfg, params_np, audio, mesh=None):
    return MC.agent_tokens(cfg, to_torch(params_np), audio, "cpu", mesh)


def fit(cfg, params_np, data_dir, save_dir, max_steps, mesh_shape):
    """``Trainer.fit`` over the TSV in ``data_dir`` (stage 2, one step per
    batch, a save at the end) with ``n_data, n_model = mesh_shape``; the
    whole parameters after it (gathered)."""
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.train.trainer import Trainer, TrainerArgs

    args = TrainerArgs(
        data_path=data_dir, data_split_train="tr", data_split_eval="none",
        trajectory=4, trajectory_max_multiplier=1, stage=2, train_bsz=300,
        bsz_sent=2, learning_rate=LR, warmup_steps=1, max_steps=max_steps,
        grad_acc_steps=1, save_dir=save_dir, max_cache_size=96,
        log_step=1, eval_step=0, save_step=0, n_data=mesh_shape[0],
        n_model=mesh_shape[1], zero=True)
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10,
                                          hi=900), cfg.tokens)
    t = Trainer(args, cfg, builder, to_torch(params_np), device="cpu")
    step = t.fit()
    state = t.state
    if t.plan is not None:
        state = t.plan.whole_state(state, t._train_idx)
    return step, to_numpy(state.params)


def run_jobs(rank, world, mesh_shape, jobs):
    """Build the (data, model) mesh, then run ``jobs`` [(name, fn name,
    kwargs)] in order; returns {name: result}."""
    from infinisst_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(*mesh_shape, device="cpu")
    out = {}
    for name, fn, kw in jobs:
        kw = dict(kw)
        if fn == "dryrun":
            from infinisst_tpu_torch.parallel.dryrun import dryrun_multichip

            out[name] = dryrun_multichip("cpu", *mesh_shape)
            continue
        if fn == "fit":
            out[name] = fit(mesh_shape=mesh_shape, **kw)
            continue
        if fn == "refuse_quantized_agent":
            out[name] = _refuse_quantized_agent(mesh, **kw)
            continue
        out[name] = globals()[fn](mesh=mesh, **kw)
    return out


def _refuse_quantized_agent(mesh, cfg, params_np):
    """The agent's ``quantize`` option under tensor parallelism raises;
    returns the message."""
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent,
        InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel

    p, _ = pmesh.shard_params(to_torch(params_np), mesh,
                              pmesh.model_param_specs(cfg), cfg=cfg)
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10,
                                          hi=900), cfg.tokens)
    with tensor_parallel(mesh):
        try:
            InfiniSSTAgent(p, cfg, StreamConfig(max_cache_frames=96,
                                                llm_cache_capacity=192),
                           builder, InfiniSSTOptions(quantize=True),
                           param_dtype=torch.float32, device="cpu")
        except ValueError as e:
            return str(e)
    return None


def split_outside_context(mesh, cfg, params_np, window, ids, patch_start):
    """The errors of forwards on parameters from ``shard_params`` run
    outside ``tensor_parallel``: the prefill (heads read from the leaves)
    and the lm_head alone (a slice of the vocabulary, or of D)."""
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.parallel import mesh as pmesh

    p, _ = pmesh.shard_params(to_torch(params_np), mesh,
                              pmesh.model_param_specs(cfg), cfg=cfg)
    out = []
    try:
        MC.prefill(cfg, p, torch.from_numpy(window), torch.from_numpy(ids),
                   patch_start, "cpu")
    except RuntimeError as e:
        out.append(str(e))
    h = torch.zeros((1, 2, cfg.llama.hidden_size))
    try:
        L._final_logits(p["llama"], cfg.llama, h)
    except RuntimeError as e:
        out.append(str(e))
    return out


def refuse_data_split_pool(mesh, cfg, params_np):
    """A ``ServingEngine`` built under a context whose mesh has 'data'
    above 1 raises; returns the message."""
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel
    from infinisst_tpu_torch.serve.engine import ServingEngine

    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10,
                                          hi=900), cfg.tokens)
    with tensor_parallel(mesh):
        try:
            ServingEngine(to_torch(params_np), cfg, StreamConfig(
                max_cache_frames=96, llm_cache_capacity=192),
                {("English", "German"): builder}, pool_size=2,
                dtype=torch.float32, device="cpu")
        except ValueError as e:
            return str(e)
    return None


def fail_on_rank(rank, world, bad):
    """Raise on rank ``bad`` (the launcher's failure report)."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def dryrun_rank(rank, world, data_ax=None, model_ax=None):
    from infinisst_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip("cpu", data_ax, model_ax)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(fn, rank, world, port, coll_timeout, args, out):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=timedelta(seconds=coll_timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args=(), timeout: float = 120.0
          ) -> List[Any]:
    """``[fn(r, world, *args) for r in range(world)]``, each in its own
    process under gloo; raises RuntimeError with the failing rank's
    traceback, or on ``timeout``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, max(10.0, timeout),
                               args, out),
                         daemon=True)
             for r in range(world)]
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"spawn: {world - len(results)} of {world} ranks did not "
                    f"finish within {timeout:.0f} s (a hung collective?)")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"spawn: a rank exited with code {dead[0].exitcode} "
                        "before reporting")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(world)]
