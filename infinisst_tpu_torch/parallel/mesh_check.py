"""Hold the mesh path on N ranks against one device: the sharded train
step, the tensor-parallel prefill and the tensor-parallel agent, each
against the same computation without a mesh on rank 0's device.

    torchrun --standalone --nproc_per_node 4 \
        -m infinisst_tpu_torch.parallel.mesh_check [--data D --model M] \
        [--device cpu]

On the dryrun preset in float32, on the mesh ``(--data, --model)``
(default: ``dryrun.mesh_axes`` of the world size):

- the sharded step (``zero`` on where n_data > 1), 3 steps, in four
  cases: stage 2, stage 1 with encoder dropout 0.1, stage 0 with
  ``cpo_beta`` 0.5, stage 2 with ``grad_acc_steps`` 2, on a batch of
  max(4, 2 n_data) rows with ragged lengths: loss and grad norm within
  rtol 1e-5 of the one-device step's every step, the parameters by
  ``check_params``;
- the TP prefill logits (``speech_llm.prefill_chunk``) within 1e-5 x
  max|logits|, at the dryrun vocabulary and at 1023 (which divides by
  no axis: the lm_head is split on D);
- the TP agent (beam 2, 4 chunks): its target ids after every chunk
  equal the unsharded agent's.

It prints ``mesh_check OK: ...`` (rank 0) and raises on a mismatch.  The
functions are what ``tests/test_torch_parallel.py``'s ranks run on the
CPU under gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

BLOCK, CACHE = 48, 96
LR = 1e-3
CASES = {  # freeze, grad_acc_steps, cpo_beta, schedule, encoder dropout
    "stage2": ("stage2", 1, 0.0, "cosine", 0.0),
    "stage1_dropout": ("stage1", 1, 0.0, "cosine", 0.1),
    "stage0_cpo": ("stage0", 1, 0.5, "constant", 0.0),
    "stage2_acc2": ("stage2", 2, 0.0, "constant", 0.0),
}


def freeze_of(name):
    from infinisst_tpu_torch.train import step as TT

    return {"stage0": TT.FreezeConfig(), "stage1": TT.FreezeConfig.stage1(),
            "stage2": TT.FreezeConfig.stage2()}[name]


def _to(tree, device):
    from infinisst_tpu_torch.train.step import tree_map

    return tree_map(lambda t: t.clone().to(device), tree)


def train_run(cfg, params, batches, case, device, mesh=None, zero=False,
              n_steps=3):
    """``n_steps`` of ``make_train_step`` (sharded with ``mesh``, ZeRO
    with ``zero`` where n_data > 1) from ``params`` (whole) on
    ``batches`` (whole ``Batch``es, cycled); returns the per-step (loss,
    grad norm) and the whole parameters after the last step, on the
    CPU."""
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.train import step as TT

    fz, acc, cpo, sched, rate = case
    freeze = freeze_of(fz)
    params = _to(params, device)
    plan = None
    if mesh is not None:
        zero = zero and pmesh.mesh_shape(mesh)["data"] > 1
        params, lay = pmesh.shard_params(
            params, mesh, pmesh.model_param_specs(cfg, zero), cfg=cfg)
        plan = TT.MeshPlan(mesh, lay, zero, TT.tree_leaves(
            TT.trainable_mask(params, freeze)))
    tx = TT.make_optimizer(TT.OptimConfig(
        learning_rate=LR, warmup_steps=2, total_steps=6, scheduler=sched),
        params, freeze)
    if acc > 1:
        tx = TT.MultiSteps(tx, acc)
    state = TT.init_train_state(params, tx, plan)
    step = TT.make_train_step(cfg, tx, BLOCK, CACHE, cpo_beta=cpo,
                              freeze=freeze, remat=True,
                              encoder_dropout=rate, dropout_seed=7,
                              plan=plan)
    metrics = []
    for i in range(n_steps):
        b = batches[i % len(batches)]
        state, m = step(state, TT.Batch(*(x.to(device) for x in b)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    whole = state.params
    if plan is not None:
        tidx = [i for i, m in enumerate(tx.mask) if m]
        whole = plan.whole_state(state, tidx).params
    return metrics, _to(whole, "cpu")


def check_params(got, want, mask, initial):
    """Frozen leaves bitwise equal to ``initial``.  Trainable ones within
    rtol 1e-4 and atol 1e-5 x the leaf's largest value, but for at most
    1e-3 of all their entries, and every entry within 10 x lr x 1e-2
    (``tests/test_torch_train_steps.py``'s bound): Adam turns a gradient
    entry that is float32 rounding noise, summed in another order over
    the ranks, into an update of up to about lr.  Trees of CPU tensors
    or numpy arrays; raises AssertionError."""
    from infinisst_tpu_torch.train.step import tree_leaves

    n_far = n_all = 0
    for i, (g, w, m, s) in enumerate(zip(tree_leaves(got),
                                         tree_leaves(want), mask,
                                         tree_leaves(initial))):
        g, w, s = (np.asarray(x) for x in (g, w, s))
        if not m:
            if not np.array_equal(g, s):
                raise AssertionError(f"frozen leaf {i} moved")
            continue
        d = np.abs(g - w)
        if float(d.max()) > 10 * LR * 1e-2:
            raise AssertionError(f"leaf {i}: {float(d.max())} past "
                                 f"10 x lr x 1e-2")
        n_far += int((d > 1e-4 * np.abs(w)
                      + 1e-5 * float(np.abs(w).max())).sum())
        n_all += d.size
    if n_far > 1e-3 * n_all:
        raise AssertionError(f"{n_far} of {n_all} entries past rtol 1e-4 / "
                             f"atol 1e-5 x max")


def check_metrics(got, want, what=""):
    for i, ((l, g), (rl, rg)) in enumerate(zip(got, want)):
        for name, a, b in (("loss", l, rl), ("grad norm", g, rg)):
            if not abs(a - b) <= 1e-5 * abs(b):
                raise AssertionError(f"{what} step {i} {name}: {a} against "
                                     f"{b}")


def _states(cfg, p, device):
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.streaming.state import (
        init_decoder_state,
        init_encoder_state,
    )

    enc = init_encoder_state(cfg.w2v2.encoder_layers, 1, CACHE,
                             W.local_heads(p["w2v2"], cfg.w2v2),
                             cfg.w2v2.head_dim, torch.float32, device)
    dec = init_decoder_state(cfg.llama.num_layers, 1, 128,
                             L.local_heads(p["llama"]["layers"],
                                           cfg.llama)[1],
                             cfg.llama.head_dim, torch.float32, device)
    return enc, dec


def prefill(cfg, params, window, ids, patch_start, device, mesh=None):
    """One ``speech_llm.prefill_chunk`` from fresh states (TP with
    ``mesh``): the logits on the CPU and the cache's valid length."""
    from infinisst_tpu_torch.models import speech_llm
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel

    p = _to(params, device)
    if mesh is not None:
        p, _ = pmesh.shard_params(p, mesh, pmesh.model_param_specs(cfg),
                                  cfg=cfg)
    with torch.no_grad(), tensor_parallel(mesh):
        enc, dec = _states(cfg, p, device)
        logits, st = speech_llm.prefill_chunk(
            p, cfg, speech_llm.StreamState(enc, dec), window.to(device),
            ids.to(device), patch_start, BLOCK, CACHE)
    return logits.cpu(), int(st.decoder.valid_len[0])


def agent_tokens(cfg, params, audio, device, mesh=None):
    """The dryrun agent of ``tests/test_tp_agent.py`` (beam 2, 4 chunks,
    the last finished; TP with ``mesh``): its target ids after every
    chunk, the encoder's frames and whether it finished."""
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent,
        InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel

    p = _to(params, device)
    if mesh is not None:
        p, _ = pmesh.shard_params(p, mesh, pmesh.model_param_specs(cfg),
                                  cfg=cfg)
    stream = StreamConfig(max_cache_frames=96, max_llm_cache_tokens=80,
                          llm_cache_capacity=192)
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10,
                                          hi=900), cfg.tokens)
    opts = InfiniSSTOptions(latency_multiplier=1, beam=2,
                            max_llm_cache_size=80,
                            no_repeat_ngram_lookback=16)
    out = []
    with tensor_parallel(mesh):
        agent = InfiniSSTAgent(p, cfg, stream, builder, opts,
                               param_dtype=torch.float32, device=device)
        for i, chunk in enumerate(audio):
            act = agent.push(chunk, finished=(i == len(audio) - 1))
            out.append(list(agent.states.target_ids))
        n_frames = int(agent.enc_state.n_frames[0])
    return out, n_frames, bool(act.finished)


def vocab_config(vocab: int):
    from infinisst_tpu_torch.core.presets import dryrun_config

    cfg = dryrun_config()
    return cfg.replace(llama=dataclasses.replace(cfg.llama,
                                                 vocab_size=vocab))


def train_batch(cfg, rows: int = 4):
    """A batch of ``rows`` rows of seeded noise with ragged frame lengths
    and patch counts (CPO's pairs split over n_data ranks need rows
    divisible by 2 n_data)."""
    from infinisst_tpu_torch.train.step import Batch

    rng = np.random.RandomState(0)
    n_frames = 96
    sp = n_frames // 4
    S = sp + 12
    ids = np.full((rows, S), 7, np.int64)
    lengths = [n_frames - 16 * (r % 3) for r in range(rows)]
    patches = [n // 4 for n in lengths]
    pm = np.zeros((rows, S), bool)
    for r, n in enumerate(patches):
        pm[r, 2:2 + n] = True
    ids[pm] = cfg.tokens.sp_patch % cfg.llama.vocab_size
    ids[:, sp + 4:] = rng.randint(10, 900, size=(rows, S - sp - 4))
    labels = np.where(np.arange(S)[None] >= sp + 4, ids, -100)
    return Batch(
        speech=torch.from_numpy(
            rng.randn(rows, 399 + n_frames * 320).astype(np.float32) * 0.1),
        frame_lengths=torch.tensor(lengths, dtype=torch.int32),
        input_ids=torch.from_numpy(ids.astype(np.int32)),
        labels=torch.from_numpy(labels.astype(np.int32)),
        attention_mask=torch.ones((rows, S), dtype=torch.int32),
        patch_mask=torch.from_numpy(pm))


def check(device, data_ax=None, model_ax=None) -> str:
    """Run every check on the process group's ranks; rank 0 compares and
    prints.  Returns the summary line."""
    import torch.distributed as dist

    from infinisst_tpu_torch.core.presets import dryrun_config
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.dryrun import mesh_axes
    from infinisst_tpu_torch.train import step as TT
    from infinisst_tpu_torch.train.main import random_params

    dev = torch.device(device)
    if data_ax is None or model_ax is None:
        data_ax, model_ax = mesh_axes(dist.get_world_size())
    mesh = pmesh.make_mesh(data_ax, model_ax, dev)
    rank0 = dist.get_rank() == 0
    cfg = dryrun_config()
    params = random_params(cfg, "cpu", torch.float32)
    batch = train_batch(cfg, rows=max(4, 2 * data_ax))  # CPO pairs split
    for name, case in CASES.items():
        got = train_run(cfg, params, [batch], case, dev, mesh, zero=True)
        if rank0:
            want = train_run(cfg, params, [batch], case, dev)
            check_metrics(got[0], want[0], name)
            mask = TT.tree_leaves(TT.trainable_mask(params,
                                                    freeze_of(case[0])))
            check_params(got[1], want[1], mask, params)
    pr = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10, hi=900),
                       cfg.tokens).chunk_prompt(1, first=True)
    window = torch.from_numpy((np.random.RandomState(3).randn(
        1, 399 + 2 * 15360) * 0.1).astype(np.float32))
    worst = 0.0
    for vocab in (cfg.llama.vocab_size, 1023):
        vcfg = vocab_config(vocab)
        vp = random_params(vcfg, "cpu", torch.float32)
        ids = torch.as_tensor(np.asarray(pr.ids) % vocab)[None]
        got = prefill(vcfg, vp, window, ids, pr.patch_start, dev, mesh)
        if rank0:
            want = prefill(vcfg, vp, window, ids, pr.patch_start, dev)
            err = float((got[0] - want[0]).abs().max())
            scale = float(want[0].abs().max())
            if got[1] != want[1] or err > 1e-5 * scale:
                raise AssertionError(f"prefill at vocab {vocab}: {err} of "
                                     f"{scale}")
            worst = max(worst, err / scale)
    audio = [(np.random.RandomState(0).randn(15360) * 0.1).astype(np.float32)
             for _ in range(4)]
    got = agent_tokens(cfg, params, audio, dev, mesh)
    want = agent_tokens(cfg, params, audio, dev) if rank0 else None
    if rank0 and got != want:
        raise AssertionError(f"TP agent tokens {got} against {want}")
    line = (f"mesh_check OK: mesh=({data_ax}x{model_ax}) on {dev.type}: the "
            f"sharded step equals one device's in {len(CASES)} cases "
            f"(ZeRO {'on' if data_ax > 1 else 'off'}), the TP prefill "
            f"within {worst:.2e} x max|logits| at vocabularies "
            f"{cfg.llama.vocab_size} and 1023, the TP agent's "
            f"{len(got[0][-1])} target ids equal chunk by chunk")
    if rank0:
        print(line, flush=True)
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
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        check(dev, args.data, args.model)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
