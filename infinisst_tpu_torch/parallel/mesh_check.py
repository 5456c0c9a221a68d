"""Hold the mesh path on N ranks against one device: the sharded train
step, the tensor-parallel prefill, the tensor-parallel agent and the
serving pool split over 'data', each against the same computation
without a mesh on rank 0's device.

    torchrun --standalone --nproc_per_node 4 \
        -m infinisst_tpu_torch.parallel.mesh_check [--data D --model M] \
        [--device cpu]

On the dryrun preset in float32, on the mesh ``(--data, --model)``
(default: ``dryrun.mesh_axes`` of the world size):

- the sharded step (``zero`` on where n_data > 1: the parameters split
  over 'data' too, FSDP), 3 steps, in four
  cases: stage 2, stage 1 with encoder dropout 0.1, stage 0 with
  ``cpo_beta`` 0.5, stage 2 with ``grad_acc_steps`` 2, on a batch of
  max(4, 2 n_data) rows with ragged lengths: loss and grad norm within
  rtol 1e-5 of the one-device step's every step, the parameters by
  ``check_params``; in ``PROGRAM_CASES`` the sharded step as
  ``TrainProgram`` (captured on a card, the NCCL collectives inside its
  graphs) equal to the eager sharded step bitwise, with deterministic
  algorithms on;
- the TP prefill logits (``speech_llm.prefill_chunk``) within 1e-5 x
  max|logits|, at the dryrun vocabulary and at 1023 (which divides by
  no axis: the lm_head is split on D);
- the TP agent (beam 2, 4 chunks): its target ids after every chunk
  equal the unsharded agent's;
- the serving pool split over 'data' (``POOL_MODES``: beam 2 with mixed
  multipliers and a trim, speculative greedy whose guard trips,
  speculative sampling), served from FSDP-sharded parameters: every
  tick's output, every slot's tokens, the guard's state and the
  statistics equal the one-rank pool's.

It prints ``mesh_check OK: ...`` (rank 0) and raises on a mismatch.  The
functions are what ``tests/test_torch_parallel.py``'s ranks run on the
CPU under gloo.

``--flagship-pool`` (at n_model 1: the int8 leaves are not split over
'model') adds the flagship W8A8 pool (``flagship_pool``): 8 streams a
data rank at beam 4, then the speculative greedy pool (``SPEC_POOL``,
its round's ``go`` or'ed over 'data' inside the captured round), split
over 'data' (its tick the captured program,
the NCCL collectives of 'data' and of FSDP's gathers inside its CUDA
graphs), against the same streams on
rank 0's card in pools of the rows each data rank holds, token by token
every tick; beside it the slots in which one card's pool of all the
streams differs from those pools (its bf16 kernels run at another row
count, and random weights leave near-ties), and the split pool's tokens
a second against that pool's; it prints ``flagship pool OK: ...``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
# the cases whose sharded step also runs as ``TrainProgram``, held
# bitwise to the eager sharded step
PROGRAM_CASES = ("stage1_dropout", "stage2_acc2")


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (and cuDNN's) within: the convolutions'
    and the embedding's backward passes otherwise accumulate in any
    order on a card, and two runs of one step differ in the last bits.
    Uninitialised memory is not filled (the mode's default), so that a
    step launches the kernels it launches outside the mode."""
    import torch.utils.deterministic as det

    prev = torch.are_deterministic_algorithms_enabled()
    prev_cudnn = torch.backends.cudnn.deterministic
    prev_fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)
        torch.backends.cudnn.deterministic = prev_cudnn
        det.fill_uninitialized_memory = prev_fill


def same_run(a, b) -> bool:
    """Two ``train_run`` results bitwise equal: metrics and parameters."""
    from infinisst_tpu_torch.train.step import tree_leaves

    return a[0] == b[0] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a[1]),
                                          tree_leaves(b[1])))


def freeze_of(name):
    from infinisst_tpu_torch.train import step as TT

    return {"stage0": TT.FreezeConfig(), "stage1": TT.FreezeConfig.stage1(),
            "stage2": TT.FreezeConfig.stage2()}[name]


def _to(tree, device):
    from infinisst_tpu_torch.train.step import tree_map

    return tree_map(lambda t: t.clone().to(device), tree)


def train_run(cfg, params, batches, case, device, mesh=None, zero=False,
              n_steps=3, program=False):
    """``n_steps`` of ``make_train_step`` (sharded with ``mesh``, FSDP
    with ``zero`` where n_data > 1) from ``params`` (whole) on
    ``batches`` (whole ``Batch``es, cycled); returns the per-step (loss,
    grad norm) and the whole parameters after the last step, on the
    CPU.  With ``program`` the steps run as ``TrainProgram`` (captured
    on a card)."""
    from infinisst_tpu_torch.core import graphs
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
        plan = TT.MeshPlan(mesh, lay)
    tx = TT.make_optimizer(TT.OptimConfig(
        learning_rate=LR, warmup_steps=2, total_steps=6, scheduler=sched),
        params, freeze)
    if acc > 1:
        tx = TT.MultiSteps(tx, acc)
    state = TT.init_train_state(params, tx)
    kw = dict(cpo_beta=cpo, freeze=freeze, remat=True, encoder_dropout=rate,
              dropout_seed=7, plan=plan)
    if program:
        prog = TT.TrainProgram(cfg, tx, BLOCK, CACHE, device, **kw)
    else:
        step = TT.make_train_step(cfg, tx, BLOCK, CACHE, **kw)
    metrics = []
    for i in range(n_steps):
        b = TT.Batch(*(x.to(device) for x in batches[i % len(batches)]))
        if program:
            state, m = prog(state, b)
            metrics.append(tuple(graphs.read(m["packed"])))
        else:
            state, m = step(state, b)
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
    chunk, the encoder's frames and whether it finished.  On CUDA its
    chunk program is captured (with the mesh's collectives in the graphs)
    and the later chunks replay it; this raises if none did."""
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
    if agent.device.type == "cuda" and not any(
            p.replays for p in agent._programs.values()):
        raise AssertionError("the agent's chunk program never replayed")
    return out, n_frames, bool(act.finished)


POOL = 4  # rows: 2 a rank at (2, x), 1 at (4, 1)
POOL_MODES = {
    "beam2_mixed_m": dict(beam=2, multipliers=(1, 2)),
    "spec_greedy": dict(speculative=True, spec_draft_layers=1, spec_k=3,
                        spec_guard_patience=2),
    "spec_sample": dict(speculative=True, spec_draft_layers=1, spec_k=3,
                        do_sample=True, temperature=1.2, top_k=8,
                        sample_seed=5),
}


def pool_ticks(cfg, params, mode, device, mesh=None, n_ticks=5):
    """A ``ServingEngine`` of ``POOL`` rows (three streams, the second at
    m = 2 where the mode allows it, one slot idle) fed seeded noise for
    ``n_ticks`` ticks; with ``mesh`` the pool is split over its 'data'
    axis and the parameters are sharded with ``zero`` (FSDP).  Returns
    per tick (the tick's output, every slot's target ids, the guard's
    state, the speculative statistics, the forwards)."""
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel import mesh as pmesh
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel
    from infinisst_tpu_torch.serve.engine import ServingEngine

    p = _to(params, device)
    if mesh is not None:
        p, _ = pmesh.shard_params(p, mesh, pmesh.model_param_specs(
            cfg, zero=True), cfg=cfg)
    kw = POOL_MODES[mode]
    stream = StreamConfig(max_cache_frames=96, max_llm_cache_tokens=80,
                          llm_cache_capacity=192)
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size, lo=10,
                                          hi=900), cfg.tokens)
    rng = np.random.RandomState(11)
    out = []
    with torch.no_grad(), tensor_parallel(mesh):
        eng = ServingEngine(p, cfg, stream, {("English", "German"):
                                             builder},
                            pool_size=POOL, dtype=torch.float32,
                            device=device, **kw)
        ms = (1, 2, 1) if 2 in kw.get("multipliers", ()) else (1, 1, 1)
        slots = [eng.open_stream(f"c{i}", multiplier=m)
                 for i, m in enumerate(ms)]
        for _ in range(n_ticks):
            for s, m in zip(slots, ms):
                eng.push_audio(s, (rng.randn(stream.chunk_samples(1))
                                   * 0.1).astype(np.float32))
            text = eng.tick()
            out.append((text, [list(eng.slots[s].target_ids)
                               for s in slots],
                        eng.spec_fallback_active, dict(eng.spec_stats),
                        dict(eng.forwards)))
    return out


def pool_run(cfg, params, audio, rows, beam, device, mesh=None, **kw):
    """A W8A8 pool of ``len(rows)`` slots at ``beam`` (``kw``: more of
    the engine's options), slot i streaming ``audio[:, rows[i]]`` (one
    960 ms chunk a tick), built and ticked under ``tensor_parallel(mesh)``
    (with a mesh whose 'data' is above 1: split over it); on the card its
    tick is the captured program, which must have replayed.  Returns per
    tick every slot's tokens, and the tokens a second after the first
    tick (host clock, synchronised)."""
    import time

    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.parallel.collectives import tensor_parallel
    from infinisst_tpu_torch.serve.engine import ServingEngine

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ticks, n_tok, wall = [], 0, 0.0
    with torch.no_grad(), tensor_parallel(mesh):
        eng = ServingEngine(
            params, cfg, StreamConfig(), {("English", "German"): PromptBuilder(
                StubTokenizer(cfg.llama.vocab_size), cfg.tokens)},
            pool_size=len(rows), beam=beam, dtype=torch.bfloat16,
            device=device, **kw)
        slots = [eng.open_stream(f"s{r}") for r in rows]
        for t in range(audio.shape[0]):
            for s, r in zip(slots, rows):
                eng.push_audio(s, audio[t, r])
            before = sum(len(eng.slots[s].target_ids) for s in slots)
            sync()
            t0 = time.perf_counter()
            eng.tick()
            sync()
            if t:  # the first tick warms up
                wall += time.perf_counter() - t0
                n_tok += sum(len(eng.slots[s].target_ids)
                             for s in slots) - before
            ticks.append([list(eng.slots[s].target_ids) for s in slots])
    if device.type == "cuda" and not any(p.replays
                                         for p in eng._programs.values()):
        raise AssertionError("the pool's tick program never replayed")
    return ticks, n_tok / wall


# the speculative flagship pool (``--flagship-pool``): greedy at d = 8,
# k = 4 on the flagship with the layers above the draft made identities
# (``bench.scale_residuals(..., 0)``, so that rounds accept), no guard;
# its round's ``go`` is or'ed over 'data' by an NCCL all-reduce inside
# the captured round
SPEC_POOL = dict(speculative=True, spec_draft_layers=8, spec_k=4,
                 spec_guard=False)


def flagship_pool(device, mesh, rows_per_rank=8, beam=4, n_ticks=4,
                  **kw):
    """The flagship W8A8 pool (seeded random weights, ``bench``'s; with
    ``kw`` the speculative one, ``SPEC_POOL``) of ``rows_per_rank`` x
    n_data slots at ``beam``, every slot streaming
    seeded noise for ``n_ticks`` ticks, split over the mesh's 'data' axis
    from FSDP-sharded float leaves (the int8 leaves whole).  Rank 0 then
    runs the same streams on its card without a mesh: in pools of the
    rows each data rank holds, and in one pool of them all.  Returns the
    split pool's ``pool_run`` and its peak GiB on this card, and on rank 0 (None elsewhere) the
    blocks' ticks joined slot by slot and the whole pool's
    ``pool_run``."""
    import torch.distributed as dist

    from infinisst_tpu_torch.bench import flagship_params
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.parallel import mesh as pmesh

    cfg, whole = flagship_params(device)
    if kw:
        from infinisst_tpu_torch.bench import scale_residuals

        whole = scale_residuals(whole, kw["spec_draft_layers"], 0.0)
    n_data = pmesh.mesh_shape(mesh)["data"]
    local, _ = pmesh.shard_params(whole, mesh, pmesh.model_param_specs(
        cfg, zero=True))
    pool = rows_per_rank * n_data
    audio = (np.random.RandomState(21).randn(
        n_ticks, pool, StreamConfig().chunk_samples(1)) * 0.1).astype(
            np.float32)
    split = pool_run(cfg, local, audio, range(pool), beam, device, mesh,
                     **kw)
    # the split pool's peak on this card (its graphs' pool holds the
    # parameters FSDP gathers inside the captured forwards)
    split += (torch.cuda.max_memory_allocated(device) / 2**30
              if device.type == "cuda" else 0.0,)
    del local
    if dist.get_rank() != 0:
        return split, None, None
    blocks = [pool_run(cfg, whole, audio, range(r * rows_per_rank,
                                                (r + 1) * rows_per_rank),
                       beam, device, **kw)[0] for r in range(n_data)]
    joined = [sum((b[t] for b in blocks), []) for t in range(n_ticks)]
    return split, joined, pool_run(cfg, whole, audio, range(pool), beam,
                                   device, **kw)


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
        with deterministic():
            got = train_run(cfg, params, [batch], case, dev, mesh, zero=True)
            if name in PROGRAM_CASES and not same_run(got, train_run(
                    cfg, params, [batch], case, dev, mesh, zero=True,
                    program=True)):
                raise AssertionError(f"{name}: the sharded step as a "
                                     "program differs from the eager one")
        if rank0:
            want = train_run(cfg, params, [batch], case, dev)
            check_metrics(got[0], want[0], name)
            mask = TT.tree_leaves(TT.trainable_mask(params,
                                                    freeze_of(case[0])))
            check_params(got[1], want[1], mask, params)
    steps = (f"mesh=({data_ax}x{model_ax}) on {dev.type}: the sharded step "
             f"equals one device's in {len(CASES)} cases (FSDP "
             f"{'on' if data_ax > 1 else 'off'}), and as a program"
             f"{' captured as CUDA graphs' if dev.type == 'cuda' else ''} "
             f"the eager sharded step's bitwise in {len(PROGRAM_CASES)}")
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
    n_pool = 0
    for mode in POOL_MODES:
        pg = pool_ticks(cfg, params, mode, dev, mesh)
        if rank0:
            pw = pool_ticks(cfg, params, mode, dev)
            if pg != pw:
                raise AssertionError(f"split pool {mode}: {pg} against "
                                     f"{pw}")
            n_pool += sum(map(len, pg[-1][1]))
    line = (f"mesh_check OK: {steps}, the TP prefill "
            f"within {worst:.2e} x max|logits| at vocabularies "
            f"{cfg.llama.vocab_size} and 1023, the TP agent's "
            f"{len(got[0][-1])} target ids equal chunk by chunk"
            f"{' (captured as CUDA graphs)' if dev.type == 'cuda' else ''}"
            f", the pool "
            f"of {POOL} split over {data_ax} data rank(s) equal to one "
            f"rank's in {len(POOL_MODES)} modes ({n_pool} tokens)")
    if rank0:
        print(line, flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--model", type=int, default=None)
    ap.add_argument("--flagship-pool", action="store_true")
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
        if args.flagship_pool:
            from infinisst_tpu_torch.parallel import mesh as pmesh
            from infinisst_tpu_torch.parallel.dryrun import mesh_axes

            d, m = ((args.data, args.model) if args.data and args.model
                    else mesh_axes(dist.get_world_size()))
            for label, beam, kw in (("beam 4", 4, {}),
                                    ("speculative d8 k4", 1, SPEC_POOL)):
                (split, split_tps, split_peak), blocks, one = flagship_pool(
                    dev, pmesh.make_mesh(d, m, dev), beam=beam, **kw)
                if dist.get_rank() != 0:
                    continue
                if split != blocks:
                    raise AssertionError(
                        f"flagship pool ({label}) split over {d}: {split} "
                        f"against one card's pools of the rows a card "
                        f"holds {blocks}")
                n = len(split[0])
                flips = sum(a != b for a, b in zip(split[-1], one[0][-1]))
                print(f"flagship pool OK: {n} W8A8 streams ({label}) split "
                      f"over data {d} ({n // d} rows a card), "
                      f"{len(split)} ticks, captured, token-equal every "
                      f"tick with "
                      f"one card's pools of {n // d} holding the same "
                      f"streams; {sum(map(len, split[-1]))} tokens; one "
                      f"card's pool of all {n}: {flips} of {n} slots "
                      f"differ from its pools of {n // d} (bf16 kernels "
                      f"of another row count); {split_tps:.2f} tok/s "
                      f"split against {one[1]:.2f} tok/s in one card's "
                      f"pool of {n} (after the first tick); the split "
                      f"pool's peak {split_peak:.2f} GiB on rank 0's card",
                      flush=True)
    finally:
        # graphs that hold the group's communicators go before the group
        gc.collect()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
