"""The port's mesh on the CPU: ranks in processes spawned under gloo
(``tests/torch_mesh_workers.spawn``: one thread a rank, a free localhost
port, every rank joined within its own timeout and killed past it), one
spawn per mesh shape running all of that shape's jobs (the rank
functions of ``tests/torch_mesh_workers.py``):

- the sharded train step at meshes (2, 1), (1, 2) and (2, 2), ``zero``
  (FSDP: every leaf split over 'data' too) on and off, against the
  one-card port step, on the dryrun preset with
  its conv extractor narrowed (``test_torch_train.py``'s weights and
  padded four-row batch), 3 steps each: stage 2, stage 1 with encoder
  dropout 0.1, stage 0 with ``cpo_beta`` 0.5 and stage 2 with
  ``grad_acc_steps`` 2.  Loss and grad norm rtol 1e-5 every step; the
  parameters after the last step within rtol 1e-4 and atol 1e-5 x the
  leaf's largest value but for at most 1e-3 of the entries, all within
  10 x lr x 1e-2 (Adam's updates of float32 noise, ``_check_params``);
  frozen leaves bitwise.  The (2, 2) FSDP stage 2
  run is also held against JAX's one-device ``make_train_step``.  At
  (2, 1) with FSDP the steps of ``mesh_check.PROGRAM_CASES`` also run as
  ``TrainProgram``, held to the one-card step as above and to the eager
  sharded step bitwise;
- the TP prefill logits at (1, 2) and (1, 4), with a vocabulary that
  divides (the lm_head split on V) and one that does not (1023: moved
  onto D, row-parallel), within 1e-5 x max|logits|;
- the TP agent (dryrun preset, model 4, beam 2, 4 chunks): its tokens
  equal the unsharded agent's chunk by chunk, on every rank;
- checkpoints: saved at world 2 and restored at world 1, and the other
  way round; the next step equals the uninterrupted run's;
- the dryrun's five parts at (2, 2) (the 8-rank (2, 4) dryrun is marked
  slow, as JAX's ``test_dryrun_multichip_8``);
- the serving pool split over 'data' at (2, 1), from FSDP-sharded
  parameters, tick by tick against the one-rank pool in three modes
  (``mesh_check.POOL_MODES``): beam 2 with mixed multipliers, speculative
  greedy whose guard trips, speculative sampling;
- the refusals: an ``n_model`` that splits a head, quantized parameters
  under ``n_model > 1``, a pool that 'data' does not divide, and split
  parameters run outside ``tensor_parallel``;
- a stage 1 FSDP step at (2, 1) gathers every split leaf once where it is
  used and reduce-scatters only the trained ones' gradients, and gathers
  nothing after the update;
- ``tools.memplan``'s reckoned parameter bytes at (2, 1) equal what a
  rank holds.
"""

import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from infinisst_tpu.train import step as JT
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core.presets import dryrun_config
from infinisst_tpu_torch.parallel import mesh as pmesh
from infinisst_tpu_torch.parallel import mesh_check as MC
from infinisst_tpu_torch.train import step as TT
from infinisst_tpu_torch.train.main import random_params
from tests import torch_mesh_workers as W
from tests.test_torch_train import BLOCK, CACHE, CFG, JCFG, KEYS, make_setup
from tests.test_torch_trainer import _make_data
from tests.torch_mesh_workers import spawn

torch.set_num_threads(1)

CASES = MC.CASES  # freeze, grad_acc_steps, cpo_beta, schedule, dropout
MESHES = [(2, 1), (1, 2), (2, 2)]
# zero splits over 'data' only: at (1, 2) it is off
STEP_RUNS = [(m, c, z, False) for m in MESHES for c in CASES
             for z in ((True, False) if m[0] > 1 else (False,))] + [
    ((2, 1), c, True, True) for c in MC.PROGRAM_CASES]
TP_MESHES = [(1, 2), (1, 4)]
VOCABS = (1024, 1023)
TIMEOUT = 240  # seconds a spawn may take before its ranks are killed


def _np_tree(tree):
    return W.to_numpy(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module and the one-card references.  The spawns
    run two at a time in threads while this process computes the
    references."""
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    jp, npp, jb, tb = make_setup()
    batch = {k: getattr(tb, k).numpy() for k in KEYS}
    params = _np_tree(from_jax(npp, device="cpu"))

    # the prefill's and the agent's inputs
    cfg0 = dryrun_config()
    pr = PromptBuilder(StubTokenizer(cfg0.llama.vocab_size, lo=10, hi=900),
                       cfg0.tokens).chunk_prompt(1, first=True)
    rng = np.random.RandomState(3)
    window = (rng.randn(1, 399 + 2 * 15360) * 0.1).astype(np.float32)
    pre_kw = {}
    for v in VOCABS:
        cfg = MC.vocab_config(v)
        pre_kw[v] = dict(
            cfg=cfg, params_np=_np_tree(random_params(cfg, "cpu",
                                                      torch.float32)),
            window=window, ids=(np.asarray(pr.ids) % v)[None].astype(
                np.int64), patch_start=pr.patch_start)
    agent_params = _np_tree(random_params(cfg0, "cpu", torch.float32))
    audio = [(np.random.RandomState(0).randn(15360) * 0.1).astype(np.float32)
             for _ in range(4)]
    akw = dict(cfg=cfg0, params_np=agent_params, audio=audio)

    # checkpoints: a world-1 fit of 2 steps, resumed to 3 at world 1 (the
    # reference: a resumed fit starts its epoch again, as JAX's does) and
    # at world 2; a world-2 fit of 2 steps, resumed at world 1
    d = tmp_path_factory.mktemp("mesh_ckpt")
    _make_data(d, n=8, text=False)
    fkw = dict(cfg=cfg0, params_np=_np_tree(random_params(
        cfg0, "cpu", torch.float32)), data_dir=str(d))
    W.fit(save_dir=str(d / "w1"), max_steps=2, mesh_shape=(1, 1), **fkw)
    shutil.copytree(d / "w1", d / "w1_again")

    def train_jobs(mesh):
        return [(_job(c, z, p), "train_run",
                 dict(cfg=CFG, params_np=params, batches=[batch],
                      case=CASES[c], zero=z, program=p))
                for m, c, z, p in STEP_RUNS if m == mesh]

    jobs = {
        (2, 2): train_jobs((2, 2)) + [("dryrun", "dryrun", {})],
        (2, 1): train_jobs((2, 1)) + [
            ("zero collectives", "zero_collectives",
             dict(cfg=CFG, params_np=params, batches=[batch],
                  case=CASES["stage1_dropout"])),
            ("data-split pool", "refuse_data_split_pool",
             dict(cfg=cfg0, params_np=agent_params)),
            ("memplan bytes", "memplan_bytes",
             dict(cfg=cfg0, params_np=agent_params))] + [
            (f"pool {mode}", "pool_ticks",
             dict(cfg=cfg0, params_np=agent_params, mode=mode))
            for mode in MC.POOL_MODES] + [
            ("fit w2 from scratch", "fit",
             dict(save_dir=str(d / "w2"), max_steps=2, **fkw)),
            ("fit w2 resuming w1", "fit",
             dict(save_dir=str(d / "w1"), max_steps=3, **fkw))],
        (1, 2): train_jobs((1, 2)) + [
            (f"prefill {v}", "prefill", pre_kw[v]) for v in VOCABS] + [
            ("quantized agent", "refuse_quantized_agent",
             dict(cfg=cfg0, params_np=agent_params))] + [
            (f"outside context {v}", "split_outside_context", pre_kw[v])
            for v in VOCABS],
        (1, 4): [(f"prefill {v}", "prefill", pre_kw[v]) for v in VOCABS]
        + [("agent", "agent_tokens", akw)],
    }
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {mesh: pool.submit(spawn, W.run_jobs, mesh[0] * mesh[1],
                                     (mesh, js), TIMEOUT)
                   for mesh, js in jobs.items()}
        ref = {c: W.train_run(CFG, params, [batch], CASES[c])
               for c in CASES}
        pre = {v: W.prefill(**pre_kw[v]) for v in VOCABS}
        agent_ref = W.agent_tokens(**akw)
        pool_ref = {mode: W.pool_ticks(cfg0, agent_params, mode)
                    for mode in MC.POOL_MODES}
        resumed = W.fit(save_dir=str(d / "w1_again"), max_steps=3,
                        mesh_shape=(1, 1), **fkw)
        got = {mesh: f.result() for mesh, f in futures.items()}

    # the world-2 checkpoint resumed at world 1
    resumed_w1 = W.fit(save_dir=str(d / "w2"), max_steps=3,
                       mesh_shape=(1, 1), **fkw)
    return dict(jp=jp, jb=jb, params=params, ref=ref, pre=pre,
                agent_ref=agent_ref, pool_ref=pool_ref, resumed=resumed,
                resumed_w1=resumed_w1, got=got)


def _leaves(tree):
    return TT.tree_leaves(tree)


def _check_params(got, want, mask, initial):
    """``mesh_check.check_params``: frozen leaves bitwise; all but 1e-3
    of the trainable entries within rtol 1e-4 / atol 1e-5 x the leaf's
    largest value, every entry within 10 x lr x 1e-2 (Adam's updates of
    float32 noise)."""
    MC.check_params(got, want, mask, initial)


def _job(case, zero, program):
    return f"{case}/zero{zero}" + ("/program" if program else "")


@pytest.mark.parametrize("mesh,case,zero,program", STEP_RUNS,
                         ids=[f"{m[0]}x{m[1]}-{c}-zero{int(z)}"
                              + ("-program" if p else "")
                              for m, c, z, p in STEP_RUNS])
def test_sharded_step_matches_one_card(runs, mesh, case, zero, program):
    ref_metrics, ref_params = runs["ref"][case]
    per_rank = runs["got"][mesh]
    for rank, out in enumerate(per_rank):
        metrics, params = out[_job(case, zero, program)]
        if program:  # the program: bitwise the eager sharded step
            eager = out[_job(case, zero, False)]
            assert metrics == eager[0], rank
            for a, b in zip(_leaves(params), _leaves(eager[1])):
                np.testing.assert_array_equal(a, b)
        for i, ((l, g), (rl, rg)) in enumerate(zip(metrics, ref_metrics)):
            np.testing.assert_allclose(l, rl, rtol=1e-5,
                                       err_msg=f"rank {rank} step {i} loss")
            np.testing.assert_allclose(g, rg, rtol=1e-5,
                                       err_msg=f"rank {rank} step {i} norm")
        mask = _leaves(TT.trainable_mask(params,
                                         MC.freeze_of(CASES[case][0])))
        _check_params(params, ref_params, mask, runs["params"])


def test_sharded_step_matches_jax(runs):
    """The (2, 2) FSDP stage 2 run against JAX's one-device step on the
    same weights (carried across by ``from_jax``) and batch."""
    freeze = JT.FreezeConfig.stage2()
    jtx = JT.make_optimizer(JT.OptimConfig(
        learning_rate=W.LR, warmup_steps=2, total_steps=6,
        scheduler="cosine"), runs["jp"], freeze)
    js = JT.init_train_state(runs["jp"], jtx)
    jstep = jax.jit(JT.make_train_step(JCFG, jtx, BLOCK, CACHE,
                                       freeze=freeze, remat=True))
    metrics, params = runs["got"][(2, 2)][0]["stage2/zeroTrue"]
    for i in range(3):
        js, jm = jstep(js, runs["jb"])
        np.testing.assert_allclose(metrics[i][0], float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(metrics[i][1], float(jm["grad_norm"]),
                                   rtol=1e-5)
    want = _np_tree(from_jax(jax.device_get(js.params), device="cpu"))
    mask = _leaves(TT.trainable_mask(params, TT.FreezeConfig.stage2()))
    _check_params(params, want, mask, runs["params"])


@pytest.mark.parametrize("mesh", TP_MESHES, ids=["1x2", "1x4"])
@pytest.mark.parametrize("vocab", VOCABS)
def test_tp_prefill_matches_unsharded(runs, mesh, vocab):
    want, want_len = runs["pre"][vocab]
    got, got_len = runs["got"][mesh][0][f"prefill {vocab}"]
    assert got.shape == want.shape and got_len == want_len
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    # the lm_head's layout: split on V where it divides, else moved to D
    spec = pmesh.sanitize_spec((128, vocab), pmesh.P(None, "model"),
                               {"data": 1, "model": mesh[1]})
    assert spec == ((None, "model") if vocab % mesh[1] == 0
                    else ("model", None))


def test_tp_agent_tokens_match_unsharded(runs):
    want, frames, finished = runs["agent_ref"]
    assert finished and frames == 4 * 48
    for rank, out in enumerate(runs["got"][(1, 4)]):
        got = out["agent"]
        assert got[1:] == (frames, finished), rank
        for i, (g, w) in enumerate(zip(got[0], want)):
            assert g == w, (rank, i, g, w)


@pytest.mark.parametrize("direction", ["w2_to_w1", "w1_to_w2"])
def test_checkpoint_crosses_world_sizes(runs, direction):
    step_s, want = runs["resumed"]
    if direction == "w2_to_w1":
        assert runs["got"][(2, 1)][0]["fit w2 from scratch"][0] == 2
        step, got = runs["resumed_w1"]
    else:
        step, got = runs["got"][(2, 1)][0]["fit w2 resuming w1"]
    assert step == step_s == 3
    mask = _leaves(TT.trainable_mask(got, TT.FreezeConfig.stage2()))
    _check_params(got, want, mask, want)  # frozen: as the straight run's


def test_zero_step_gathers_only_trained_leaves(runs):
    """A stage 1 FSDP step at (2, 1): every leaf 'data' splits, the frozen
    LLM's too, is all-gathered once where the forward uses it; only the
    trained ones' gradients are reduce-scattered, once; nothing is
    gathered after the update (the counts are whole elements)."""
    for rank, out in enumerate(runs["got"][(2, 1)]):
        c = out["zero collectives"]
        assert c["split_frozen"] > 0 and c["split_trainable"] > 0, c
        assert c["gathered"] == c["split_trainable"] + c["split_frozen"], (
            rank, c)
        assert c["scattered"] == c["split_trainable"], (rank, c)


@pytest.mark.parametrize("mode", list(MC.POOL_MODES))
def test_split_pool_matches_one_rank(runs, mode):
    """One pool of 4 rows split over 'data' at (2, 1), from FSDP-sharded
    parameters: every tick's output, every slot's tokens, the guard's
    state (the speculative greedy pool trips it on the same tick), the
    statistics and the forwards equal the one-rank pool's, on every
    rank."""
    want = runs["pool_ref"][mode]
    assert sum(map(len, want[-1][1])) > 0
    if mode != "beam2_mixed_m":
        assert want[-1][2]  # the guard tripped
    for rank, out in enumerate(runs["got"][(2, 1)]):
        got = out[f"pool {mode}"]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (rank, i, g, w)
        assert len(got) == len(want)


def test_memplan_bytes_equal_what_a_rank_holds(runs):
    for rank, out in enumerate(runs["got"][(2, 1)]):
        reckoned, held = out["memplan bytes"]
        assert reckoned == held, (rank, reckoned, held)


def test_dryrun_2x2(runs):
    line = runs["got"][(2, 2)][0]["dryrun"]
    assert line.startswith("dryrun_multichip OK: mesh=(2x2) devices=4")
    assert "tp-inference logits (2, 39, 1024) finite" in line


def test_tp_refusals(runs):
    cfg = dryrun_config()
    # a head-splitting n_model (the dryrun's 8 query, 4 KV heads)
    with pytest.raises(ValueError, match="inside a head"):
        pmesh.check_tensor_parallel(cfg, 3)
    with pytest.raises(ValueError, match="num_kv_heads"):
        pmesh.shard_params(W.to_torch(runs["params"]), {"data": 1,
                                                        "model": 8},
                           pmesh.model_param_specs(CFG), cfg=CFG)
    # quantized parameters under n_model > 1 (a packed W8A8 leaf)
    from infinisst_tpu_torch.models.quant import pack_kmajor

    p = W.to_torch(runs["params"])
    wq = p["llama"]["layers"]["wq"]
    p["llama"]["layers"]["wq"] = pack_kmajor({
        "q": torch.zeros(wq.shape, dtype=torch.int8),
        "scale_a8": torch.ones(wq.shape[0], wq.shape[-1])})
    with pytest.raises(ValueError, match="quantized parameters"):
        pmesh.shard_params(p, {"data": 1, "model": 2},
                           pmesh.model_param_specs(CFG))
    msg = runs["got"][(1, 2)][0]["quantized agent"]
    assert msg and "tensor parallelism" in msg
    # a pool of 3 rows does not split over 2 data ranks
    msg = runs["got"][(2, 1)][0]["data-split pool"]
    assert msg and "does not split" in msg and "'data'" in msg


@pytest.mark.parametrize("vocab", VOCABS)
def test_split_leaves_outside_tensor_parallel_raise(runs, vocab):
    """Parameters from ``shard_params`` at (1, 2) run outside
    ``tensor_parallel``: the forwards raise (heads, and an lm_head split
    on V or moved onto D) instead of summing part of a product."""
    for rank, out in enumerate(runs["got"][(1, 2)]):
        prefill_err, head_err = out[f"outside context {vocab}"]
        assert "tensor_parallel" in prefill_err, (rank, prefill_err)
        assert "tensor_parallel" in head_err, (rank, head_err)


@pytest.mark.slow
def test_dryrun_multichip_8():
    line = spawn(W.dryrun_rank, 8, timeout=600)[0]
    assert line.startswith("dryrun_multichip OK: mesh=(2x4) devices=8")


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(W.fail_on_rank, 2, args=(1,), timeout=60)

