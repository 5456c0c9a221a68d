"""``tools/spec_acceptance`` against the root ``tools_spec_acceptance.py``
on the CPU: the probe's Llama (``tools/quant_fidelity.CFG``) trained 100
steps by JAX's ``tools_quant_fidelity.train`` and converted by
``from_jax``; ``run_spec`` (speculative greedy: the full head, the
frequency-ranked shortlist, a low-rank head) and ``run_beam``
(speculative beam search) on two held-out prompts: the tokens and the
rounds, drafted and accepted counts equal JAX's.  The JAX side is kept to
a handful of compiles (one a row): its conftest records XLA:CPU's arena
failing after ~75 compiles in this tool.

Run as a module, it compares the acceptance grids of the two tools at
their own 600 training steps (the held-out prompts, k = 4, d = 1, 2,
3): JAX's tool, the port trained from JAX's initial weights (carried
over by ``from_jax`` in place of the port tool's ``L.init_params``), and
the port from its own seeds 0-3 (the seed spread), one JSON line a
model:

    JAX_PLATFORMS=cpu python -m tests.test_torch_spec_acceptance [--steps 600]
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.decode.beam import BeamSpec
from infinisst_tpu.decode.spec_beam import spec_beam_search
from infinisst_tpu.models import llama as JL
from infinisst_tpu.streaming.state import init_decoder_state
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.tools import spec_acceptance as TSA

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the root-level tools_* scripts
import tools_quant_fidelity as JQF  # noqa: E402
import tools_spec_acceptance as JSA  # noqa: E402

torch.set_num_threads(2)

# (draft layers, k, shortlist width, mode, low rank)
ROWS = [(1, 4, 0, "full", 0), (2, 9, 128, "ranked", 0),
        (1, 4, 0, "lowrank", 64)]


@pytest.fixture(scope="module")
def trained():
    corpus = JQF.make_corpus(np.random.RandomState(0), 8, 64)
    jp = JL.init_params(jax.random.PRNGKey(0), JQF.CFG, jnp.float32)
    jp = JQF.train(jp, corpus, 100)
    freq = np.bincount(corpus.ravel(), minlength=JQF.CFG.vocab_size)
    ranked = np.argsort(-freq).astype(np.int32)
    prompts = [JQF.make_corpus(np.random.RandomState(100 + i), 1, 8)[0]
               for i in (0, 3)]
    yield jp, from_jax(jax.device_get(jp), device="cpu"), ranked, prompts
    JSA._JIT_CACHE.clear()


@pytest.mark.parametrize("row", ROWS, ids=[r[3] for r in ROWS])
def test_run_spec_matches_jax(trained, row):
    jp, tp, ranked, prompts = trained
    d, k, hv, mode, lr = row
    ids = ranked[:hv] if mode == "ranked" else None
    for p in prompts:
        want = JSA.run_spec(jp, jnp.asarray(p), d, k, hv,
                            head_ids=None if ids is None else jnp.asarray(ids),
                            lowrank=lr)
        got = TSA.run_spec(tp, torch.from_numpy(p), d, k, hv, head_ids=ids,
                           lowrank=lr)
        assert len(got[0]) == TSA.G
        assert got == (list(want[0]), *want[1:])


def _jax_run_beam(jp, d, k, p):
    """The root tool's ``run_beam`` (a closure inside its ``main``): one
    jitted ``spec_beam_search`` of G steps at beam 4 after a prefill."""
    cfg = JQF.CFG
    bs = BeamSpec(beam=4, max_new_tokens=JSA.G, eos_id=-1, pad_id=0,
                  no_repeat_ngram_size=0, repetition_penalty=1.0)
    prompt = jnp.asarray(p)

    @jax.jit
    def fn(st, first, prompt):
        return spec_beam_search(
            jp, cfg, st, first, prompt,
            jnp.asarray(prompt.shape[0], jnp.int32),
            jnp.zeros((8,), jnp.int32), jnp.asarray(0, jnp.int32), bs,
            draft_layers=d, draft_k=k)

    st = init_decoder_state(cfg.num_layers, 1, p.shape[0] + JSA.G + k + 1,
                            cfg.num_kv_heads, cfg.head_dim, jnp.float32)
    lg, st = JL.decode_step(jp, cfg, st, JL.embed(jp, prompt[None]))
    res = jax.device_get(fn(st, lg[0, -1, : cfg.vocab_size], prompt))
    return (int(res.steps), int(res.rounds), int(res.drafted),
            int(res.accepted))


def test_run_beam_matches_jax(trained):
    jp, tp, _, prompts = trained
    for p in prompts:
        assert TSA.run_beam(tp, 1, 2, torch.from_numpy(p)) == \
            _jax_run_beam(jp, 1, 2, p)


# ---------------------------------------------------------------------------
# the acceptance grids (run as a module)

GRID_ROWS = [(1, 4), (2, 4), (3, 4)]  # (draft layers, k): d/L 1/4-3/4


def _held_prompts(n=6):
    """The tools' held-out prompts: unseen random-rule prefixes."""
    return [JQF.make_corpus(np.random.RandomState(100 + i), 1, 8)[0]
            for i in range(n)]


def _grid(run_spec, params, prompts, to):
    """Each row's held-out acceptance: accepted / drafted over the
    prompts."""
    out = {}
    for d, k in GRID_ROWS:
        drafted = accepted = 0
        for p in prompts:
            _, _, dr, ac = run_spec(params, to(p), d, k, 0)
            drafted += int(dr)
            accepted += int(ac)
        out[f"d={d} k={k}"] = round(accepted / drafted, 4)
    return out


def main(argv=None):
    import argparse
    import json

    from infinisst_tpu_torch.models import llama as TL
    from infinisst_tpu_torch.tools import quant_fidelity as TQF

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    corpus = JQF.make_corpus(np.random.RandomState(0), 8, 64)
    prompts = _held_prompts()
    init = JL.init_params(jax.random.PRNGKey(0), JQF.CFG, jnp.float32)
    jp = JQF.train(init, corpus, args.steps)
    print(json.dumps({"jax": _grid(JSA.run_spec, jp, prompts,
                                   jnp.asarray)}), flush=True)
    starts = [("port_from_jax_init",
               from_jax(jax.device_get(init), device="cpu"))]
    starts += [(f"port_seed{seed}", TL.init_params(
        TQF.CFG, TSA._gen("cpu", seed), "cpu", torch.float32))
        for seed in range(args.seeds)]
    for name, tp in starts:
        tp = TQF.train(tp, corpus, args.steps)
        print(json.dumps({name: _grid(TSA.run_spec, tp, prompts,
                                      torch.from_numpy)}), flush=True)


if __name__ == "__main__":
    main()
