"""The speculative decoders' draft levers on the port, against the JAX
package on the CPU at the tiny decoder of ``tests/test_speculative.py``
(float32): ``make_draft_head`` on every lm_head layout (float, K-major
W8A8 per-channel and grouped), shortlist and low-rank drafts through
``speculative_greedy``, ``dequant_head``, ``breakeven_tokens_per_round``,
and the exit adapter (``models/llama.apply_exit_adapter``,
``train/draft.py``).  Mirrors ``tests/test_speculative.py:200-360``,
``tests/test_spec_guard.py:74`` and ``tests/test_draft_adapter.py:51-97``.
Scores within 1e-5 (float32 in another order), tokens and acceptance
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.decode import speculative as JS
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import quant as JQ
from infinisst_tpu.train import draft as JD
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.decode import speculative as TS
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models import quant as TQ
from infinisst_tpu_torch.train import draft as TD
from tests.test_speculative import CFG
from tests.test_torch_speculative import (
    TCFG,
    _spec,
    both,
    j_greedy,
    port_greedy,
    same,
    t_greedy,
)

torch.set_num_threads(1)


def _heads(w):
    """The float head w (D, V) and its per-channel and grouped W8A8
    leaves, JAX layout and port (K-major) layout."""
    q, s = JQ.quantize_weight(w, axis=0)
    qg, sg = JQ._quantize_grouped(w, 16)
    jax_heads = {"float": w,
                 "w8a8": {"q": q, "scale_a8": s.astype(jnp.float32)},
                 "grouped": {"q": qg, "scale_a8": sg.astype(jnp.float32)}}
    port = {}
    for name, h in jax_heads.items():
        port[name] = (torch.from_numpy(np.array(h)) if name == "float"
                      else TQ.pack_kmajor({k: torch.from_numpy(np.array(v))
                                           for k, v in h.items()}))
    return jax_heads, port


@pytest.mark.parametrize("layout", ["float", "w8a8", "grouped"])
@pytest.mark.parametrize("shortlist", ["prefix", "ids"])
def test_make_draft_head_on_every_layout(layout, shortlist):
    """``make_draft_head`` on the port's K-major leaves: the out-channels
    and their scales of the shortlist, padded to 512 with zero scales as
    JAX pads its columns; the sliced head's scores equal JAX's sliced
    head's, and a column gather of the full head's (``:200-306``)."""
    D, V, HV = 64, 600, 40
    w = jax.random.normal(jax.random.PRNGKey(0), (D, V), jnp.float32)
    ids = np.asarray(jax.random.permutation(jax.random.PRNGKey(2), V)[:HV])
    jheads, theads = _heads(w)
    jh = JS.make_draft_head(jheads[layout], HV,
                            ids=None if shortlist == "prefix" else ids)
    th = TS.make_draft_head(theads[layout], HV,
                            ids=None if shortlist == "prefix" else ids)
    assert set(th) == set(jh) and shortlist in th
    sel = np.arange(HV) if shortlist == "prefix" else ids
    np.testing.assert_array_equal(th[shortlist].numpy(), sel)
    assert th[shortlist].dtype == torch.int32
    y = np.random.RandomState(1).randn(3, D).astype(np.float32)
    got = TQ.mm(torch.from_numpy(y), th["w"])[:, :HV].numpy()
    want = np.asarray(JQ.mm(jnp.asarray(y), jh["w"]))[:, :HV]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = TQ.mm(torch.from_numpy(y), theads[layout]).numpy()[:, sel]
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-5)
    if layout != "float":
        assert th["w"][TQ.KMAJOR].shape == (512, D)
        assert not th["w"]["scale_a8"][..., HV:].any()
        assert not th["w"][TQ.KMAJOR][HV:].any()
    # the same bytes as the JAX head, so the same break-even
    assert TS._nbytes(th) == sum(a.size * a.dtype.itemsize
                                 for a in jax.tree.leaves(jh))


@pytest.mark.parametrize("head_vocab, ids", [(32, None),
                                             (8, "adversarial")])
def test_shortlist_draft_stays_exact(head_vocab, ids):
    """A prefix shortlist and one that misses every greedy token: the
    JAX decoder's tokens and acceptance, the port's own greedy."""
    j, t = both(1)
    if ids is not None:
        ref = port_greedy(t)
        ids = np.asarray([i for i in range(CFG.vocab_size)
                          if i not in set(ref)][:head_vocab])
    spec = _spec(2, k=3)
    jr = j_greedy(j, spec, draft_head=JS.make_draft_head(
        j[0]["lm_head"], head_vocab, ids=ids))
    tr = t_greedy(t, spec, draft_head=TS.make_draft_head(
        t[0]["lm_head"], head_vocab, ids=ids))
    same(jr, tr)
    assert tr.tokens[: tr.n_tokens] == port_greedy(t)


def test_lowrank_draft_head():
    """``make_lowrank_draft_head``: the JAX factors (the same numpy
    eigendecomposition), a full rank that rebuilds the head, the JAX
    decoder's tokens and acceptance with a lossy rank, and
    ``dequant_head`` on every port layout equal JAX's (``:308``)."""
    j, t = both(4)
    w = j[0]["lm_head"]
    D = CFG.hidden_size
    for rank in (D, 8):
        jh = JS.make_lowrank_draft_head(w, rank)
        th = TS.make_lowrank_draft_head(t[0]["lm_head"], rank)
        assert "prefix" not in th and "ids" not in th
        for key in ("a", "b"):
            np.testing.assert_allclose(th["w"][key].numpy(),
                                       np.asarray(jh["w"][key]),
                                       rtol=1e-5, atol=1e-5)
    full = TS.make_lowrank_draft_head(t[0]["lm_head"], D)["w"]
    torch.testing.assert_close(full["a"] @ full["b"], t[0]["lm_head"],
                               rtol=1e-4, atol=1e-4)
    spec = _spec(2)
    jr = j_greedy(j, spec, draft_head=JS.make_lowrank_draft_head(w, 8))
    tr = t_greedy(t, spec, draft_head=TS.make_lowrank_draft_head(
        t[0]["lm_head"], 8))
    same(jr, tr)
    jheads, theads = _heads(w)
    for name in jheads:
        np.testing.assert_allclose(TS.dequant_head(theads[name]),
                                   JS.dequant_head(jheads[name]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="rank"):
        TS.make_lowrank_draft_head(t[0]["lm_head"], D + 1)


def test_breakeven_equals_jax():
    """The break-even of the float and W8A8 (packed K-major, padded
    head) tiny models, with a shortlist head and an adapter, equals the
    JAX package's for the same models."""
    from tests.test_agent import CFG as ACFG

    key = jax.random.PRNGKey(0)
    jfloat = JL.init_params(key, CFG, jnp.float32)
    jq = JQ.init_quantized_llama(key, ACFG.llama, act_int8=True,
                                 lm_head_int8=True)
    for jp, L in ((jfloat, CFG.num_layers), (jq, ACFG.llama.num_layers)):
        tp = from_jax(jax.device_get(jp), device="cpu")
        jh = JS.make_draft_head(jp["lm_head"], 40)
        th = TS.make_draft_head(tp["lm_head"], 40)
        ada = JD.init_exit_adapter(key, CFG, rank=8)
        tada = {k: torch.from_numpy(np.array(v)) for k, v in ada.items()}
        for d, k, heads, adapter in ((1, 2, None, None), (L, 3, None, None),
                                     (1, 6, (jh, th), None),
                                     (2, 4, (jh, th), (ada, tada))):
            want = JS.breakeven_tokens_per_round(
                jp, L, d, k, draft_head=heads and heads[0],
                exit_adapter=adapter and adapter[0])
            got = TS.breakeven_tokens_per_round(
                tp, L, d, k, draft_head=heads and heads[1],
                exit_adapter=adapter and adapter[1])
            assert got == pytest.approx(want, rel=1e-12)


def test_exit_adapter():
    """A zero-init adapter is the identity (the same tokens, rounds and
    acceptance as no adapter); ``apply_exit_adapter`` equals JAX's on a
    nonzero adapter; a garbage adapter leaves the tokens exact and
    equal JAX's; save / load round-trips and checks the draft depth
    (``tests/test_draft_adapter.py:51-97``)."""
    j, t = both(3)
    gen = torch.Generator().manual_seed(0)
    zero = TD.init_exit_adapter(gen, TCFG, rank=32)
    assert not zero["w2"].any() and zero["w1"].shape == (CFG.hidden_size, 32)
    base = t_greedy(t, _spec(2))
    with_zero = t_greedy(t, _spec(2), exit_adapter=zero)
    assert (base.tokens, base.rounds, base.accepted) == (
        with_zero.tokens, with_zero.rounds, with_zero.accepted)
    k1, k2 = jax.random.split(jax.random.PRNGKey(10))
    jada = {"ln": jnp.ones((CFG.hidden_size,)) * 1.5,
            "w1": jax.random.normal(k1, (CFG.hidden_size, 16)),
            "w2": jax.random.normal(k2, (16, CFG.hidden_size))}
    tada = {k: torch.from_numpy(np.array(v)) for k, v in jada.items()}
    h = np.random.RandomState(0).randn(2, 3, CFG.hidden_size).astype(
        np.float32)
    np.testing.assert_allclose(
        TL.apply_exit_adapter(tada, torch.from_numpy(h), 1e-5).numpy(),
        np.asarray(JL.apply_exit_adapter(jada, jnp.asarray(h), 1e-5)),
        rtol=1e-5, atol=1e-5)
    same(j_greedy(j, _spec(1), exit_adapter=jada),
         t_greedy(t, _spec(1), exit_adapter=tada))
    logits = TD.draft_logits(t[0], TCFG, tada, torch.from_numpy(h))
    want = JD.draft_logits(j[0], CFG, jada, jnp.asarray(h))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_adapter_save_load(tmp_path):
    gen = torch.Generator().manual_seed(1)
    adapter = TD.init_exit_adapter(gen, TCFG, rank=16)
    path = str(tmp_path / "ada.npz")
    TD.save_adapter(path, adapter, d=2)
    back = TD.load_adapter(path, expect_d=2, dtype=torch.bfloat16)
    assert back["w1"].dtype == torch.bfloat16
    assert back["w1"].shape == adapter["w1"].shape
    torch.testing.assert_close(back["ln"].float(), adapter["ln"])
    with pytest.raises(ValueError, match="draft_layers=2"):
        TD.load_adapter(path, expect_d=4)
    # the JAX loader reads the port's file
    jback = JD.load_adapter(path, expect_d=2)
    np.testing.assert_array_equal(np.asarray(jback["w1"]),
                                  adapter["w1"].numpy())
