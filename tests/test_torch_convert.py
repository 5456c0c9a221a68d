"""The port's checkpoint converters (``infinisst_tpu_torch/convert/
from_torch.py``) against ``infinisst_tpu/convert/from_torch.py``.

1. The same synthetic state dicts (a pruned reference ``.bin`` at the
   dryrun preset, a bare fairseq wav2vec2, an HF Llama) through the port's
   converter + ``from_jax`` and through JAX's converter + ``to_jax`` +
   ``from_jax``: every leaf equal bitwise, in float32 and bf16.
2. ``load_torch_state``'s pickle gating and its restricted legacy-header
   load (mirrors ``tests/test_convert.py:286``, ``:310``).
3. The CTC-finetuned key layout (``:261``).
4. The export and reference-bin round trips (``:204``, ``:610``).
"""

import argparse
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from infinisst_tpu.convert import from_torch as JC
from infinisst_tpu.core.presets import dryrun_config as j_dryrun
from infinisst_tpu_torch.convert import from_torch as TC
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core.config import (
    AdapterConfig,
    LlamaConfig,
    ModelConfig,
    W2V2Config,
    conv_cfg,
)
from infinisst_tpu_torch.core.presets import dryrun_config
from infinisst_tpu_torch.models import llama as TL
from tests.test_convert import _tiny_w2v2_sd
from tests.test_e2e_files import _build_reference_bin

torch.set_num_threads(1)


def leaves(tree, path=""):
    """(path, tensor) pairs of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_trees_equal(got, want):
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def reference_bin():
    bin_sd, w_sd = _build_reference_bin(np.random.RandomState(42),
                                        j_dryrun())
    return bin_sd, w_sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("part", ["reference_bin", "w2v2", "llama"])
def test_converters_match_jax_bitwise(reference_bin, part, dtype):
    bin_sd, w_sd = reference_bin
    tcfg, jcfg = dryrun_config(), j_dryrun()
    jdt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    if part == "reference_bin":
        got = TC.convert_reference_bin(bin_sd, tcfg)
        want = JC.convert_reference_bin(bin_sd, jcfg)
    elif part == "w2v2":
        got = TC.convert_w2v2(w_sd, tcfg.w2v2)
        want = JC.convert_w2v2(w_sd, jcfg.w2v2)
    else:
        got = TC.convert_llama(bin_sd, tcfg.llama)
        want = JC.convert_llama(bin_sd, jcfg.llama)
    import jax.numpy as jnp

    want = from_jax(jax.device_get(JC.to_jax(want, getattr(jnp, jdt))),
                    device="cpu")
    assert_trees_equal(TC.to_torch(got, "cpu", dtype), want)


def test_load_torch_state_pickle_gating(tmp_path):
    """Plain tensor checkpoints load with weights_only; checkpoints with
    config objects need allow_pickle=True (the restricted unpickler) and
    still yield the tensors -- as in the JAX package."""
    p1 = tmp_path / "plain.pt"
    torch.save({"w": torch.randn(3, 2)}, p1)
    out = TC.load_torch_state(str(p1))
    assert out["w"].shape == (3, 2)
    np.testing.assert_array_equal(out["w"], JC.load_torch_state(str(p1))["w"])

    p2 = tmp_path / "fairseq.pt"
    torch.save({"model": {"x": torch.randn(2, 2)},
                "args": argparse.Namespace(encoder_layers=2)}, p2)
    with pytest.raises(ValueError, match="allow_pickle"):
        TC.load_torch_state(str(p2))
    out2 = TC.load_torch_state(str(p2), allow_pickle=True)
    assert out2["x"].shape == (2, 2)
    np.testing.assert_array_equal(
        out2["x"], JC.load_torch_state(str(p2), allow_pickle=True)["x"])


def test_load_torch_state_legacy_header_pickles_restricted(tmp_path):
    """A legacy (non-zip) file whose header pickle carries a payload: the
    fallback loader must not run it."""
    sentinel = tmp_path / "pwned_dir"

    class Evil:
        def __reduce__(self):
            return (os.mkdir, (str(sentinel),))

    mal = tmp_path / "legacy_evil.pt"
    mal.write_bytes(pickle.dumps(Evil()) + pickle.dumps(1001)
                    + pickle.dumps({}))
    with pytest.raises(Exception):
        TC.load_torch_state(str(mal), allow_pickle=True)
    assert not sentinel.exists()
    # the same bytes through a plain pickle.load do run the payload
    with open(mal, "rb") as f:
        pickle.load(f)
    assert sentinel.exists()


def test_convert_w2v2_ctc_layout():
    """CTC-finetuned checkpoints wrap keys as w2v_encoder.w2v_model.* and
    add a CTC head: the wrapper is stripped and the head ignored."""
    cfg = W2V2Config(conv_layers=conv_cfg([(8, 10, 5), (8, 3, 2)]),
                     encoder_embed_dim=16, encoder_layers=2,
                     encoder_attention_heads=2, encoder_ffn_embed_dim=32)
    rng = np.random.RandomState(3)
    sd = _tiny_w2v2_sd(rng, cfg)
    ctc_sd = {f"w2v_encoder.w2v_model.{k}": v for k, v in sd.items()}
    ctc_sd["w2v_encoder.proj.weight"] = rng.randn(40, 16).astype(np.float32)
    ctc_sd["w2v_encoder.proj.bias"] = np.zeros(40, np.float32)
    ctc_sd["w2v_encoder.w2v_model.mask_emb"] = rng.randn(16).astype(
        np.float32)
    assert_trees_equal(TC.to_torch(TC.convert_w2v2(ctc_sd, cfg), "cpu"),
                       TC.to_torch(TC.convert_w2v2(sd, cfg), "cpu"))


def test_export_roundtrip():
    """export_llama of the port's parameters, converted back, gives them
    again exactly."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                      num_layers=2, num_heads=2, num_kv_heads=1,
                      head_dim=16, rope_scaling=False)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    back = TC.to_torch(TC.convert_llama(TC.export_llama(params, cfg), cfg),
                       "cpu")
    assert_trees_equal(back, params)


def test_reference_bin_layout_roundtrip():
    """convert_reference_bin reads the pruned stage-2 layout: each
    component equals its own conversion, the Llama part equals the
    parameters it was exported from."""
    w_cfg = W2V2Config(conv_layers=conv_cfg([(8, 10, 5), (8, 3, 2)]),
                       encoder_embed_dim=16, encoder_layers=2,
                       encoder_attention_heads=2, encoder_ffn_embed_dim=32)
    a_cfg = AdapterConfig(conv_layers=conv_cfg([(16, 2, 2), (16, 2, 2)]),
                          in_dim=16, out_dim=24)
    l_cfg = LlamaConfig(vocab_size=64, hidden_size=24, intermediate_size=40,
                        num_layers=2, num_heads=2, num_kv_heads=1,
                        head_dim=12, rope_scaling=False)
    rng = np.random.RandomState(13)
    w_sd = _tiny_w2v2_sd(rng, w_cfg)
    bin_sd = {f"model.speech_encoder.speech_encoder.{k}": v
              for k, v in w_sd.items()}
    in_d = a_cfg.in_dim
    for i, lc in enumerate(a_cfg.conv_layers):
        base = f"model.speech_encoder.length_shrink.conv_layers.{i}"
        bin_sd[f"{base}.0.weight"] = (
            rng.randn(lc.dim, in_d, lc.kernel).astype(np.float32) * 0.3)
        bin_sd[f"{base}.2.1.weight"] = rng.rand(lc.dim).astype(np.float32)
        bin_sd[f"{base}.2.1.bias"] = np.zeros(lc.dim, np.float32)
        in_d = lc.dim
    bin_sd["model.speech_encoder.proj.weight"] = (
        rng.randn(a_cfg.out_dim, in_d).astype(np.float32) * 0.2)
    bin_sd["model.speech_encoder.proj.bias"] = np.zeros(a_cfg.out_dim,
                                                        np.float32)
    l_params = TL.init_params(l_cfg, torch.Generator().manual_seed(5), "cpu")
    bin_sd.update(TC.export_llama(l_params, l_cfg))

    cfg = ModelConfig(w2v2=w_cfg, adapter=a_cfg, llama=l_cfg)
    full = TC.to_torch(TC.convert_reference_bin(bin_sd, cfg), "cpu")
    assert_trees_equal(full["w2v2"],
                       TC.to_torch(TC.convert_w2v2(w_sd, w_cfg), "cpu"))
    assert_trees_equal(full["llama"], l_params)
    assert tuple(full["adapter"]["proj"]["w"].shape) == (in_d, a_cfg.out_dim)
