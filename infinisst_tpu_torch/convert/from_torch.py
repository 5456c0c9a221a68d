"""Checkpoint converters: fairseq wav2vec2 / HF Llama / reference
``pytorch_model.bin`` -> numpy parameter trees in the JAX package's
layout (a copy of ``infinisst_tpu/convert/from_torch.py``).

The release pipeline is
  stage2 -> zero_to_fp32.py -> prune_bin.py -> pytorch_model.bin
(ref: scripts/train/stage1.sh:100-101, train/zero_to_fp32.py), loaded by
the agents together with the fairseq w2v2 .pt (agents/infinisst.py:150-180).

All converters operate on {key: numpy array} mappings so they are testable
without fairseq installed; ``load_torch_state`` handles reading the files
(fairseq checkpoints carry OmegaConf config objects — a tolerant unpickler
stubs unknown classes so the tensors load without fairseq).  ``to_torch``
hands a converted tree to ``convert/from_jax.from_jax``, which makes the
port's tensors (the lm_head padded and int8 leaves packed K-major there).

Weight orientation: torch Linear stores (out, in) -> ours (in, out);
torch Conv1d stores (out, in, k) -> ours (k, in, out).
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Callable, Dict

import numpy as np

Arrays = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Torch file loading without the original libraries


# Exact (module, name) pairs the non-weights-only fallback loader may
# resolve: only the tensor-reconstruction machinery and plain containers.
# Everything else — INCLUDING other torch/numpy attributes (torch.hub.load
# is a classic pickle RCE gadget) and all fairseq/omegaconf config classes
# — is replaced with an inert stub; config contents are discarded anyway
# (checkpoints are downloaded public files — treat as untrusted input).
_PICKLE_ALLOWLIST = {
    "torch._utils": {
        "_rebuild_tensor_v2",
        "_rebuild_tensor",
        "_rebuild_parameter",
        "_rebuild_sparse_tensor",
    },
    "torch": {
        "FloatStorage", "DoubleStorage", "HalfStorage", "BFloat16Storage",
        "IntStorage", "LongStorage", "ShortStorage", "CharStorage",
        "ByteStorage", "BoolStorage", "Size", "device", "dtype",
    },
    "torch.serialization": {"_get_layout"},
    "collections": {"OrderedDict"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy": {"ndarray", "dtype"},
}


def load_torch_state(path: str, allow_pickle: bool = False) -> Arrays:
    """Load a torch checkpoint's tensors as numpy.

    Tries ``weights_only=True`` first.  Checkpoints carrying config objects
    (fairseq/omegaconf) need a full unpickle: that path only runs when
    ``allow_pickle=True``, and even then ``find_class`` is restricted to an
    allowlist of container/tensor modules — any other class (importable or
    not) is replaced with an inert stub, so no foreign ``__reduce__`` code
    runs on untrusted files."""
    import torch

    class _Stub:
        def __init__(self, *a, **k):
            pass

        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {})

    class TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if name in _PICKLE_ALLOWLIST.get(module, ()):
                try:
                    return super().find_class(module, name)
                except (ImportError, AttributeError):
                    return _Stub
            return _Stub

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise ValueError(
                f"{path}: not loadable with weights_only=True (it likely "
                "carries fairseq/omegaconf config objects). Pass "
                "allow_pickle=True to use the restricted fallback "
                "unpickler."
            )
        # The shim's ``load`` must ALSO be restricted: torch's _legacy_load
        # (non-zip format) calls pickle_module.load(f) on three
        # attacker-controlled header pickles (magic number, protocol,
        # sys info) BEFORE it constructs pickle_module.Unpickler — a plain
        # pickle.load there would bypass the allowlist entirely.
        def _restricted_load(f, **kw):
            return TolerantUnpickler(f, **kw).load()

        with open(path, "rb") as f:
            obj = torch.load(
                f, map_location="cpu", weights_only=False,
                pickle_module=type(
                    "M", (),
                    {
                        "Unpickler": TolerantUnpickler,
                        "load": staticmethod(_restricted_load),
                    },
                ),
            )
    # fairseq layout: {'model': state_dict, 'args'/'cfg': ...}
    if isinstance(obj, dict) and "model" in obj and hasattr(
        next(iter(obj["model"].values())), "numpy"
    ):
        obj = obj["model"]
    return {
        k: v.float().numpy()
        for k, v in obj.items()
        if hasattr(v, "numpy")
    }


def _lin(sd: Arrays, key: str) -> np.ndarray:
    return sd[key].T  # (out,in) -> (in,out)


def _conv(sd: Arrays, key: str) -> np.ndarray:
    return sd[key].transpose(2, 1, 0)  # (out,in,k) -> (k,in,out)


# ---------------------------------------------------------------------------
# fairseq wav2vec2

# CTC-finetuned fairseq checkpoints (e.g. the released
# wav2_vec_vox_960h_pl.pt) wrap the SSL model: keys are
# ``w2v_encoder.w2v_model.<ssl key>`` plus a ``w2v_encoder.proj.*`` CTC head.
# The reference strips the wrapper and discards the head
# (model/speech_encoder.py:157-171); we do the same, auto-detected.
_CTC_PREFIX = "w2v_encoder.w2v_model."


def strip_ctc_prefix(sd: Arrays) -> Arrays:
    """Normalise a CTC-finetuned ``w2v_encoder.w2v_model.*`` state dict to
    the bare SSL key layout; pass-through if it already is one."""
    if not any(k.startswith(_CTC_PREFIX) for k in sd):
        return sd
    return {
        k[len(_CTC_PREFIX):]: v
        for k, v in sd.items()
        if k.startswith(_CTC_PREFIX)
    }


def convert_w2v2(sd: Arrays, cfg, prefix: str = "") -> Dict[str, Any]:
    """fairseq Wav2Vec2Model state dict -> models.wav2vec2 param pytree.

    Key layout per fairseq (vox/large, extractor_mode='layer_norm'):
      feature_extractor.conv_layers.{i}.0.weight        conv
      feature_extractor.conv_layers.{i}.2.1.{weight,bias}  per-layer LN
      layer_norm.{weight,bias}             post-extractor LN
      post_extract_proj.{weight,bias}
      encoder.layers.{i}.self_attn.{q,k,v,out}_proj.{weight,bias}
      encoder.layers.{i}.{self_attn_layer_norm,final_layer_norm}.{weight,bias}
      encoder.layers.{i}.fc{1,2}.{weight,bias}
      encoder.layer_norm.{weight,bias}     final LN (layer_norm_first)

    CTC-finetuned layouts (``w2v_encoder.w2v_model.`` wrapper) are
    normalised automatically via :func:`strip_ctc_prefix`.

    Two extractor layouts, selected by ``cfg.extractor_mode``:
      'layer_norm'  conv_layers.{i}.2.1.{weight,bias}   per-layer LN (vox)
      'default'     conv_layers.0.2.{weight,bias}       GroupNorm, layer 0
                    only — the hubert / base-w2v2 layout (hubert models
                    also carry label_embs_concat / final_proj, ignored,
                    ref: model/patches/patch_speech_encoder.py:80-218).
    """
    sd = strip_ctc_prefix(sd)
    p = prefix
    conv = []
    for i, lc in enumerate(cfg.conv_layers):
        base = f"{p}feature_extractor.conv_layers.{i}"
        entry = {"w": _conv(sd, f"{base}.0.weight")}
        # vox/LV-60 checkpoints carry conv biases (conv_bias=true in
        # fairseq wav2vec2_large_librivox.yaml); presence-detected so
        # base-style bias-free checkpoints convert unchanged.
        if f"{base}.0.bias" in sd:
            entry["b"] = sd[f"{base}.0.bias"]
        if cfg.extractor_mode == "layer_norm":
            entry["ln_scale"] = sd[f"{base}.2.1.weight"]
            entry["ln_bias"] = sd[f"{base}.2.1.bias"]
        elif i == 0:
            entry["gn_scale"] = sd[f"{base}.2.weight"]
            entry["gn_bias"] = sd[f"{base}.2.bias"]
        conv.append(entry)
    L = cfg.encoder_layers

    def stack(fmt: str, transform: Callable = None):
        mats = []
        for i in range(L):
            a = sd[fmt.format(i=i)]
            mats.append(a.T if transform is _lin else a)
        return np.stack(mats)

    def stack_lin(fmt):
        return np.stack([sd[fmt.format(i=i)].T for i in range(L)])

    def stack_raw(fmt):
        return np.stack([sd[fmt.format(i=i)] for i in range(L)])

    e = f"{p}encoder.layers"
    layers = {
        "ln1_scale": stack_raw(e + ".{i}.self_attn_layer_norm.weight"),
        "ln1_bias": stack_raw(e + ".{i}.self_attn_layer_norm.bias"),
        "ln2_scale": stack_raw(e + ".{i}.final_layer_norm.weight"),
        "ln2_bias": stack_raw(e + ".{i}.final_layer_norm.bias"),
        "wq": stack_lin(e + ".{i}.self_attn.q_proj.weight"),
        "wk": stack_lin(e + ".{i}.self_attn.k_proj.weight"),
        "wv": stack_lin(e + ".{i}.self_attn.v_proj.weight"),
        "wo": stack_lin(e + ".{i}.self_attn.out_proj.weight"),
        "bq": stack_raw(e + ".{i}.self_attn.q_proj.bias"),
        "bk": stack_raw(e + ".{i}.self_attn.k_proj.bias"),
        "bv": stack_raw(e + ".{i}.self_attn.v_proj.bias"),
        "bo": stack_raw(e + ".{i}.self_attn.out_proj.bias"),
        "fc1_w": stack_lin(e + ".{i}.fc1.weight"),
        "fc1_b": stack_raw(e + ".{i}.fc1.bias"),
        "fc2_w": stack_lin(e + ".{i}.fc2.weight"),
        "fc2_b": stack_raw(e + ".{i}.fc2.bias"),
    }
    return {
        "conv": conv,
        "post_ln": {
            "scale": sd[f"{p}layer_norm.weight"],
            "bias": sd[f"{p}layer_norm.bias"],
        },
        "post_proj": {
            "w": _lin(sd, f"{p}post_extract_proj.weight"),
            "b": sd[f"{p}post_extract_proj.bias"],
        },
        "layers": layers,
        "final_ln": {
            "scale": sd[f"{p}encoder.layer_norm.weight"],
            "bias": sd[f"{p}encoder.layer_norm.bias"],
        },
    }


def fairseq_w2v2_to_hf(sd: Arrays, n_conv: int, n_layers: int) -> Arrays:
    """fairseq Wav2Vec2Model keys -> HF ``transformers.Wav2Vec2Model`` keys
    (``do_stable_layer_norm=True`` / ``feat_extract_norm='layer'`` — the
    LV-60 "vox" architecture; for 'default'-mode dicts the layer-0
    GroupNorm maps to HF's ``feat_extract_norm='group'`` layout).

    Values pass through unchanged: torch and HF share (out, in) Linear and
    (out, in, k) Conv orientation.  ``encoder.pos_conv_embed`` keys are NOT
    produced — the reference's patched encoder replaces fairseq's
    positional conv with RoPE / sinusoidal positions
    (patch_speech_encoder.py:448-494), so callers comparing against HF
    must zero HF's pos_conv and inject positions explicitly.

    This exists so the SAME synthetic fairseq checkpoint can be loaded
    into HF's independent wav2vec2 implementation and forward-compared
    against :func:`convert_w2v2` + ``models.wav2vec2``
    (tests/test_hf_w2v2_parity.py).
    """
    sd = strip_ctc_prefix(sd)
    out: Arrays = {}
    for i in range(n_conv):
        fb = f"feature_extractor.conv_layers.{i}"
        out[f"{fb}.conv.weight"] = sd[f"{fb}.0.weight"]
        if f"{fb}.0.bias" in sd:
            out[f"{fb}.conv.bias"] = sd[f"{fb}.0.bias"]
        if f"{fb}.2.1.weight" in sd:  # 'layer_norm' extractor mode
            out[f"{fb}.layer_norm.weight"] = sd[f"{fb}.2.1.weight"]
            out[f"{fb}.layer_norm.bias"] = sd[f"{fb}.2.1.bias"]
        elif f"{fb}.2.weight" in sd:  # 'default' mode: layer-0 GroupNorm
            out[f"{fb}.layer_norm.weight"] = sd[f"{fb}.2.weight"]
            out[f"{fb}.layer_norm.bias"] = sd[f"{fb}.2.bias"]
    out["feature_projection.layer_norm.weight"] = sd["layer_norm.weight"]
    out["feature_projection.layer_norm.bias"] = sd["layer_norm.bias"]
    out["feature_projection.projection.weight"] = sd[
        "post_extract_proj.weight"]
    out["feature_projection.projection.bias"] = sd["post_extract_proj.bias"]
    pairs = (
        ("self_attn.q_proj", "attention.q_proj"),
        ("self_attn.k_proj", "attention.k_proj"),
        ("self_attn.v_proj", "attention.v_proj"),
        ("self_attn.out_proj", "attention.out_proj"),
        ("self_attn_layer_norm", "layer_norm"),
        ("fc1", "feed_forward.intermediate_dense"),
        ("fc2", "feed_forward.output_dense"),
        ("final_layer_norm", "final_layer_norm"),
    )
    for i in range(n_layers):
        for fs_name, hf_name in pairs:
            for suf in ("weight", "bias"):
                out[f"encoder.layers.{i}.{hf_name}.{suf}"] = sd[
                    f"encoder.layers.{i}.{fs_name}.{suf}"]
    if "encoder.layer_norm.weight" in sd:  # layer_norm_first final LN
        out["encoder.layer_norm.weight"] = sd["encoder.layer_norm.weight"]
        out["encoder.layer_norm.bias"] = sd["encoder.layer_norm.bias"]
    return out


# ---------------------------------------------------------------------------
# adapter (length_shrink + proj), reference naming


def convert_adapter(sd: Arrays, cfg, prefix: str) -> Dict[str, Any]:
    """{prefix}length_shrink.conv_layers.{i}... + {prefix}proj.*
    (ref: model/speech_encoder.py:117-121)."""
    conv = []
    for i, _ in enumerate(cfg.conv_layers):
        base = f"{prefix}length_shrink.conv_layers.{i}"
        conv.append(
            {
                "w": _conv(sd, f"{base}.0.weight"),
                "ln_scale": sd[f"{base}.2.1.weight"],
                "ln_bias": sd[f"{base}.2.1.bias"],
            }
        )
    return {
        "conv": conv,
        "proj": {
            "w": _lin(sd, f"{prefix}proj.weight"),
            "b": sd[f"{prefix}proj.bias"],
        },
    }


# ---------------------------------------------------------------------------
# HF Llama


def convert_llama(sd: Arrays, cfg, prefix: str = "") -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict -> models.llama param pytree.
    prefix '' for a plain HF checkpoint ('model.layers...'), or 'model.'
    already included by caller."""
    p = prefix
    L = cfg.num_layers

    def stack_lin(fmt):
        return np.stack([sd[fmt.format(i=i)].T for i in range(L)])

    def stack_raw(fmt):
        return np.stack([sd[fmt.format(i=i)] for i in range(L)])

    b = f"{p}model.layers"
    layers = {
        "input_ln": stack_raw(b + ".{i}.input_layernorm.weight"),
        "post_ln": stack_raw(b + ".{i}.post_attention_layernorm.weight"),
        "wq": stack_lin(b + ".{i}.self_attn.q_proj.weight"),
        "wk": stack_lin(b + ".{i}.self_attn.k_proj.weight"),
        "wv": stack_lin(b + ".{i}.self_attn.v_proj.weight"),
        "wo": stack_lin(b + ".{i}.self_attn.o_proj.weight"),
        "w_gate": stack_lin(b + ".{i}.mlp.gate_proj.weight"),
        "w_up": stack_lin(b + ".{i}.mlp.up_proj.weight"),
        "w_down": stack_lin(b + ".{i}.mlp.down_proj.weight"),
    }
    embed = sd[f"{p}model.embed_tokens.weight"]
    if f"{p}lm_head.weight" in sd:
        head = _lin(sd, f"{p}lm_head.weight")
    else:  # tied embeddings
        head = embed.T
    return {
        "embed": embed,
        "layers": layers,
        "final_ln": sd[f"{p}model.norm.weight"],
        "lm_head": head,
    }


# ---------------------------------------------------------------------------
# Reference release checkpoint (pruned pytorch_model.bin)


def convert_reference_bin(sd: Arrays, model_cfg) -> Dict[str, Any]:
    """The pruned stage-2 bin contains the SpeechLlamaForCausalLM state
    dict: 'model.embed_tokens...', 'model.layers...', 'lm_head.weight',
    plus the attached speech encoder under 'model.speech_encoder.'
    (speech_encoder.speech_encoder.* = fairseq body,
    speech_encoder.length_shrink / .proj = adapter;
    ref: model/model.py:114-133, train/prune_bin.py)."""
    return {
        "w2v2": convert_w2v2(
            sd, model_cfg.w2v2, prefix="model.speech_encoder.speech_encoder."
        ),
        "adapter": convert_adapter(
            sd, model_cfg.adapter, prefix="model.speech_encoder."
        ),
        "llama": convert_llama(sd, model_cfg.llama, prefix=""),
    }


def to_torch(tree, device="cuda", dtype=None):
    """A converted numpy tree -> the port's tensors on ``device`` (float
    leaves cast to ``dtype`` when it is given), through ``from_jax``."""
    from infinisst_tpu_torch.convert.from_jax import from_jax

    return from_jax(tree, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Export back to torch naming (for interop / checkpoint publication)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def export_llama(params, cfg) -> Arrays:
    """Float Llama parameters (numpy or torch leaves) -> HF names."""
    out: Arrays = {}
    out["model.embed_tokens.weight"] = _np(params["embed"])
    ly = params["layers"]
    for i in range(cfg.num_layers):
        b = f"model.layers.{i}"
        out[f"{b}.input_layernorm.weight"] = _np(ly["input_ln"][i])
        out[f"{b}.post_attention_layernorm.weight"] = _np(ly["post_ln"][i])
        out[f"{b}.self_attn.q_proj.weight"] = _np(ly["wq"][i]).T
        out[f"{b}.self_attn.k_proj.weight"] = _np(ly["wk"][i]).T
        out[f"{b}.self_attn.v_proj.weight"] = _np(ly["wv"][i]).T
        out[f"{b}.self_attn.o_proj.weight"] = _np(ly["wo"][i]).T
        out[f"{b}.mlp.gate_proj.weight"] = _np(ly["w_gate"][i]).T
        out[f"{b}.mlp.up_proj.weight"] = _np(ly["w_up"][i]).T
        out[f"{b}.mlp.down_proj.weight"] = _np(ly["w_down"][i]).T
    out["model.norm.weight"] = _np(params["final_ln"])
    out["lm_head.weight"] = _np(params["lm_head"]).T
    return out
