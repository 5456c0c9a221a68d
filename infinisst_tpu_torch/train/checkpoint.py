"""Checkpoint save / restore of the whole training state, plus export to
the reference's published format; port of
``infinisst_tpu/train/checkpoint.py``.

A checkpoint is ``<dir>/<step>/state.pt``: ``torch.save`` of {'params',
'opt_state', 'step'}, the whole ``TrainState`` as the JAX package's orbax
manager saves it (orbax's on-disk format is not carried over).  Each save
is written under a temporary name and then renamed, so a directory named
by a step always holds a whole checkpoint; the newest ``max_to_keep`` are
kept.  ``export_torch_bin`` writes a reference-format
``pytorch_model.bin``.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from infinisst_tpu_torch.train.step import TrainState, tree_leaves

STATE_FILE = "state.pt"


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, STATE_FILE)))


def save(directory: str, state: TrainState, step: int, max_to_keep: int = 2):
    """Write ``state`` as step ``step`` and drop all but the newest
    ``max_to_keep`` steps."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": state.params, "opt_state": state.opt_state,
                "step": int(state.step)}, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, like: TrainState, shard=None) -> TrainState:
    """Read the newest checkpoint into the tensors of ``like`` (a state of
    the same structure, e.g. a freshly initialised one), in place, so the
    card never holds two copies.  ``shard`` maps the saved whole state
    ({'params', 'opt_state', 'step'}) to this rank's slices of it (a
    mesh's ``MeshPlan.local_state``).  Returns the restored state."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    saved = torch.load(os.path.join(directory, str(step), STATE_FILE),
                       map_location="cpu", mmap=True, weights_only=True)
    if shard is not None:
        saved = shard(saved)
    for key in ("params", "opt_state"):
        dst, src = tree_leaves(getattr(like, key)), tree_leaves(saved[key])
        if len(dst) != len(src):
            raise ValueError(f"checkpoint {step}: {key} has {len(src)} "
                             f"leaves, the state {len(dst)}")
        for d, s in zip(dst, src):
            if isinstance(d, torch.Tensor):
                if d.shape != s.shape:
                    raise ValueError(f"checkpoint {step}: a {key} leaf is "
                                     f"{tuple(s.shape)}, the state's "
                                     f"{tuple(d.shape)}")
                d.copy_(s)
    opt_state = _with_counts(like.opt_state, saved["opt_state"])
    return TrainState(like.params, opt_state, int(saved["step"]))


def _with_counts(like, saved):
    """``like`` with the saved host ints (the optimizer's counts)."""
    if isinstance(like, dict):
        return {k: _with_counts(v, saved[k]) for k, v in like.items()}
    if isinstance(like, list):
        return [_with_counts(v, s) for v, s in zip(like, saved)]
    return like if isinstance(like, torch.Tensor) else saved


def _t(x) -> torch.Tensor:
    return x.detach().cpu().contiguous()


def export_torch_bin(params, model_cfg, path: str):
    """Write a reference-format pruned state dict (pytorch_model.bin):
    llama under 'model.*' / 'lm_head.*', the encoder under
    'model.speech_encoder.*' (ref naming: train/prune_bin.py +
    model/model.py:114-133).  Returns the dict."""
    from infinisst_tpu_torch.convert.from_torch import export_llama

    sd = {k: torch.from_numpy(v) for k, v in
          export_llama(params["llama"], model_cfg.llama).items()}

    w = params["w2v2"]
    pre = "model.speech_encoder.speech_encoder."
    for i, c in enumerate(w["conv"]):
        fe = f"{pre}feature_extractor.conv_layers.{i}"
        sd[f"{fe}.0.weight"] = _t(c["w"].permute(2, 1, 0))
        sd[f"{fe}.2.1.weight"] = _t(c["ln_scale"])
        sd[f"{fe}.2.1.bias"] = _t(c["ln_bias"])
    sd[f"{pre}layer_norm.weight"] = _t(w["post_ln"]["scale"])
    sd[f"{pre}layer_norm.bias"] = _t(w["post_ln"]["bias"])
    sd[f"{pre}post_extract_proj.weight"] = _t(w["post_proj"]["w"].T)
    sd[f"{pre}post_extract_proj.bias"] = _t(w["post_proj"]["b"])
    ly = w["layers"]
    for i in range(ly["wq"].shape[0]):
        b = f"{pre}encoder.layers.{i}"
        sd[f"{b}.self_attn_layer_norm.weight"] = _t(ly["ln1_scale"][i])
        sd[f"{b}.self_attn_layer_norm.bias"] = _t(ly["ln1_bias"][i])
        sd[f"{b}.final_layer_norm.weight"] = _t(ly["ln2_scale"][i])
        sd[f"{b}.final_layer_norm.bias"] = _t(ly["ln2_bias"][i])
        for ours, theirs in [("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "out_proj")]:
            sd[f"{b}.self_attn.{theirs}.weight"] = _t(ly[ours][i].T)
        for ours, theirs in [("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj"), ("bo", "out_proj")]:
            sd[f"{b}.self_attn.{theirs}.bias"] = _t(ly[ours][i])
        sd[f"{b}.fc1.weight"] = _t(ly["fc1_w"][i].T)
        sd[f"{b}.fc1.bias"] = _t(ly["fc1_b"][i])
        sd[f"{b}.fc2.weight"] = _t(ly["fc2_w"][i].T)
        sd[f"{b}.fc2.bias"] = _t(ly["fc2_b"][i])
    sd[f"{pre}encoder.layer_norm.weight"] = _t(w["final_ln"]["scale"])
    sd[f"{pre}encoder.layer_norm.bias"] = _t(w["final_ln"]["bias"])

    a = params["adapter"]
    apre = "model.speech_encoder."
    for i, c in enumerate(a["conv"]):
        ls = f"{apre}length_shrink.conv_layers.{i}"
        sd[f"{ls}.0.weight"] = _t(c["w"].permute(2, 1, 0))
        sd[f"{ls}.2.1.weight"] = _t(c["ln_scale"])
        sd[f"{ls}.2.1.bias"] = _t(c["ln_bias"])
    sd[f"{apre}proj.weight"] = _t(a["proj"]["w"].T)
    sd[f"{apre}proj.bias"] = _t(a["proj"]["b"])

    torch.save(sd, path)
    return sd
