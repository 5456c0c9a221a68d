"""Initial weights for the port's entry points: the load branch of
``infinisst_tpu/train/main.py:build_params``.

``build_params`` reads a reference ``pytorch_model.bin`` (the whole
speech-LLM), a fairseq wav2vec2 ``.pt`` and an HF Llama checkpoint (a
``.bin`` file, or a directory of ``pytorch_model*.bin`` or, failing
those, ``*.safetensors``), converts them with ``convert/from_torch.py``,
and draws random weights for whatever no path gives.  The trainer itself
(``Trainer``, the stage 1/2 steps, ``main``) comes with ROADMAP item 13.
"""

from __future__ import annotations

import glob
import os

import torch

from infinisst_tpu_torch.core.device import resolve_device

# seeds of the random init, one generator per component
INIT_SEEDS = {"w2v2": 0, "adapter": 1, "llama": 2}


def random_params(model_cfg, device="cuda", dtype=torch.float32,
                  parts=("w2v2", "adapter", "llama")):
    """Random parameters of the named components, made on ``device`` from
    seeded ``torch.Generator``s (``INIT_SEEDS``)."""
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models import wav2vec2 as W

    dev = resolve_device(device)
    init = {"w2v2": (W, model_cfg.w2v2), "adapter": (A, model_cfg.adapter),
            "llama": (L, model_cfg.llama)}
    out = {}
    for name in parts:
        mod, cfg = init[name]
        gen = torch.Generator(device=dev).manual_seed(INIT_SEEDS[name])
        out[name] = mod.init_params(cfg, gen, dev, dtype)
    return out


def _llama_state(path: str):
    from infinisst_tpu_torch.convert import from_torch as C

    if not os.path.isdir(path):
        return C.load_torch_state(path)
    sd = {}
    files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    for f in files or sorted(glob.glob(os.path.join(path, "*.safetensors"))):
        if f.endswith(".safetensors"):
            from safetensors.numpy import load_file

            sd.update(load_file(f))
        else:
            sd.update(C.load_torch_state(f))
    return sd


def build_params(args, model_cfg, device="cuda", dtype=torch.float32):
    """Load and convert the initial weights named by ``args``
    (``sllm_weight_path``, ``w2v2_path``, ``llm_path``); random init where
    no path is given.  Every leaf ends on ``device``, float leaves in
    ``dtype``."""
    from infinisst_tpu_torch.convert import from_torch as C

    dev = resolve_device(device)
    if args.sllm_weight_path:
        sd = C.load_torch_state(args.sllm_weight_path)
        return C.to_torch(C.convert_reference_bin(sd, model_cfg), dev, dtype)
    loaded = {}
    if args.w2v2_path:
        # fairseq .pt files carry omegaconf config objects -> the restricted
        # fallback unpickler is required (allowlisted modules only)
        sd = C.load_torch_state(args.w2v2_path, allow_pickle=True)
        loaded["w2v2"] = C.to_torch(C.convert_w2v2(sd, model_cfg.w2v2), dev,
                                    dtype)
    if args.llm_path:
        sd = _llama_state(args.llm_path)
        loaded["llama"] = C.to_torch(C.convert_llama(sd, model_cfg.llama),
                                     dev, dtype)
    missing = [k for k in ("w2v2", "adapter", "llama") if k not in loaded]
    params = random_params(model_cfg, dev, dtype, parts=missing)
    params.update(loaded)
    return {k: params[k] for k in ("w2v2", "adapter", "llama")}
