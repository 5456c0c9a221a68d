"""Training CLI; port of ``infinisst_tpu/train/main.py``.

Usage (mirrors scripts/train/stage1.sh):
  python -m infinisst_tpu_torch.train.main \
      --data_path /data/en-de --data_split_train train_traj \
      --stage 1 --trajectory 4 --trajectory_max_multiplier 4 \
      --llm_path /path/llama-3.1-8b-instruct-hf \
      --w2v2_path /path/wav2_vec_vox_960h_pl.pt \
      --save_dir runs/stage1 [--device cuda]

The flags are ``TrainerArgs``' fields plus the weight paths, the tokenizer
path, ``--model_preset`` (flagship | bench | dryrun) and ``--device``
(default ``cuda``; ``cpu`` runs on the CPU).  Training is in float32, as
in the JAX package.  Stage 2 starts from stage 1's consolidated bin
(``--sllm_weight_path``, ref: model/model.py:142-145).

Data, FSDP and tensor parallelism run under ``torchrun``, one process a
card (NCCL; gloo with ``--device cpu``), the mesh given by ``--n_data``
and ``--n_model`` (their product the world size; ``--zero``, on by
default, splits the parameters over 'data', as the JAX package's does):

  torchrun --standalone --nproc_per_node 8 -m infinisst_tpu_torch.train.main \
      ... --n_data 8

``build_params`` reads a reference ``pytorch_model.bin`` (the whole
speech-LLM), a fairseq wav2vec2 ``.pt`` and an HF Llama checkpoint (a
``.bin`` file, or a directory of ``pytorch_model*.bin`` or, failing
those, ``*.safetensors``), converts them with ``convert/from_torch.py``,
and draws random weights for whatever no path gives.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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


def parse_args(argv=None) -> argparse.Namespace:
    from infinisst_tpu_torch.train.trainer import TrainerArgs

    p = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainerArgs):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, type=lambda x: str(x).lower() == "true",
                           default=f.default)
        elif f.default is None:
            p.add_argument(name, type=int, default=None)
        elif isinstance(f.default, tuple):
            p.add_argument(name, type=str,
                           default=",".join(map(str, f.default)))
        else:
            p.add_argument(name, type=type(f.default), default=f.default)
    p.add_argument("--llm_path", type=str, default=None,
                   help="HF Llama checkpoint dir (or .bin/.safetensors)")
    p.add_argument("--w2v2_path", type=str, default=None,
                   help="fairseq wav2vec2 .pt")
    p.add_argument("--sllm_weight_path", type=str, default=None,
                   help="stage-1 consolidated bin (stage 2)")
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--model_preset", type=str, default="flagship",
                   choices=["flagship", "bench", "dryrun"])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from infinisst_tpu_torch.core.presets import PRESETS
    from infinisst_tpu_torch.data.template import (
        HFTokenizerAdapter,
        PromptBuilder,
        StubTokenizer,
    )
    from infinisst_tpu_torch.train.trainer import Trainer, TrainerArgs

    dev = resolve_device(args.device)
    distributed = "WORLD_SIZE" in os.environ  # under torchrun
    if distributed:
        from infinisst_tpu_torch.parallel.mesh import init_distributed

        dev = init_distributed(dev)
    cfg = PRESETS[args.model_preset]()
    ta_fields = {f.name for f in dataclasses.fields(TrainerArgs)}
    kw = {k: v for k, v in vars(args).items() if k in ta_fields}
    if isinstance(kw.get("trajectory_perturb"), str):
        kw["trajectory_perturb"] = tuple(
            float(x) for x in kw["trajectory_perturb"].split(",")
        )
    targs = TrainerArgs(**kw)

    if args.tokenizer_path:
        from transformers import AutoTokenizer

        from infinisst_tpu_torch.data.template import register_special_tokens

        tok = AutoTokenizer.from_pretrained(args.tokenizer_path,
                                            use_fast=False)
        register_special_tokens(tok, cfg)
        tokenizer = HFTokenizerAdapter(tok)
    else:
        tokenizer = StubTokenizer(cfg.llama.vocab_size)

    builder = PromptBuilder(
        tokenizer, cfg.tokens, targs.source_lang, targs.target_lang
    )
    params = build_params(args, cfg, dev)
    trainer = Trainer(targs, cfg, builder, params, device=dev)
    final_step = trainer.fit()
    print(f"training done at step {final_step}; checkpoints in "
          f"{os.path.join(targs.save_dir, 'ckpt')}")
    if distributed:
        # the trainer's graphs hold the group's communicators: they go
        # first (NCCL's teardown waits on them otherwise)
        del trainer
        gc.collect()
        torch.distributed.destroy_process_group()
    return final_step


if __name__ == "__main__":
    main()
