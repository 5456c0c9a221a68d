"""Guards for the PyTorch port.

1. No module of ``infinisst_tpu_torch`` and not ``chip_smoke.py`` imports
   ``jax``, anything of the JAX package ``infinisst_tpu`` or a root
   ``tools_*`` script: the machine with the card has no JAX, and the port
   keeps its own copies.
2. Asking for CUDA without a card raises; nothing quietly runs on the CPU.
"""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "infinisst_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


# the entry points ported from the root scripts and examples, which the
# scan below must cover
ENTRY_POINTS = ("tools/alignatt_quality.py", "tools/trained_e2e.py",
                "tools/spec_trained_teacher.py", "tools/phrase_e2e.py",
                "tools/spec_acceptance.py", "tools/quant_fidelity.py",
                "tools/memplan.py",
                "examples/stream_demo.py", "examples/serve_demo.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "infinisst_tpu")


def test_port_imports_no_jax_and_no_jax_package():
    files = _sources()
    assert len(files) > 20, files
    for e in ENTRY_POINTS:
        assert os.path.join(PKG, e) in files, e
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if _forbidden(n) or n.split(".")[0].startswith("tools_")]
    assert not bad, bad


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")


def test_cuda_without_a_card_raises(no_card):
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core import config as TC
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.models.quant import init_quantized_llama

    cfg = TC.tiny_model_config(vocab_size=512)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InfiniSSTAgent(None, cfg, TC.StreamConfig(),
                       PromptBuilder(StubTokenizer(512), cfg.tokens),
                       InfiniSSTOptions())  # device defaults to cuda
    with pytest.raises((RuntimeError, AssertionError)):
        init_quantized_llama(cfg.llama, torch.Generator(), device="cuda")


def test_kernel_wrappers_never_fall_back(no_card):
    """The plain versions run only for CPU tensors: any other device goes
    to the kernel (or raises), never to the plain version."""
    from infinisst_tpu_torch.kernels import decode_attention as A
    from infinisst_tpu_torch.kernels import quant_matmul as K

    K.reset_launch_counts()
    A.reset_launch_counts()
    y = torch.empty((4, 64), device="meta")
    w = torch.empty((64, 32), dtype=torch.int8, device="meta")
    s = torch.empty((32,), device="meta")
    sg = torch.empty((2, 32), device="meta")
    ys = torch.empty((4, 1), device="meta")
    ysg = torch.empty((4, 2), device="meta")
    yq = torch.empty((4, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.row_quant_int8(y)
    with pytest.raises(ValueError, match="unsupported device"):
        K.w8a8_gemm(yq, ys, w, s, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        K.w8_bf16_gemm(y, w, s)
    with pytest.raises(ValueError, match="unsupported device"):
        K.group_quant_int8(y, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        K.w8a8_grouped_gemm(yq, ysg, w, sg, torch.bfloat16)
    q = torch.empty((2, 4, 16), device="meta")
    cache = torch.empty((1, 8, 2, 16), device="meta")
    ints = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        A.decode_attention(q, cache, cache, ints[:1], ints,
                           torch.empty((8,), device="meta"))
    gen = torch.empty((2, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        A.beam_attention(q, cache, cache, ints[:1], gen, gen, ints, ints,
                         ints, torch.empty((8,), device="meta"))
    assert sum(K.launch_counts.values()) == 0
    assert sum(A.launch_counts.values()) == 0
    # a CPU tensor takes the plain version
    out = K.quantized_matmul_w8a8(torch.ones((2, 8)),
                                  torch.ones((8, 4), dtype=torch.int8),
                                  torch.ones((4,)))
    np.testing.assert_array_equal(out.numpy(), np.full((2, 4), 8.0))


@pytest.mark.parametrize("tool", ["alignatt_quality", "trained_e2e",
                                  "spec_trained_teacher", "phrase_e2e",
                                  "spec_acceptance"])
def test_tools_default_to_the_card(no_card, tool):
    """Each trained-model tool runs on ``cuda`` unless given ``--device``:
    without a card it raises before any work."""
    import importlib

    mod = importlib.import_module(f"infinisst_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
