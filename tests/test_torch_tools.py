"""The port's host tools against the JAX package on the CPU:
``core/profiling`` (``timed`` and ``StepTimer.report`` print JAX's text,
character for character, under the same clock; ``device_trace`` writes a
Chrome trace), ``tools/report`` (the same rows and markdown),
``tools/distill_adapter`` (end to end at the dryrun preset, as
``tests/test_draft_adapter.py`` runs the JAX tool) and
``tools/quant_fidelity``:

- ``make_corpus`` bitwise;
- ``train``: 5 steps from JAX's initial weights print JAX's loss lines,
  the loss of the trained weights within TRAIN_RTOL, the weights within
  TRAIN_ATOL_LR x lr and all but 1e-3 of each leaf's entries within
  lr x 1e-2 (Adam turns float32 noise in a gradient entry into an update
  of about lr, as in test_torch_train_steps.py);
- ``prefill_logits`` of every variant (the groups-of-8 ones too: their
  plain versions run on the CPU) on JAX-trained weights, the port's
  variants made by its own ``quantize_llama_params`` from the converted
  float weights: the float32 reference within F32_RTOL x max|logits|,
  every variant within VARIANT_RTOL x max|logits| and its argmax equal to
  JAX's wherever JAX's top-2 margin exceeds twice that gap.  The variants
  do not agree to float32 noise: the two packages' float32 activations
  differ by ~1e-6 relative, which moves a few activations across an int8
  (or bf16) rounding boundary, a step of the quantizer (ROADMAP §3).
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.kernels.quant_matmul import quantized_matmul
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import quant as JQ
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import profiling as TP
from infinisst_tpu_torch.tools import quant_fidelity as TQF
from infinisst_tpu_torch.train.step import tree_leaves

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the root-level tools_* scripts
import tools_quant_fidelity as JQF  # noqa: E402

torch.set_num_threads(1)

TRAIN_RTOL = 1e-5
TRAIN_ATOL_LR = 0.5
F32_RTOL = 1e-5
VARIANT_RTOL = 1e-2
FIDELITY_TRAIN_STEPS = 100


class _Clock:
    """A fake ``time.perf_counter``: 0.0125 s a call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.0125
        return self.t


def test_step_timer_report_is_jax_text(monkeypatch):
    from infinisst_tpu.core.profiling import StepTimer as JStepTimer

    reports = []
    for cls in (JStepTimer, TP.StepTimer):
        monkeypatch.setattr("time.perf_counter", _Clock())
        t = cls()
        for name in ("a", "b", "a"):
            with t.phase(name, sync_on={"x": [torch.ones(2)]}
                         if cls is TP.StepTimer else None):
                pass
        reports.append(t.report())
    assert reports[0] == reports[1]
    assert reports[1].count("a:") == 1 and "n=2" in reports[1]


def test_timed_is_jax_text(monkeypatch, capsys):
    from infinisst_tpu.core.profiling import timed as jtimed

    outs = []
    for fn, sync in ((jtimed, jnp.ones(3)), (TP.timed, torch.ones(3))):
        monkeypatch.setattr("time.perf_counter", _Clock())
        with fn("unit-phase", sync_on=sync):
            x = sum(range(100))
        with fn("quiet-phase", quiet=True):
            pass
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == "unit-phase: 0.0125 seconds\n"
    assert x == 4950


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with TP.device_trace(str(tmp_path / "tr")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_report_collect_render_match_jax(tmp_path):
    from infinisst_tpu.tools.report import collect as jcollect
    from infinisst_tpu.tools.report import render as jrender
    from infinisst_tpu_torch.tools.report import collect, render

    (tmp_path / "BENCH_r01.json").write_text(json.dumps({
        "metric": "streaming_rtf_m1_beam4_8b_int8", "value": 0.19,
        "unit": "rtf", "vs_baseline": 2.0}))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps({
        "parsed": {"metric": "serve_decode_tok_per_s_pool8_beam4_m1_8b_int8",
                   "value": 205.0, "unit": "tok/s/chip",
                   "vs_baseline": 6.8}, "tail": "x", "rc": 0}))
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "hw_rows_r01.jsonl").write_text(
        json.dumps({"metric": "m", "value": 1.0, "_queue_name": "q"}) + "\n")
    run = tmp_path / "eval" / "en-de"
    run.mkdir(parents=True)
    (run / "scores.json").write_text(json.dumps({"bleu": 21.5}))
    rows = collect(str(tmp_path))
    assert rows == jcollect(str(tmp_path)) and len(rows) >= 3
    md = render(rows)
    assert md == jrender(rows)
    assert "0.19" in md and "205.0" in md and "en-de" in md


def test_distill_adapter_tool(tmp_path):
    """The port's tool end to end on the dryrun preset with id-line
    prompts: rollouts, distillation, a depth-stamped npz that both
    packages load at its depth and refuse at another."""
    from infinisst_tpu.train import draft as JDR
    from infinisst_tpu_torch.tools import distill_adapter as T
    from infinisst_tpu_torch.train import draft as TDR

    rng = np.random.RandomState(0)
    pfile = tmp_path / "prompts.txt"
    with open(pfile, "w") as f:
        for _ in range(4):
            f.write(" ".join(str(x) for x in rng.randint(5, 200, 8)) + "\n")
        f.write("1 2\n")  # too short: dropped, not fatal
    out = str(tmp_path / "ada.npz")
    T.main([
        "--model-preset", "dryrun", "--prompts", str(pfile),
        "--prompt-tokens", "6", "--gen-len", "8", "--batch-size", "2",
        "--draft-layers", "1", "--rank", "8", "--steps", "12",
        "--out", out, "--device", "cpu",
    ])
    back = TDR.load_adapter(out, expect_d=1)
    assert back["w1"].shape[1] == 8
    assert JDR.load_adapter(out, expect_d=1)["w1"].shape[1] == 8
    with pytest.raises(ValueError, match="draft_layers=1"):
        TDR.load_adapter(out, expect_d=2)


def test_make_corpus_bitwise():
    for seed, n, S in ((0, 8, 64), (0, 64, 64), (50, 8, 8), (101, 1, 8)):
        a = TQF.make_corpus(np.random.RandomState(seed), n, S)
        b = JQF.make_corpus(np.random.RandomState(seed), n, S)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _nll(logits, y):
    lp = torch.log_softmax(torch.as_tensor(np.array(logits)), -1)
    return float(-lp.gather(-1, torch.as_tensor(y)[..., None]).mean())


def test_train_matches_jax(capsys):
    corpus = JQF.make_corpus(np.random.RandomState(0), 8, 64)
    jp0 = JL.init_params(jax.random.PRNGKey(0), JQF.CFG, jnp.float32)
    tp0 = from_jax(jax.device_get(jp0), device="cpu")
    capsys.readouterr()
    jp = JQF.train(jp0, corpus, 5)
    jlines = capsys.readouterr().err
    # one thread whatever another test module set: the CPU's softmax
    # backward (aten._softmax_backward_data, the attention weights of each
    # layer) sums in an order that moves with torch's thread count, and
    # the trained loss's gap to JAX with it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tp = TQF.train(tp0, corpus, 5)
    finally:
        torch.set_num_threads(threads)
    lr = 3e-3  # the tool's Adam
    tlines = capsys.readouterr().err
    assert tlines == jlines and tlines.count("loss") == 2
    x, y = corpus[:, :-1], corpus[:, 1:]
    jl = _nll(JL.offline_forward(jp, JQF.CFG, JL.embed(jp, jnp.asarray(x))), y)
    tl = _nll(TQF.L.offline_forward(tp, TQF.CFG,
                                    TQF.L.embed(tp, torch.from_numpy(x))), y)
    assert tl == pytest.approx(jl, rel=TRAIN_RTOL)
    want = from_jax(jax.device_get(jp), device="cpu")
    for g, w in zip(tree_leaves(tp), tree_leaves(want)):
        d = (g - w).abs()
        assert d.max() <= TRAIN_ATOL_LR * lr
        assert (d > 1e-2 * lr).to(torch.float32).mean() <= 1e-3


@pytest.fixture(scope="module")
def fidelity_models():
    """JAX-trained fidelity weights, JAX's variants and the port's."""
    corpus = JQF.make_corpus(np.random.RandomState(0), 8, 64)
    jp = JL.init_params(jax.random.PRNGKey(0), JQF.CFG, jnp.float32)
    jp = JQF.train(jp, corpus, FIDELITY_TRAIN_STEPS)
    tp = from_jax(jax.device_get(jp), device="cpu")
    return corpus, jp, tp, JQF.quant_variants(jp), TQF.quant_variants(tp)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX weight-only path through its Pallas kernel in interpret
    mode (the JAX tool swaps in the dequant reference instead, which
    leaves out the kernel's bf16 rounding of the activations)."""
    monkeypatch.setattr(
        JQ, "quantized_matmul",
        lambda y, w, s, interpret=False: quantized_matmul(
            y, w, s, interpret=True),
    )


def test_prefill_logits_f32_matches_jax(fidelity_models):
    corpus, jp, tp, _, _ = fidelity_models
    want = np.asarray(JQF.prefill_logits(jp, jnp.asarray(corpus)))
    got = TQF.prefill_logits(tp, torch.from_numpy(corpus)).numpy()
    assert np.abs(got - want).max() <= F32_RTOL * np.abs(want).max()


@pytest.mark.parametrize("name", [
    "bf16", "w8", "w8a8", "w8a8_g128", "w8a8_g128_projonly",
    "w8a8_8groups_like_g512", "w8a8_32groups_like_g128",
    "w8a8_32groups_projonly"])
def test_prefill_logits_variant_matches_jax(fidelity_models, name,
                                            interpret_pallas):
    corpus, _, _, jv, tv = fidelity_models
    assert set(tv) == set(jv)
    want = np.asarray(JQF.prefill_logits(jv[name], jnp.asarray(corpus)))
    got = TQF.prefill_logits(tv[name], torch.from_numpy(corpus)).numpy()
    gap = np.abs(got - want).max()
    assert gap <= VARIANT_RTOL * np.abs(want).max(), gap
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * gap
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
    assert clear.mean() > 0.99


@pytest.mark.parametrize("name", ["f32", "w8a8"])
def test_rollouts_and_beam_winners_match_jax(fidelity_models, name):
    """``greedy_rollout`` and ``beam_winner`` (its steps run
    ``decode_attention``'s plain version) token-equal to JAX's on the
    same weights, at two of the probe's held-out prompts."""
    _, jp, tp, jv, tv = fidelity_models
    jparams, tparams = (jp, tp) if name == "f32" else (jv[name], tv[name])
    for i in (0, 3):
        prompt = JQF.make_corpus(np.random.RandomState(100 + i), 1, 8)[0]
        tprompt = torch.from_numpy(prompt)
        assert TQF.greedy_rollout(tparams, tprompt, 32) == \
            JQF.greedy_rollout(jparams, jnp.asarray(prompt), 32)
        assert TQF.beam_winner(tparams, tprompt, 24) == \
            JQF.beam_winner(jparams, jnp.asarray(prompt), 24)


def test_fidelity_tool_runs_every_variant():
    """``quant_variants`` keeps JAX's eight variants (bf16 and the seven
    int8 ones), none left out: every grouped leaf's shape is one the
    grouped pair takes, the two 32-group variants' groups of 8 on its
    simple route, the others on its tensor-core route."""
    tp = TQF.L.init_params(TQF.CFG, torch.Generator().manual_seed(0), "cpu")
    var = TQF.quant_variants(tp)
    assert list(var) == ["bf16", "w8", "w8a8", "w8a8_g128",
                         "w8a8_g128_projonly", "w8a8_8groups_like_g512",
                         "w8a8_32groups_like_g128", "w8a8_32groups_projonly"]
    assert not hasattr(TQF, "_refusal")
    simple = set()
    for name, vp in var.items():
        leaves = [vp["lm_head"]] + [vp["layers"][k] for k in
                                    TQF.Q.QUANT_KEYS]
        for w in leaves:
            if TQF.Q.is_quantized(w) and TQF.Q.is_grouped(w):
                O, D = w[TQF.Q.KMAJOR].shape[-2:]
                G = w["scale_a8"].shape[-2]
                assert D % G == 0
                if not TQF.K.grouped_on_wgmma(D, G, O):
                    simple.add(name)
    assert simple == {"w8a8_32groups_like_g128", "w8a8_32groups_projonly"}


@pytest.mark.parametrize("source", ["quant_matmul", "grouped_matmul"])
def test_gemm_phases_source_transform_keeps_the_kernel(source):
    """``tools/gemm_phases``: each Hopper W8A8 source (``w8a8_gemm``'s and
    the grouped GEMM's) carries every phase mark its ``// phases:`` line
    names, compiled away unless GQ_PHASES is defined, and the
    instrumented build is that source with the instrumentation around it,
    the text otherwise unchanged; no module of the package but the tool
    itself names it."""
    from infinisst_tpu_torch.tools import gemm_phases as G

    pkg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "infinisst_tpu_torch")
    with open(os.path.join(pkg, "csrc", f"{source}.cu")) as f:
        src = f.read()
    out, names = G.instrumented_source(src)
    assert out == G._PRELUDE + src + G._EPILOGUE
    assert 7 <= len(names) <= G.PHASE_BINS
    marks = sorted(set(int(i) for i in re.findall(r"GQ_PHASE\((\d+)\)",
                                                  src)))
    assert marks == list(range(len(names)))
    for m in ("GQ_PHASE_INIT()", "GQ_PHASE_END()", "GQ_BYTES("):
        assert m in src
    assert "#ifndef GQ_PHASES" in src and "#define GQ_PHASE(i)\n" in src
    users = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py") and name != "gemm_phases.py":
                with open(os.path.join(root, name)) as f:
                    if "gemm_phases" in f.read():
                        users.append(name)
    assert users == []


@pytest.mark.parametrize("name,op", [
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
     "4> >(X)", "mean reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, at::detail::Array<char*, 3> >(int, X)", "mul"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}",
     "bfloat16_copy_kernel_cuda"),
    ("nvjet_tst_64x24_64x16_4x2_h_bz_NNT", "nvjet_tst_64x24_64x16_4x2_h_bz_NNT"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8", "library GEMM"),
])
def test_op_split_names_the_op(name, op):
    """``tools/op_split.op_family``: the op of a device kernel's name, by
    the functor or ATen kernel its template names, else the name."""
    from infinisst_tpu_torch.tools.op_split import op_family

    assert op_family(name) == op
