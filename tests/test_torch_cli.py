"""The port's entry-point plumbing against the JAX package's: presets,
``agents/cli.py`` (its flags, the suppress list, ``build_agent`` from a
checkpoint, ``main`` end to end), the HF tokenizer adapter and
``train/main.build_params``.  All on the CPU at the dryrun preset.
"""

import argparse
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from infinisst_tpu.agents import cli as JCLI
from infinisst_tpu.core import presets as JP
from infinisst_tpu.data import audio as JAudio
from infinisst_tpu.data import template as JT
from infinisst_tpu.train import main as JMain
from infinisst_tpu_torch.agents import cli as TCLI
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import presets as TP
from infinisst_tpu_torch.data import template as TT
from infinisst_tpu_torch.train import main as TMain
from tests.test_cli_utils import FakeHFTok
from tests.test_e2e_files import _build_reference_bin
from tests.test_torch_convert import assert_trees_equal

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "llama31_tokenizer")


@pytest.mark.parametrize("name", ["flagship", "bench", "dryrun"])
def test_presets_match_jax(name):
    fn = {"flagship": "flagship_config", "bench": "bench_1chip_config",
          "dryrun": "dryrun_config"}[name]
    got = dataclasses.asdict(TP.PRESETS[name]())
    assert got == dataclasses.asdict(getattr(TP, fn)())
    assert got == dataclasses.asdict(getattr(JP, fn)())


def _parse(mod, argv):
    p = argparse.ArgumentParser()
    mod.add_args(p)
    return vars(p.parse_args(argv))


@pytest.mark.parametrize("argv", [
    [],
    ["--latency-multiplier", "2", "--beam", "2", "--dtype", "float32",
     "--model-preset", "dryrun", "--always-cache-system-prompt"],
    ["--state-dict-path", "x.bin", "--w2v2-path", "w.pt", "--w2v2-type",
     "hubert", "--rope", "0", "--xpos", "1", "--max-cache-size", "96",
     "--max-llm-cache-size", "500", "--suppress-non-language",
     "--timing", "t.timing", "--source-segment-size", "1920",
     "--eval-latency-unit", "char", "--sacrebleu-tokenizer", "zh",
     "--max-instances", "3", "--target-lang", "Chinese",
     "--min-start-sec", "0.5", "--repetition-penalty", "1.1"],
    ["--agent", "alignatt", "--speculative", "--spec-k", "2", "--do-sample",
     "--top-k", "5", "--temperature", "0.7"],
])
def test_add_args_parse_as_jax(argv):
    argv = ["--source", "a.source", "--target", "a.target"] + argv
    got, want = _parse(TCLI, argv), _parse(JCLI, argv)
    assert got.pop("device") == "cuda"
    assert got == want


def test_suppress_list_scans_added_tokens_and_skips_specials():
    """Mirrors tests/test_cli_utils.py: len(tokenizer) is scanned (added
    tokens included), decoded with skip_special_tokens=True."""
    got = TCLI.build_suppress_list(FakeHFTok())
    np.testing.assert_array_equal(got, [1, 3, 5])
    np.testing.assert_array_equal(got, JCLI.build_suppress_list(FakeHFTok()))


def test_suppress_list_vocab_size_fallback():
    class NoLen:
        vocab_size = 4

        def decode(self, ids, skip_special_tokens=True):
            return "(x" if ids[0] == 2 else "ok"

    np.testing.assert_array_equal(TCLI.build_suppress_list(NoLen()), [2])


def test_hf_tokenizer_adapter_matches_jax():
    """The fixture tokenizer with the 7 extra tokens registered by each
    package: equal ids, decodes, chat-template renders and chunk
    prompts."""
    pytest.importorskip("tokenizers")
    from transformers import AutoTokenizer

    def load(T):
        tok = AutoTokenizer.from_pretrained(FIXTURE)
        base = len(tok)
        toks = T.SpecialTokens(
            bos=tok.convert_tokens_to_ids("<|begin_of_text|>"),
            end_of_text=tok.convert_tokens_to_ids("<|end_of_text|>"),
            eot=tok.convert_tokens_to_ids("<|eot_id|>"),
            eos=tok.convert_tokens_to_ids("<|eot_id|>"),
            start_header=tok.convert_tokens_to_ids("<|start_header_id|>"),
            end_header=tok.convert_tokens_to_ids("<|end_header_id|>"),
            pad=tok.convert_tokens_to_ids("<|finetune_right_pad_id|>"),
            user=tok.convert_tokens_to_ids("user"),
            assistant=tok.convert_tokens_to_ids("assistant"),
            newline2=tok.encode("\n\n", add_special_tokens=False)[0],
            sp_patch=base, sp_start=base + 1, sp_end=base + 2,
            latency=(base + 3, base + 4, base + 5, base + 6),
        )
        cfg = SimpleNamespace(tokens=toks,
                              llama=SimpleNamespace(vocab_size=base + 16))
        return tok, toks, cfg

    from infinisst_tpu.core import config as JC
    from infinisst_tpu_torch.core import config as TCfg

    ttok, ttoks, tcfg = load(TCfg)
    jtok, jtoks, jcfg = load(JC)
    TT.register_special_tokens(ttok, tcfg)
    JT.register_special_tokens(jtok, jcfg)
    assert len(ttok) == len(jtok)
    ta, ja = TT.HFTokenizerAdapter(ttok), JT.HFTokenizerAdapter(jtok)
    assert ta.vocab_size == ja.vocab_size
    text = "Translate the following speech from English to German <latency_2>."
    assert ta.encode(text) == ja.encode(text)
    ids = ta.encode(text) + [ttoks.sp_patch, ttoks.eot]
    for skip in (True, False):
        assert ta.decode(ids, skip) == ja.decode(ids, skip)
    msgs = [{"role": "system", "content": text}]
    assert ta.apply_chat_template(msgs) == ja.apply_chat_template(msgs)
    tb = TT.PromptBuilder(ta, ttoks)
    jb = JT.PromptBuilder(ja, jtoks)
    for m in (1, 2):
        for first in (True, False):
            tp, jp = tb.chunk_prompt(m, first), jb.chunk_prompt(m, first)
            np.testing.assert_array_equal(tp.ids, jp.ids)
            assert tp.patch_start == jp.patch_start
        assert tb.system_prompt_size(m) == jb.system_prompt_size(m)
    with pytest.raises(AssertionError, match="do not match"):
        bad = SimpleNamespace(tokens=dataclasses.replace(ttoks, sp_patch=7),
                              llama=tcfg.llama)
        TT.register_special_tokens(AutoTokenizer.from_pretrained(FIXTURE),
                                   bad)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A synthetic reference .bin at the dryrun preset, two wav files
    (2.1 s and 1.3 s) and their source / target lists."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(42)
    bin_sd, _ = _build_reference_bin(rng, JP.dryrun_config())
    bin_path = d / "pytorch_model.bin"
    torch.save({k: torch.from_numpy(v) for k, v in bin_sd.items()}, bin_path)
    wavs = []
    for i, n in enumerate((34000, 20800)):
        wav = (np.sin(np.linspace(0, 700 + 100 * i, n)) * 0.3
               + rng.randn(n) * 0.02).astype(np.float32)
        p = d / f"talk{i}.wav"
        JAudio.write_wav(str(p), wav)
        wavs.append(str(p))
    (d / "tst.source").write_text("\n".join(wavs) + "\n")
    (d / "tst.target").write_text("ein kleiner test satz\tnoch einer\n"
                                  "zweiter talk text\n")
    return d


def _argv(files, out, *extra):
    return ["--agent", "infinisst", "--source", str(files / "tst.source"),
            "--target", str(files / "tst.target"), "--output", str(out),
            "--state-dict-path", str(files / "pytorch_model.bin"),
            "--model-preset", "dryrun", "--beam", "2",
            "--max-llm-cache-size", "120", "--always-cache-system-prompt",
            "--dtype", "float32", *extra]


def test_build_agent_from_checkpoint(files):
    """``build_agent`` on the CPU: its parameters equal ``from_jax`` of
    JAX ``build_params`` on the same .bin, bitwise, and over 2 chunks it
    emits the tokens of the port agent built directly from them."""
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig

    args = argparse.ArgumentParser()
    TCLI.add_args(args)
    args = args.parse_args(_argv(files, files / "unused", "--device", "cpu"))
    agent = TCLI.build_agent(args)

    class _A:
        llm_path = w2v2_path = None
        sllm_weight_path = str(files / "pytorch_model.bin")

    want = from_jax(jax.device_get(
        JMain.build_params(_A, JP.dryrun_config())), device="cpu")
    assert_trees_equal(agent.params, want)

    cfg = TP.dryrun_config()
    direct = InfiniSSTAgent(
        want, cfg,
        StreamConfig(max_cache_frames=576, max_llm_cache_tokens=120,
                     llm_cache_capacity=1280),
        TT.PromptBuilder(TT.StubTokenizer(cfg.llama.vocab_size), cfg.tokens),
        InfiniSSTOptions(beam=2, max_llm_cache_size=120,
                         always_cache_system_prompt=True),
        param_dtype=torch.float32, device="cpu",
    )
    out = []
    for a in (agent, direct):
        rng = np.random.RandomState(5)
        a.push(rng.randn(2 * a.chunk_samples).astype(np.float32) * 0.1)
        out.append(list(a.states.target_ids))
    assert out[0] == out[1] and out[0]


def test_main_matches_jax_cli(files, tmp_path, monkeypatch):
    """``main`` end to end on the CPU (checkpoint -> agent -> wav files ->
    eval runner -> scores) against the JAX CLI on the same files: equal
    predictions and delays in ``instances.log``, equal BLEU and
    StreamLAAL.  The stub tokenizer's ids lie past the dryrun vocabulary,
    so this also holds the port's gathers and scatters of such ids to
    JAX's (clamped and dropped)."""
    got = TCLI.main(_argv(files, tmp_path / "port", "--device", "cpu"))
    monkeypatch.setattr(sys, "argv", ["cli"] + _argv(files, tmp_path / "jax"))
    JCLI.main()
    want = json.loads((tmp_path / "jax" / "scores.json").read_text())
    for key in ("stream_laal", "n_instances"):
        assert got[key] == want[key], key
    assert np.isnan(got["bleu"]) == np.isnan(want["bleu"])
    if not np.isnan(want["bleu"]):
        assert got["bleu"] == want["bleu"]
    logs = [[json.loads(line) for line in
             (tmp_path / d / "instances.log").read_text().splitlines()]
            for d in ("port", "jax")]
    assert len(logs[0]) == len(logs[1]) == 2
    for g, w in zip(*logs):
        for key in ("prediction", "reference", "delays", "source_length"):
            assert g[key] == w[key], key
    assert any(r["prediction"] for r in logs[0])


@pytest.mark.parametrize("extra, item", [
    (["--agent", "alignatt", "--do-sample"], "beam-only"),
    (["--agent", "streamatt", "--speculative"], "--agent infinisst"),
    (["--agent", "alignatt", "--speculative"], "--agent infinisst"),
    (["--spec-head-ids", "ids.npy"], "--spec-head-vocab"),
    (["--spec-adapter", "a.npz"], "requires --speculative"),
])
def test_unported_paths_exit(files, tmp_path, extra, item):
    """The exits the JAX CLI has too: sampling or speculation with an
    offline agent, a shortlist file without its width, a draft file
    without --speculative (the speculative and sampling paths themselves
    run: test_main_speculative_and_sampling)."""
    argv = _argv(files, tmp_path, "--device", "cpu")
    argv[argv.index("--agent"):argv.index("--agent") + 2] = []
    with pytest.raises(SystemExit, match=item):
        TCLI.main(argv + extra)


def _predictions(out):
    return [json.loads(line)["prediction"] for line in
            (out / "instances.log").read_text().splitlines()]


def test_main_speculative_and_sampling(files, tmp_path):
    """``main`` with the lifted flags on the CPU: --do-sample --top-k 1
    predicts what --beam 1 does, --speculative --do-sample --top-k 1
    what --speculative does (both greedy chains), and --speculative
    --spec-beam what the plain beam 2 does (the winner is beam search's),
    each over the two talks."""
    runs = {
        "greedy": ["--beam", "1"],
        "sample": ["--beam", "1", "--do-sample", "--top-k", "1",
                   "--translation-output-file", str(tmp_path / "s.json")],
        "spec": ["--speculative", "--spec-draft-layers", "1", "--spec-k",
                 "2", "--spec-no-guard"],
        "spec_sample": ["--speculative", "--spec-draft-layers", "1",
                        "--spec-k", "2", "--spec-no-guard", "--do-sample",
                        "--top-k", "1", "--translation-output-file",
                        str(tmp_path / "dpo.json")],
        "beam": [],
        "spec_beam": ["--speculative", "--spec-beam", "--spec-draft-layers",
                      "1", "--spec-k", "2"],
    }
    got = {}
    for name, extra in runs.items():
        TCLI.main(_argv(files, tmp_path / name, "--device", "cpu", *extra))
        got[name] = _predictions(tmp_path / name)
    assert got["sample"] == got["greedy"]
    assert got["spec_sample"] == got["spec"]
    assert got["spec_beam"] == got["beam"]
    assert any(got["spec"]) and len(got["spec"]) == 2
    # --do-sample dumps the per-chunk translations, as the JAX CLI does
    assert (tmp_path / "dpo.json").read_text().count("[") == 2


def test_spec_loaders_match_jax(tmp_path):
    """The shortlist, low-rank and adapter loaders take the JAX CLI's
    files and refuse what it refuses; an adapter saved by the JAX
    package loads here, depth-checked."""
    from infinisst_tpu.train import draft as JD
    from infinisst_tpu_torch.train import draft as TD

    ids = np.arange(40)[::-1].copy()
    np.save(tmp_path / "ids.npy", ids)
    np.testing.assert_array_equal(
        TCLI._load_head_ids(str(tmp_path / "ids.npy"), 16),
        JCLI._load_head_ids(str(tmp_path / "ids.npy"), 16, np))
    with pytest.raises(SystemExit, match="1-D array"):
        TCLI._load_head_ids(str(tmp_path / "ids.npy"), 64)
    np.savez(tmp_path / "f.npz", a=np.ones((4, 2)), b=np.ones((2, 6)))
    np.savez(tmp_path / "bad.npz", a=np.ones((4, 2)))
    ns = SimpleNamespace(spec_lowrank_head=str(tmp_path / "f.npz"),
                         speculative=True)
    got = TCLI._load_lowrank_head(ns)
    assert got["a"].shape == (4, 2) and got["b"].shape == (2, 6)
    with pytest.raises(SystemExit, match="must contain"):
        TCLI._load_lowrank_head(SimpleNamespace(
            spec_lowrank_head=str(tmp_path / "bad.npz"), speculative=True))
    cfg = TP.dryrun_config().llama
    ada = JD.init_exit_adapter(jax.random.PRNGKey(0), cfg, rank=8)
    JD.save_adapter(str(tmp_path / "a.npz"), ada, d=2)
    ns = SimpleNamespace(spec_adapter=str(tmp_path / "a.npz"),
                         speculative=True, spec_draft_layers=2)
    back = TCLI._load_adapter(ns)
    for k in ("ln", "w1", "w2"):
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(ada[k]))
    ns.spec_draft_layers = 4
    with pytest.raises(ValueError, match="draft_layers=2"):
        TCLI._load_adapter(ns)
    # and the port's save round-trips through the JAX loader
    TD.save_adapter(str(tmp_path / "b.npz"), back, d=3)
    again = JD.load_adapter(str(tmp_path / "b.npz"), expect_d=3)
    np.testing.assert_array_equal(np.asarray(again["w1"]),
                                  np.asarray(ada["w1"]))


@pytest.mark.parametrize("agent", ["alignatt", "streamatt"])
def test_build_offline_agent(files, agent):
    """``--agent alignatt|streamatt``: the JAX CLI's options (the minimum
    start raised to 0.32 s, the AlignAtt and StreamAtt flags), on the
    CPU."""
    from infinisst_tpu_torch.agents.alignatt import AlignAttAgent
    from infinisst_tpu_torch.agents.streamatt import StreamAttAgent

    args = argparse.ArgumentParser()
    TCLI.add_args(args)
    argv = _argv(files, files / "unused", "--device", "cpu",
                 "--frame-num", "2", "--attn-layer", "1", "--max-len-a",
                 "4", "--min-start-sec", "0.1", "--text-preserve-num", "7",
                 "--min-speech-duration", "3.5", "--target-lang", "Chinese")
    argv[argv.index("--agent") + 1] = agent
    a = TCLI.build_agent(args.parse_args(argv))
    cls = AlignAttAgent if agent == "alignatt" else StreamAttAgent
    assert type(a) is cls and a.device.type == "cpu"
    o = a.opts
    assert (o.frame_num, o.attn_layer, o.max_len_a, o.max_len_b,
            o.min_start_sec, o.beam, o.target_lang) == (
                2, 1, 4, 20, 0.32, 2, "Chinese")
    if agent == "streamatt":
        assert (o.text_preserve_num, o.min_speech_duration,
                o.max_speech_duration) == (7, 3.5, 28.8)
    else:
        assert not hasattr(o, "text_preserve_num")


def test_main_streamatt_matches_jax_cli(files, tmp_path, monkeypatch):
    """``main --agent streamatt`` end to end on the CPU against the JAX
    CLI on the same checkpoint and talks, the JAX prefill probe read over
    the prompt's speech span as the port reads it
    (tests/test_torch_alignatt.py): equal predictions, delays and
    StreamLAAL."""
    from tests.test_torch_alignatt import shift_jax_probe

    shift_jax_probe(monkeypatch)
    argv = _argv(files, tmp_path / "port", "--device", "cpu",
                 "--target-lang", "Chinese")
    argv[argv.index("--agent") + 1] = "streamatt"
    got = TCLI.main(argv)
    argv = _argv(files, tmp_path / "jax", "--target-lang", "Chinese")
    argv[argv.index("--agent") + 1] = "streamatt"
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    JCLI.main()
    want = json.loads((tmp_path / "jax" / "scores.json").read_text())
    for key in ("stream_laal", "n_instances"):
        assert got[key] == want[key], key
    logs = [[json.loads(line) for line in
             (tmp_path / d / "instances.log").read_text().splitlines()]
            for d in ("port", "jax")]
    assert len(logs[0]) == len(logs[1]) == 2
    for g, w in zip(*logs):
        for key in ("prediction", "delays", "source_length"):
            assert g[key] == w[key], key
    assert any(r["prediction"] for r in logs[0])


def test_translate_main_matches_jax(files, monkeypatch, capsys):
    """``tools/translate.py``'s ``main`` (an AlignAtt agent through the
    CLI's parser, each wav pushed whole and finished) on the CPU against
    the JAX tool's output on the same checkpoint and wav, the JAX prefill
    probe read over the prompt's speech span as the port reads it."""
    from infinisst_tpu.tools import translate as JTR
    from infinisst_tpu_torch.tools import translate as TTR
    from tests.test_torch_alignatt import shift_jax_probe

    shift_jax_probe(monkeypatch)
    wav = str(files / "talk1.wav")
    argv = ["--wav", wav, "--state-dict-path",
            str(files / "pytorch_model.bin"), "--model-preset", "dryrun",
            "--beam", "2", "--dtype", "float32"]
    got = TTR.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["translate"] + argv)
    JTR.main()
    jax_out = capsys.readouterr().out
    assert port_out == jax_out and got[0] and port_out.startswith(wav)


def test_random_init_is_seeded():
    """No paths: every component is drawn from its seeded generator, so
    two builds are equal; a loaded component replaces its draw."""
    class _A:
        llm_path = w2v2_path = sllm_weight_path = None

    cfg = TP.dryrun_config()
    a = TMain.build_params(_A, cfg, device="cpu")
    b = TMain.build_params(_A, cfg, device="cpu", dtype=torch.bfloat16)
    assert_trees_equal(a, TMain.random_params(cfg, "cpu"))
    assert_trees_equal(b, TMain.random_params(cfg, "cpu", torch.bfloat16))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")


def test_cli_defaults_to_cuda(files, tmp_path, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(_argv(files, tmp_path))

    class _A:
        llm_path = w2v2_path = sllm_weight_path = None

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMain.build_params(_A, TP.dryrun_config())
