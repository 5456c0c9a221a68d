"""The port's bench (``python -m infinisst_tpu_torch.bench``): its metric
names and tags follow ``bench.py``'s rules for every flag combination
(the stream and serve modes, speculative and sampling too), the outlier
rules, ``run_stream`` + the summary on the tiny CPU agent, the
speculative options and fields, and the serve mode's run, summary and
JSON line on a tiny CPU engine (speculative too)."""

import json

import jax
import numpy as np
import pytest
import torch

from infinisst_tpu_torch import bench as B
from infinisst_tpu_torch.convert.from_jax import from_jax
from tests.test_agent import tiny_params
from tests.test_torch_agent import make_port_agent

torch.set_num_threads(1)

# argv -> the metric bench.py prints for it (tags: bench.py:148-160;
# names: :340-341 multi-stream, :396 schedule, :493 a single stream).
# --no-act-int8, --bf16-head and --quantize on the 8B model leave the tag
# as it is, as in bench.py.
NAMES = [
    ([], "streaming_rtf_m1_beam4_8b_int8"),
    (["--multiplier", "2"], "streaming_rtf_m2_beam4_8b_int8"),
    (["--chunks", "30", "--multiplier", "4"], "streaming_rtf_m4_beam4_8b_int8"),
    (["--no-act-int8"], "streaming_rtf_m1_beam4_8b_int8"),
    (["--bf16-head"], "streaming_rtf_m1_beam4_8b_int8"),
    (["--quantize"], "streaming_rtf_m1_beam4_8b_int8"),
    (["--group128"], "streaming_rtf_m1_beam4_8b_int8_g128"),
    (["--group128", "--group-head"], "streaming_rtf_m1_beam4_8b_int8_g128h"),
    (["--group-size", "512"], "streaming_rtf_m1_beam4_8b_int8_g512"),
    (["--group128", "--group-size", "64"],
     "streaming_rtf_m1_beam4_8b_int8_g64"),
    (["--group-head"], "streaming_rtf_m1_beam4_8b_int8"),
    (["--model", "bench"], "streaming_rtf_m1_beam4_1chip"),
    (["--model", "bench", "--quantize"], "streaming_rtf_m1_beam4_1chip_int8"),
    (["--model", "bench", "--group128"], "streaming_rtf_m1_beam4_1chip"),
    (["--schedule", "1,1,1,2,2,4,4"], "streaming_rtf_mswitch_beam4_8b_int8"),
    (["--schedule", "1,2", "--group128"],
     "streaming_rtf_mswitch_beam4_8b_int8_g128"),
    (["--multi-stream"], "streaming_rtf_m1_beam4_8b_int8_multistream"),
    (["--multi-stream", "5", "--multiplier", "2", "--model", "bench"],
     "streaming_rtf_m2_beam4_1chip_multistream"),
    # --mode serve: bench.py:701-706 (mixed pool), :761-763; the serve
    # mode's tag is 8b_int8 or 1chip whatever the group flags say
    (["--mode", "serve"], "serve_decode_tok_per_s_pool8_beam4_m1_8b_int8"),
    (["--mode", "serve", "--pool", "4", "--beam", "1"],
     "serve_decode_tok_per_s_pool4_beam1_m1_8b_int8"),
    (["--mode", "serve", "--multiplier", "2", "--churn"],
     "serve_decode_tok_per_s_pool8_beam4_m2_churn_8b_int8"),
    (["--mode", "serve", "--multipliers", "1,2"],
     "serve_decode_tok_per_s_pool8_beam4_mixedm1x2_8b_int8"),
    (["--mode", "serve", "--multipliers", "1,2,4", "--churn", "--pool", "6"],
     "serve_decode_tok_per_s_pool6_beam4_mixedm1x2x4_8b_int8"),
    (["--mode", "serve", "--model", "bench"],
     "serve_decode_tok_per_s_pool8_beam4_m1_1chip"),
    (["--mode", "serve", "--group128"],
     "serve_decode_tok_per_s_pool8_beam4_m1_8b_int8"),
    # the offline agents: bench.py:843 and :918-920, always the 8B W8A8
    (["--mode", "alignatt"], "alignatt_rtf_beam4_parity_8b_int8"),
    (["--mode", "alignatt", "--early-stop"],
     "alignatt_rtf_beam4_es_8b_int8"),
    (["--mode", "alignatt", "--model", "bench", "--group128"],
     "alignatt_rtf_beam4_parity_8b_int8"),
    (["--mode", "streamatt"], "streamatt_rtf_beam4_8b_int8"),
    (["--mode", "streamatt", "--early-stop", "--chunks", "50"],
     "streamatt_rtf_beam4_8b_int8"),
    # the speculative stream (bench.py:459-477) and sampling (:496)
    (["--speculative"], "streaming_rtf_m1_spec_d8k4_8b_int8"),
    (["--speculative", "--spec-beam"],
     "streaming_rtf_m1_spec_beam4_d8k4_8b_int8"),
    (["--speculative", "--do-sample"],
     "streaming_rtf_m1_spec_sample_d8k4_8b_int8"),
    (["--speculative", "--spec-accept-all", "--spec-draft-layers", "4",
      "--spec-k", "6"], "streaming_rtf_m1_spec_acceptall_d4k6_8b_int8"),
    (["--speculative", "--spec-head-vocab", "16384"],
     "streaming_rtf_m1_spec_d8k4_hv16k_8b_int8"),
    (["--speculative", "--spec-lowrank-rank", "512"],
     "streaming_rtf_m1_spec_d8k4_lr512_8b_int8"),
    (["--speculative", "--spec-adapter-rank", "2048"],
     "streaming_rtf_m1_spec_d8k4_ada2048_8b_int8"),
    (["--speculative", "--spec-resid-scale", "0"],
     "streaming_rtf_m1_spec_d8k4_ra0_8b_int8"),
    (["--speculative", "--spec-resid-scale", "0.5", "--multiplier", "2"],
     "streaming_rtf_m2_spec_d8k4_ra0.5_8b_int8"),
    (["--do-sample"], "streaming_rtf_m1_sample_8b_int8"),
    (["--do-sample", "--model", "bench"], "streaming_rtf_m1_sample_1chip"),
    # the speculative pool (bench.py:662-670 mixed, :732-738 uniform)
    (["--mode", "serve", "--speculative"],
     "serve_decode_tok_per_s_pool8_specd8k4_m1_8b_int8"),
    (["--mode", "serve", "--speculative", "--do-sample"],
     "serve_decode_tok_per_s_pool8_specSd8k4_m1_8b_int8"),
    (["--mode", "serve", "--speculative", "--spec-accept-all",
      "--spec-head-vocab", "16384", "--spec-resid-scale", "0"],
     "serve_decode_tok_per_s_pool8_specAAd8k4hv16k_m1_8b_int8"),
    (["--mode", "serve", "--speculative", "--spec-resid-scale", "0",
      "--multipliers", "1,2"],
     "serve_decode_tok_per_s_pool8_specd8k4ra0_mixedm1x2_8b_int8"),
]


@pytest.mark.parametrize("argv, name", NAMES, ids=lambda x: str(x))
def test_metric_names_follow_bench_py(argv, name):
    assert B.metric_name(B.parse_args(argv)) == name


def test_defaults():
    args = B.parse_args([])
    assert (args.model, args.chunks, args.multiplier, args.device,
            args.multi_stream, B.WARMUP) == ("8b", 12, 1, "cuda", None, 3)
    assert B.parse_args(["--multi-stream"]).multi_stream == 3


def _run(times, chunk_sec=0.96):
    return dict(times=list(times), rtfs=[t / chunk_sec for t in times],
                evict_marks=[0] * len(times), tokens=0)


def test_one_outlier_is_dropped():
    times = [0.4, 0.41, 0.39, 0.4, 2.0, 0.42, 0.4, 0.38, 0.41]
    r = B.summarize(_run(times), 1, "m", 0.96)
    kept = [t for t in times if t != 2.0]
    assert r["outliers_dropped"] == 1 and r["dropped_s"] == [2.0]
    assert r["value"] == round(float(np.mean(kept)) / 0.96, 4)
    assert r["rtf_untrimmed_mean"] == round(float(np.mean(times)) / 0.96, 4)
    assert r["rtf_median"] == round(0.4 / 0.96, 4)
    assert r["vs_baseline"] == round(0.382 / (np.mean(kept) / 0.96), 3)
    assert set(r) == {"metric", "value", "unit", "vs_baseline",
                      "outliers_dropped", "dropped_s", "rtf_untrimmed_mean",
                      "rtf_median", "rtf_p95"}


def test_many_outliers_are_kept():
    times = [0.4, 0.41, 2.0, 0.4, 2.5, 0.42, 0.4, 0.38, 0.41]
    r = B.summarize(_run(times), 2, "m", 1.92)
    assert r["outliers_dropped"] == 0 and r["dropped_s"] == []
    assert r["value"] == round(float(np.mean(times)) / 1.92, 4)
    assert r["vs_baseline"] == round(0.286 / (np.mean(times) / 1.92), 3)


def test_eviction_fields():
    run = _run([0.4, 0.5, 0.4, 0.6, 0.5])
    run["evict_marks"] = [0, 0, 1, 1, 2]
    r = B.summarize(run, 1, "m", 0.96)
    assert r["evictions"] == 2 and r["first_evict_timed_chunk"] == 2
    pre, post = np.mean(run["rtfs"][:2]), np.mean(run["rtfs"][2:])
    assert r["rtf_pre_evict_mean"] == round(float(pre), 4)
    assert r["evict_rtf_delta"] == round(float(post - pre), 4)


def test_run_stream_on_the_tiny_agent():
    """Five chunks of the tiny agent on the CPU, the first three untimed;
    then a schedule that switches the multiplier mid-stream."""
    agent = make_port_agent(from_jax(jax.device_get(tiny_params()),
                                     device="cpu"))
    run = B.run_stream(agent, 5, warmup=3)
    assert len(run["times"]) == len(run["rtfs"]) == 2
    assert all(t > 0 for t in run["times"])
    assert run["rtfs"][0] == run["times"][0] / 0.96
    assert run["tokens"] == len(agent.states.target_ids) > 0
    r = B.summarize(run, 1, "streaming_rtf_m1_beam4_tiny", 0.96)
    assert r["metric"] == "streaming_rtf_m1_beam4_tiny" and r["value"] > 0

    agent.reset()
    run = B.run_stream(agent, 4, warmup=1, schedule=[1, 2, 2, 1])
    assert int(agent.enc_state.n_frames[0]) == 48 * (1 + 2 + 2 + 1)
    secs = [1.92, 1.92, 0.96]  # the audio of each timed chunk
    assert run["rtfs"] == [t / s for t, s in zip(run["times"], secs)]
    assert B.summarize_schedule(run, "s")["value"] > 0


@pytest.mark.parametrize("argv", [["--mode", "train", "--speculative"],
                                  ["--mode", "train"],
                                  ["--mode", "train-io"],
                                  ["--mode", "train-io", "--do-sample"]])
def test_unported_modes_exit(argv):
    """The training modes, ported now, get as far as the card whatever the
    decode flags (and raise without one, as every mode does); they run on
    the CPU in test_train_modes_print_the_jax_line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main(argv)


# bench.py's JSON keys of its two training rows (:1021-1026, :1199-1213)
TRAIN_KEYS = ("metric", "value", "unit", "vs_baseline")
TRAIN_IO_KEYS = TRAIN_KEYS + ("pipeline", "steps_pipelined",
                              "sec_per_step_pipelined",
                              "sec_per_step_synced",
                              "speech_s_per_s_synced", "final_loss")


@pytest.mark.parametrize("mode", ["train", "train-io"])
def test_train_modes_print_the_jax_line(mode, capsys):
    """--mode train and train-io on the CPU at a cut size (the dryrun
    preset, 960 ms windows, 3 timed steps): the JSON line of bench.py's
    row, finite and positive, and the steps on stderr."""
    from infinisst_tpu_torch.core.presets import dryrun_config

    args = B.parse_args(["--mode", mode, "--device", "cpu"])
    run = B.main_train if mode == "train" else B.main_train_io
    result = run(args, cfg=dryrun_config(), units=1, n_steps=3)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    # (train-io's final_loss is NaN here: the stub tokenizer's ids lie past
    # the dryrun vocabulary, and a target past it reads NaN, as in JAX)
    assert json.dumps(line) == json.dumps(result)
    keys = TRAIN_KEYS if mode == "train" else TRAIN_IO_KEYS
    assert tuple(line) == keys
    assert line["metric"] == (B.TRAIN_METRIC if mode == "train"
                              else B.TRAIN_IO_METRIC)
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert "step 2" in err and "peak memory" in err
    if mode == "train-io":
        assert line["steps_pipelined"] == 3


@pytest.mark.parametrize("argv", [["--speculative"],
                                  ["--mode", "serve", "--speculative"],
                                  ["--do-sample", "--chunks", "4"]])
def test_spec_flags_reach_the_card(argv):
    """The flags the bench refused before its speculative port now get
    as far as the card (and raise without one, as every mode does)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main(argv)


def test_spec_stream_on_the_tiny_agent():
    """The speculative options of ``spec_options`` on the tiny agent: the
    draft head factors and the adapter made from seeded generators (the
    same twice), ``--spec-resid-scale 0`` zeroing the output
    projections above the draft (the draft's argmax is then the
    target's: every draft token accepted), and the spec fields of the
    line."""
    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    cfg = make_port_agent(tp).cfg
    args = B.parse_args(["--speculative", "--spec-draft-layers", "1",
                         "--spec-k", "3", "--spec-lowrank-rank", "8",
                         "--spec-adapter-rank", "4", "--spec-resid-scale",
                         "0", "--device", "cpu"])
    kw, params = B.spec_options(args, cfg, tp, torch.device("cpu"))
    kw2, _ = B.spec_options(args, cfg, tp, torch.device("cpu"))
    assert torch.equal(kw["spec_lowrank_head"]["b"],
                       kw2["spec_lowrank_head"]["b"])
    assert kw["spec_adapter"]["w1"].shape == (cfg.llama.hidden_size, 4)
    wo = params["llama"]["layers"]["wo"]
    assert not wo[1:].any() and torch.equal(wo[:1], tp["llama"]["layers"]
                                            ["wo"][:1])
    assert not params["llama"]["layers"]["w_down"][1:].any()
    # the resid-scaled stream, full draft head: the draft is the target,
    # so the real verify accepts what --spec-accept-all forces (the same
    # rounds and tokens; a round cut by the cap accepts fewer than k)
    out = {}
    for extra in ([], ["--spec-accept-all"]):
        args = B.parse_args(["--speculative", "--spec-draft-layers", "1",
                             "--spec-k", "3", "--spec-resid-scale", "0",
                             "--spec-no-guard", "--device", "cpu"] + extra)
        kw, params = B.spec_options(args, cfg, tp, torch.device("cpu"))
        agent = make_port_agent(params, **kw)
        run = B.run_stream(agent, 4, warmup=2)
        out[bool(extra)] = (B.spec_fields(agent), agent.states.target_ids)
    fields, ids = out[False]
    assert (fields, ids) == out[True]
    assert fields["accept_rate"] > 0.5 and fields["rounds"] > 0
    assert fields["guard_fallback"] is False
    assert fields["fallback_warmed"] is False
    assert fields["breakeven_tokens_per_round"] is None
    assert fields["emitted"] == run["tokens"] > 0


def test_speculative_serve_line_on_the_tiny_engine(monkeypatch, capsys):
    """``main --mode serve --speculative --do-sample`` on a tiny CPU
    engine: the speculative serve metric with its acceptance and guard
    fields, and the rounds' draft and verify forwards on stderr."""
    from tests.test_torch_serve import port_engine

    eng = port_engine(2, 1, None, cap=60, speculative=True,
                      spec_draft_layers=1, spec_k=2, do_sample=True,
                      sample_seed=1)
    monkeypatch.setattr(B, "build_engine", lambda args: eng)
    argv = ["--mode", "serve", "--device", "cpu", "--pool", "2",
            "--chunks", "2", "--speculative", "--do-sample",
            "--spec-draft-layers", "1", "--spec-k", "2"]
    result = B.main(argv)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["metric"] == "serve_decode_tok_per_s_pool2_specSd1k2_m1_8b_int8"
    assert {"accept_rate", "guard_fallback", "fallback_warmed"} <= set(result)
    forwards = json.loads(err.split("engine forwards ")[1].splitlines()[0])
    assert forwards["verify"] == eng.spec_stats["rounds"] > 0
    assert forwards["draft"] == 2 * forwards["verify"]
    assert "model forwards " in err


def test_bench_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main(["--chunks", "4"])


def _tiny_engine(beam=2, multipliers=None, pool=2):
    from tests.test_torch_serve import port_engine

    return port_engine(pool, beam, multipliers, cap=60)


@pytest.mark.parametrize("mixed", [False, True])
def test_serve_run_and_line_on_the_tiny_engine(monkeypatch, capsys, mixed):
    """``main`` in serve mode on a tiny CPU engine: one JSON line with
    bench.py's keys, the tokens decoded over the timed ticks, and the
    launches and forwards on stderr (a mixed (1, 2) pool: two warm-up
    ticks, then chunks x 2 ticks; a uniform pool with churn halfway)."""
    argv = ["--mode", "serve", "--device", "cpu", "--pool", "2", "--beam",
            "2", "--chunks", "2"]
    argv += ["--multipliers", "1,2"] if mixed else ["--churn"]
    eng = _tiny_engine(multipliers=(1, 2) if mixed else None)
    monkeypatch.setattr(B, "build_engine", lambda args: eng)
    result = B.main(argv)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    metric = ("serve_decode_tok_per_s_pool2_beam2_mixedm1x2_8b_int8" if mixed
              else "serve_decode_tok_per_s_pool2_beam2_m1_churn_8b_int8")
    keys = {"metric", "value", "unit", "vs_baseline", "slot_chunk_p50_ms",
            "slot_chunk_p95_ms", "slot_chunk_p99_ms", "slot_chunks_timed",
            "evictions"}
    if not mixed:
        keys |= {"churn_tick", "slot_chunk_p99_ms_first_half",
                 "slot_chunk_p99_ms_second_half"}
    assert set(result) == keys and result["metric"] == metric
    assert result["unit"] == "tok/s/chip" and result["value"] > 0
    assert abs(result["vs_baseline"] - result["value"] / 30.0) < 1e-3
    # every slot's chunk is timed once per tick it prefilled in
    assert result["slot_chunks_timed"] == (4 + 2 if mixed else 2 * 2)
    assert "per-stream RTF=" in err and "kernel launches " in err
    forwards = json.loads(err.split("engine forwards ")[1].splitlines()[0])
    assert forwards["prefill"] == (2 + 4 if mixed else 1 + 2)
    assert forwards["token"] > 0


def test_run_serve_counts_the_timed_ticks():
    """Batched greedy, three slots: one untimed tick, then every slot's
    chunk in each of the three timed ticks; the tokens counted are those
    decoded after the warm-up tick."""
    eng = _tiny_engine(beam=1, pool=3)
    run = B.run_serve(eng, 3)
    assert run["n_ticks"] == len(run["tick_walls"]) == 3
    assert len(run["slot_lat"]) == 3 * 3 and run["audio_s"] == 3 * 0.96
    total = sum(len(s.target_ids) for s in eng.slots)
    assert 0 < run["tokens"] < total
    assert eng.forwards["prefill"] == 4


def test_offline_summary():
    """The offline modes' line: the mean wall over 0.96 s, vs_baseline
    0.67 over it (bench.py:843-848), the median and p95."""
    times = [1.2, 1.0, 1.4, 0.9, 3.0]
    r = B.summarize_offline(times, "alignatt_rtf_beam4_parity_8b_int8")
    rtf = float(np.mean(times)) / 0.96
    assert r == {
        "metric": "alignatt_rtf_beam4_parity_8b_int8",
        "value": round(rtf, 4), "unit": "rtf",
        "vs_baseline": round(0.67 / rtf, 3),
        "rtf_median": round(1.2 / 0.96, 4),
        "rtf_p95": round(float(np.percentile(times, 95)) / 0.96, 4),
    }


def _tiny_offline_agent(mode, early_stop):
    from infinisst_tpu_torch.agents.alignatt import (
        AlignAttAgent, AlignAttOptions,
    )
    from infinisst_tpu_torch.agents.streamatt import (
        StreamAttAgent, StreamAttOptions,
    )
    from tests.test_torch_alignatt import _port_agent

    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    if mode == "alignatt":
        return _port_agent(tp, AlignAttAgent, AlignAttOptions,
                           attn_early_stop=early_stop)
    return _port_agent(tp, StreamAttAgent, StreamAttOptions,
                       target_lang="Chinese", attn_early_stop=True,
                       max_speech_duration=1.5, min_speech_duration=0.5,
                       text_preserve_num=3)


@pytest.mark.parametrize("mode,early_stop", [("alignatt", False),
                                             ("alignatt", True),
                                             ("streamatt", False)])
def test_offline_modes_on_the_tiny_agent(monkeypatch, capsys, mode,
                                         early_stop):
    """``main --mode alignatt|streamatt`` on a tiny CPU agent, with the
    chunk counts cut (3 chunks, 1 untimed): one JSON line, each chunk's
    wall, steps and prompt bucket and the launches on stderr."""
    agent = _tiny_offline_agent(mode, early_stop)
    monkeypatch.setattr(B, "build_offline_agent", lambda args: agent)
    monkeypatch.setattr(B, "ALIGNATT_MIN_CHUNKS", 3)
    monkeypatch.setattr(B, "ALIGNATT_WARMUP", 1)
    monkeypatch.setattr(B, "STREAMATT_MIN_CHUNKS", 3)
    monkeypatch.setattr(B, "STREAMATT_TIMED_FROM", 1)
    argv = ["--mode", mode, "--device", "cpu", "--chunks", "2"]
    result = B.main(argv + (["--early-stop"] if early_stop else []))
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    metric = {("alignatt", False): "alignatt_rtf_beam4_parity_8b_int8",
              ("alignatt", True): "alignatt_rtf_beam4_es_8b_int8",
              ("streamatt", False): "streamatt_rtf_beam4_8b_int8"}
    assert result["metric"] == metric[(mode, early_stop)]
    assert set(result) == {"metric", "value", "unit", "vs_baseline",
                           "rtf_median", "rtf_p95"}
    assert result["value"] > 0 and result["unit"] == "rtf"
    chunks = [ln for ln in err.splitlines() if ln.startswith("chunk ")]
    assert len(chunks) == 3 and all("prompt_bucket=64" in ln or
                                    "prompt_bucket=128" in ln
                                    for ln in chunks)
    assert "chunks=2 " in err and "kernel launches " in err
