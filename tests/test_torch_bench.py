"""The port's bench (``python -m infinisst_tpu_torch.bench``): its metric
names and tags follow ``bench.py``'s rules for every flag combination, the
outlier rules, and ``run_stream`` + the summary on the tiny CPU agent."""

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


@pytest.mark.parametrize("argv", [["--mode", "serve"], ["--mode", "train"],
                                  ["--mode", "alignatt"], ["--speculative"]])
def test_unported_modes_exit(argv, capsys):
    with pytest.raises(SystemExit) as e:
        B.main(argv)
    assert e.value.code != 0
    assert "not ported yet" in capsys.readouterr().err


def test_bench_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main(["--chunks", "4"])
