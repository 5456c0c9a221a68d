"""The port's eval side against the JAX package's: the latency metrics on
the golden vectors, the native mwer segmentation against the Python DP,
the streaming eval runner with a deterministic fake agent, the tiny port
agent through the port's runner, and the wav reader."""

import json
import os

import numpy as np
import pytest
import torch

from infinisst_tpu.data import audio as JAudio
from infinisst_tpu.eval import latency as JL
from infinisst_tpu.eval import runner as JR
from infinisst_tpu_torch.agents.base import ReadAction, WriteAction
from infinisst_tpu_torch.data import audio as TAudio
from infinisst_tpu_torch.eval import latency as TL
from infinisst_tpu_torch.eval import runner as TR
from tests.test_latency_golden import GOLD, _split_cost

torch.set_num_threads(1)


class _TwoStepAgent:
    """Reads until it has 4 samples, then writes 'hi' (finished once the
    source is)."""

    def __init__(self, args):
        from infinisst_tpu_torch.agents.base import AgentStates

        self.args = args
        self.states = AgentStates()

    def policy(self, states):
        if len(states.source) < 4:
            return ReadAction()
        return WriteAction(content="hi", finished=states.source_finished)


def test_simuleval_agent_needs_simuleval(monkeypatch):
    import builtins
    import sys

    from infinisst_tpu_torch.agents.base import make_simuleval_agent

    for name in [n for n in sys.modules if n.split(".")[0] == "simuleval"]:
        monkeypatch.delitem(sys.modules, name)
    real_import = builtins.__import__

    def no_simuleval(name, *a, **k):
        if name.split(".")[0] == "simuleval":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_simuleval)
    with pytest.raises(RuntimeError,
                       match="infinisst_tpu_torch.eval.runner"):
        make_simuleval_agent(_TwoStepAgent, None)


def test_simuleval_agent_maps_read_and_write(monkeypatch):
    """With a stub ``simuleval`` in ``sys.modules`` the wrapper copies
    SimulEval's source into the agent and maps its Read and Write to
    SimulEval's actions."""
    import sys
    import types

    from infinisst_tpu_torch.agents.base import (
        AgentStates,
        make_simuleval_agent,
    )

    class SimulRead:
        pass

    class SimulWrite:
        def __init__(self, content, finished):
            self.content, self.finished = content, finished

    class SimulAgent:
        def __init__(self):
            self.states = AgentStates()

    agents = types.ModuleType("simuleval.agents")
    agents.SpeechToTextAgent = SimulAgent
    actions = types.ModuleType("simuleval.agents.actions")
    actions.ReadAction, actions.WriteAction = SimulRead, SimulWrite
    monkeypatch.setitem(sys.modules, "simuleval",
                        types.ModuleType("simuleval"))
    monkeypatch.setitem(sys.modules, "simuleval.agents", agents)
    monkeypatch.setitem(sys.modules, "simuleval.agents.actions", actions)
    wrapped = make_simuleval_agent(_TwoStepAgent, "args")()
    assert issubclass(type(wrapped), SimulAgent)
    wrapped.states.source = [0.0, 0.1]
    assert isinstance(wrapped.policy(), SimulRead)
    st = AgentStates()
    st.source, st.source_sample_rate = [0.0] * 5, 8000
    st.source_finished = True
    act = wrapped.policy(st)
    assert isinstance(act, SimulWrite)
    assert (act.content, act.finished) == ("hi", True)


@pytest.mark.parametrize("case", GOLD["average_lagging"],
                         ids=lambda c: c["name"])
def test_average_lagging_matches_jax(case):
    args = (case["delays"], case["source_ms"], case["n_ref_units"])
    kw = dict(length_adaptive=case["length_adaptive"])
    got = TL.average_lagging(*args, **kw)
    assert got == JL.average_lagging(*args, **kw)
    assert abs(got - case["expected"]) < 1e-9, case["derivation"]


@pytest.mark.parametrize("case", GOLD["stream_laal"], ids=lambda c: c["name"])
def test_stream_laal_matches_jax(case):
    out = []
    for mod in (TL, JL):
        log = mod.InstanceLog(
            source_duration_ms=float(case["source_duration_ms"]))
        log.emissions = [
            mod.Emission(e["text"], float(e["delay_ms"]),
                         float(e["ca_delay_ms"]))
            for e in case["emissions"]
        ]
        out.append(mod.stream_laal(
            log, case["refs"], unit=case["unit"],
            computation_aware=case["computation_aware"],
            seg_times=[tuple(t) for t in case["seg_times"]],
        ))
    assert out[0] == out[1]
    assert abs(out[0] - case["expected"]) < 1e-6, case["derivation"]


def test_native_mwer_matches_python_on_random_inputs():
    """Mirrors tests/test_latency_golden.py: the C++ DP (built into
    build/native/) reaches the Python DP's minimal summed edit distance."""
    from infinisst_tpu_torch.native import BUILD_DIR, load_mwer
    from infinisst_tpu_torch.native import mwer_segment_native

    if load_mwer() is None:
        pytest.skip("no C++ toolchain available")
    assert os.path.isfile(os.path.join(BUILD_DIR, "libmwer.so"))
    rng = np.random.RandomState(0)
    for _ in range(25):
        vocab = rng.randint(3, 9)
        refs = [[int(x) for x in rng.randint(0, vocab, rng.randint(1, 7))]
                for _ in range(rng.randint(1, 5))]
        hyp = []
        for r in refs:
            for t in r:
                p = rng.rand()
                if p < 0.15:
                    continue
                hyp.append(int(rng.randint(0, vocab)) if p < 0.3 else t)
                if rng.rand() < 0.1:
                    hyp.append(int(rng.randint(0, vocab)))
        py = TL._mwer_segment_bounds(
            [str(t) for t in hyp], [" ".join(map(str, r)) for r in refs],
            "word")
        nat = mwer_segment_native(hyp, refs, band=0)
        assert len(nat) == len(py) == len(refs) and nat[-1] == len(hyp)
        assert all(a <= b for a, b in zip(nat, nat[1:]))
        refs_s = [[str(t) for t in r] for r in refs]
        hyp_s = [str(t) for t in hyp]
        assert _split_cost(hyp_s, refs_s, nat) == \
            _split_cost(hyp_s, refs_s, py)


class FakeAgent:
    """Emits one word per push, made from the audio it was given: the
    same on any runner, independent of time."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0

    def push(self, seg, finished=False):
        self.n += 1
        if self.n % 2 and not finished:
            return ReadAction()
        word = f"w{int(abs(float(np.sum(seg))) * 1000) % 7}"
        return WriteAction(content=f"{word} x{self.n}", finished=finished)


def _write_inputs(d, write_wav):
    rng = np.random.RandomState(0)
    for i, n in enumerate((3 * 15360, 2 * 15360 + 4000)):
        write_wav(str(d / f"w{i}.wav"),
                  (rng.randn(n) * 0.1).astype(np.float32))
    (d / "eval.source").write_text(f"{d}/w0.wav\n{d}/w1.wav\n")
    (d / "eval.target").write_text("w1 x2\tw3 x4\nw5 x6 w0\n")
    (d / "eval.timing").write_text("0:1500\t1500:1380\n0:2170\n")


def test_runner_matches_jax(tmp_path):
    """The same fake agent through both runners: equal predictions,
    delays, BLEU and StreamLAAL; only the timing fields differ."""
    _write_inputs(tmp_path, TAudio.write_wav)
    scores, logs = [], []
    for name, mod in (("port", TR), ("jax", JR)):
        scores.append(mod.run_streaming_eval(FakeAgent(), mod.EvalArgs(
            source=str(tmp_path / "eval.source"),
            target=str(tmp_path / "eval.target"),
            timing=str(tmp_path / "eval.timing"),
            output=str(tmp_path / name))))
        logs.append([json.loads(line) for line in
                     (tmp_path / name / "instances.log").read_text()
                     .splitlines()])
    got, want = scores
    for key in ("stream_laal", "n_instances"):
        assert got[key] == want[key], key
    assert (np.isnan(got["bleu"]) and np.isnan(want["bleu"])) or \
        got["bleu"] == want["bleu"]
    assert len(logs[0]) == 2
    for g, w in zip(*logs):
        assert set(g) == set(w)
        for key in set(g) - {"elapsed", "rtf"}:
            assert g[key] == w[key], key
    assert logs[0][0]["delays"] and logs[0][1]["prediction"]


def test_tiny_port_agent_through_the_runner(tmp_path):
    """Mirrors tests/test_eval_runner.py: the tiny port agent on the CPU
    through the port's runner produces scores and instance logs."""
    import jax

    from infinisst_tpu_torch.convert.from_jax import from_jax
    from tests.test_agent import tiny_params
    from tests.test_torch_agent import make_port_agent

    rng = np.random.RandomState(0)
    for i in range(2):
        TAudio.write_wav(str(tmp_path / f"w{i}.wav"),
                         (rng.randn(2 * 15360) * 0.1).astype(np.float32))
    (tmp_path / "eval.source").write_text(
        f"{tmp_path}/w0.wav\n{tmp_path}/w1.wav\n")
    (tmp_path / "eval.target").write_text("ref one\tref two\nref three\n")
    agent = make_port_agent(from_jax(jax.device_get(tiny_params()),
                                     device="cpu"))
    scores = TR.run_streaming_eval(agent, TR.EvalArgs(
        source=str(tmp_path / "eval.source"),
        target=str(tmp_path / "eval.target"),
        output=str(tmp_path / "out")))
    assert scores["n_instances"] == 2
    assert np.isfinite(scores["rtf"]) and scores["rtf"] > 0
    assert np.isfinite(scores["stream_laal"])
    logs = (tmp_path / "out" / "instances.log").read_text().splitlines()
    rec = json.loads(logs[0])
    assert len(logs) == 2 and rec["delays"]
    assert rec["source_length"] == 2 * 960.0
    assert (tmp_path / "out" / "scores.json").is_file()


def test_wav_io_matches_jax(tmp_path):
    x = (np.random.RandomState(1).randn(4000) * 0.2).astype(np.float32)
    TAudio.write_wav(str(tmp_path / "a.wav"), x)
    JAudio.write_wav(str(tmp_path / "b.wav"), x)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b.wav").read_bytes()
    sliced = f"{tmp_path}/a.wav:100:2000"
    assert TAudio.parse_path(sliced) == JAudio.parse_path(sliced)
    got, sr = TAudio.get_waveform(sliced)
    want, _ = JAudio.get_waveform(sliced)
    assert sr == 16000 and got.shape == (2000,)
    np.testing.assert_array_equal(got, want)
