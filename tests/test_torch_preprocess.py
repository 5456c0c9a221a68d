"""The port's preprocessing tools against the JAX package's, on the cases
of ``tests/test_preprocess.py``: each test runs the JAX function and the
port's on the same input and requires equal outputs (TextGrid parses,
trajectories, re-sliced talk rows, stripped speakers, the ASR filter on a
stub transcription, the MFA corpus and the SimulEval inputs).  Both
packages' modules are plain Python, so equal means equal."""

import ast
import os

import numpy as np

from infinisst_tpu.tools.preprocess import asr_filter as JASR
from infinisst_tpu.tools.preprocess import build_trajectory as JBT
from infinisst_tpu.tools.preprocess import prep_mfa as JMFA
from infinisst_tpu.tools.preprocess import prepare_simuleval_inputs as JSE
from infinisst_tpu.tools.preprocess import remove_speakers as JRS
from infinisst_tpu.tools.preprocess import utils as JU
from infinisst_tpu_torch.data.audio import write_wav
from infinisst_tpu_torch.tools.preprocess import asr_filter as TASR
from infinisst_tpu_torch.tools.preprocess import build_trajectory as TBT
from infinisst_tpu_torch.tools.preprocess import prep_mfa as TMFA
from infinisst_tpu_torch.tools.preprocess import prepare_simuleval_inputs as TSE
from infinisst_tpu_torch.tools.preprocess import remove_speakers as TRS
from infinisst_tpu_torch.tools.preprocess import utils as TU

from test_preprocess import TEXTGRID


def _words(tmp_path):
    p = tmp_path / "u0.TextGrid"
    p.write_text(TEXTGRID)
    return str(p)


def test_parse_textgrid(tmp_path):
    p = _words(tmp_path)
    got = TBT.parse_textgrid_words(p)
    assert got == JBT.parse_textgrid_words(p)
    assert [w for _, _, w in got] == ["hello", "streaming", "world"]


def test_trajectory_for_utterance(tmp_path):
    words = TBT.parse_textgrid_words(_words(tmp_path))
    tgt = "hallo streaming welt".split()
    got = TBT.trajectory_for_utterance(words, tgt, duration_s=2.5)
    assert got == JBT.trajectory_for_utterance(words, tgt, duration_s=2.5)
    assert len(got) == 3


def test_utterance_trajectory_talk_grid(tmp_path):
    assert TBT.STEP_SAMPLES == JBT.STEP_SAMPLES
    words = TBT.parse_textgrid_words(_words(tmp_path))
    src = [w for _, _, w in words]
    tgt = "hallo streaming welt".split()
    offset = 2 * TBT.STEP_SAMPLES + 5000
    got = TBT.utterance_trajectory(words, src, tgt, offset, 40000)
    assert got == JBT.utterance_trajectory(words, src, tgt, offset, 40000)
    assert got[0] == 2 * TBT.STEP_SAMPLES and len(got[1]) == 3


def test_monotone_align():
    for n_src, n_tgt in ((4, 2), (2, 5), (7, 7), (1, 3)):
        assert TBT.monotone_align(n_src, n_tgt) == \
            JBT.monotone_align(n_src, n_tgt)


def _utt(step0, n_steps, tag, skipped=False):
    S = TBT.STEP_SAMPLES
    return {
        "path": "talk.wav",
        "offset": step0 * S,
        "n_frames": n_steps * S,
        "traj_offset": step0 * S,
        "trajectory": None if skipped else
        [f"{tag}{j} " for j in range(n_steps)],
        "src_segments": None if skipped else
        [f"s{tag}{j}" for j in range(n_steps)],
    }


def test_reslice_talk_gaps_and_windows():
    utts = [_utt(0, 3, "a"), _utt(5, 2, "b")]
    got = TBT.reslice_talk(utts, window_steps=30)
    assert got == JBT.reslice_talk(utts, window_steps=30)
    assert len(got) == 2


def test_reslice_talk_window_split_and_skip():
    utts = [_utt(0, 3, "a"), _utt(3, 3, "b"), _utt(6, 3, "c")]
    got = TBT.reslice_talk(utts, window_steps=4)
    assert got == JBT.reslice_talk(utts, window_steps=4)
    utts2 = [_utt(0, 2, "a"), _utt(2, 2, "x", skipped=True),
             _utt(4, 2, "b")]
    got2 = TBT.reslice_talk(utts2, window_steps=30)
    assert got2 == JBT.reslice_talk(utts2, window_steps=30)
    assert "x" not in " ".join(d["tgt_text"] for d in got2)


def test_reslice_rows_pass_collator_validate():
    """The port's rows equal JAX's and pass the port's
    ``TrajectoryCollator.validate``."""
    from infinisst_tpu_torch.data.collators import TrajectoryCollator
    from test_torch_data import BUILDER, MCFG

    utts = [_utt(0, 3, "a"), _utt(4, 2, "b"),
            _utt(7, 1, "x", skipped=True), _utt(9, 2, "c")]
    docs = TBT.reslice_talk(utts, window_steps=5)
    assert docs == JBT.reslice_talk(utts, window_steps=5)

    class DS:
        def __init__(self, rows):
            self.ids = [f"d{i}" for i in range(len(rows))]
            self.n_frames = [int(r["n_frames"]) for r in rows]
            self.trajectories = [ast.literal_eval(r["trajectory"])
                                 for r in rows]

        def __len__(self):
            return len(self.ids)

    coll = TrajectoryCollator(BUILDER, MCFG, block_size=48)
    assert coll.validate(DS(docs)) == len(docs) > 0


def test_strip_speakers():
    rows = [
        {"id": "a", "src_text": "Narrator: hello there",
         "tgt_text": "Erzähler: hallo there"},
        {"id": "b", "src_text": "no tag here", "tgt_text": "kein tag here"},
    ]
    got = TRS.strip_speakers([dict(r) for r in rows])
    assert got == JRS.strip_speakers([dict(r) for r in rows])
    assert got[1] >= 1


def test_strip_speakers_reference_rules():
    rows = [
        {"id": "init", "src_text": "CA: Thank you so much",
         "tgt_text": "CA: Vielen Dank"},
        {"id": "zh", "src_text": "David Perry: Wow great",
         "tgt_text": "佩里：哇 棒"},
        {"id": "long", "src_text": "A B C D E Narrator: dropped sample",
         "tgt_text": "x y: z"},
        {"id": "numword", "src_text": "Ten: little helpers",
         "tgt_text": "Zehn: kleine Helfer"},
        {"id": "clean", "src_text": "plain text", "tgt_text": "plain text"},
    ]
    got = TRS.strip_speakers([dict(r) for r in rows], lang="zh")
    assert got == JRS.strip_speakers([dict(r) for r in rows], lang="zh")
    assert got[2] == 2


def test_asr_filter():
    """The filter over a stub transcription (no Whisper is loaded)."""
    rows = [
        {"id": "good", "src_text": "hello streaming world"},
        {"id": "bad", "src_text": "hello streaming world"},
        {"id": "laughter", "src_text": "(Laughter)"},
    ]
    asr = {"good": "hello streaming world",
           "bad": "completely different words entirely"}
    got = TASR.filter_by_asr(rows, asr, threshold=0.4)
    assert got == JASR.filter_by_asr(rows, asr, threshold=0.4)
    assert got[1] == 1
    for s in ("Hello, (Laughter) WORLD!", "  A  b,c ", "(Applause)"):
        assert TASR.normalize(s) == JASR.normalize(s)
    for hyp, ref in (("a b c", "a c"), ("", "x"), ("", ""), ("x y", "")):
        assert TU.word_error_rate(hyp, ref) == JU.word_error_rate(hyp, ref)


def _read_tree(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def test_prep_mfa_and_simuleval_inputs(tmp_path):
    wav = (np.random.RandomState(0).randn(16000) * 0.1).astype(np.float32)
    talk = str(tmp_path / "talk.wav")
    write_wav(talk, wav)
    rows = [
        {"id": "t_1", "audio": f"{talk}:0:8000", "n_frames": "8000",
         "src_text": "first part", "tgt_text": "erster teil"},
        {"id": "t_0", "audio": f"{talk}:8000:8000", "n_frames": "8000",
         "src_text": "second part", "tgt_text": "zweiter teil"},
    ]
    tsv_t, tsv_j = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    TU.write_tsv(tsv_t, rows)
    JU.write_tsv(tsv_j, rows)
    assert open(tsv_t, "rb").read() == open(tsv_j, "rb").read()
    assert TU.read_tsv(tsv_t) == JU.read_tsv(tsv_t) == rows

    TMFA.main(["--tsv", tsv_t, "--output-dir", str(tmp_path / "mfa_t")])
    JMFA.main(["--tsv", tsv_t, "--output-dir", str(tmp_path / "mfa_j")])
    got = _read_tree(tmp_path / "mfa_t")
    assert got == _read_tree(tmp_path / "mfa_j")
    assert got["t_1.txt"].decode().strip() == "first part"

    for mod, tag in ((TSE, "t"), (JSE, "j")):
        mod.main(["--tsv", tsv_t, "--output-prefix", str(tmp_path / tag)])
    for ext in ("source", "target", "timing"):
        a = open(str(tmp_path / f"t.{ext}"), "rb").read()
        assert a == open(str(tmp_path / f"j.{ext}"), "rb").read(), ext
    assert open(str(tmp_path / "t.target")).read().splitlines() == \
        ["erster teil\tzweiter teil"]
