"""The port's data side against the JAX package (both numpy): the
TSV dataset, ``SpeechSampler``, ``build_trajectory_prompt``, the five
collators, ``perturb_trajectory``, the collators' dataset sweep,
``pad_to_buckets`` and the extractor / adapter length formulas, on the
cases of ``tests/test_data.py``.  Every array is bitwise equal."""

import csv

import numpy as np
import pytest

from infinisst_tpu.core.config import SpecialTokens as JTokens
from infinisst_tpu.core.config import tiny_model_config as jtiny
from infinisst_tpu.data import collators as JCOL
from infinisst_tpu.data import dataset as JDS
from infinisst_tpu.data import sampler as JSAM
from infinisst_tpu.data import template as JTPL
from infinisst_tpu.data.audio import write_wav
from infinisst_tpu.models import adapter as JA
from infinisst_tpu.models import wav2vec2 as JW
from infinisst_tpu.train.trainer import pad_to_buckets as jpad
from infinisst_tpu_torch.core.config import SpecialTokens
from infinisst_tpu_torch.core.config import tiny_model_config
from infinisst_tpu_torch.data import collators as TCOL
from infinisst_tpu_torch.data import dataset as TDS
from infinisst_tpu_torch.data import sampler as TSAM
from infinisst_tpu_torch.data import template as TTPL
from infinisst_tpu_torch.models import adapter as TA
from infinisst_tpu_torch.models import wav2vec2 as TW
from infinisst_tpu_torch.train.trainer import pad_to_buckets

TOKEN_IDS = dict(
    bos=500, eot=501, eos=501, start_header=502, end_header=503, pad=504,
    user=505, assistant=506, newline2=507, sp_patch=508, sp_start=509,
    sp_end=510, latency=(511, 511, 511, 511), end_of_text=499,
)
JMCFG = jtiny().replace(tokens=JTokens(**TOKEN_IDS))
MCFG = tiny_model_config().replace(tokens=SpecialTokens(**TOKEN_IDS))
JBUILDER = JTPL.PromptBuilder(JTPL.StubTokenizer(512, lo=10, hi=400),
                              JMCFG.tokens)
BUILDER = TTPL.PromptBuilder(TTPL.StubTokenizer(512, lo=10, hi=400),
                             MCFG.tokens)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


class FakeDS:
    def __init__(self, n):
        self.n_frames = [16000 * (i % 5 + 1) + 37 * i for i in range(n)]
        self.tgt_texts = ["word " * (i % 7 + 1) for i in range(n)]

    def __len__(self):
        return len(self.n_frames)


@pytest.mark.parametrize("kw", [
    dict(shuffle=False, batch_size=400, batch_size_sent=4, min_ms=0),
    dict(shuffle=True, batch_size=400, batch_size_sent=4, seed=3),
    dict(shuffle=True, batch_size=700, batch_size_sent=30, min_ms=2500,
         multiplier=2, rank=1, num_replicas=2),
    dict(shuffle=False, batch_size=400, batch_size_sent=4, filter=False,
         tokenizer=None),
])
def test_sampler_matches_jax(kw):
    kw = {"tokenizer": lambda t: t.split(), **kw}
    ds = FakeDS(50)
    j, t = JSAM.SpeechSampler(ds, **kw), TSAM.SpeechSampler(ds, **kw)
    assert t.batch_indices == j.batch_indices and t.n_skipped == j.n_skipped
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j) and len(t) == len(j)


def _items(mod, n=2, n_units=2):
    items = []
    for i in range(n):
        src = np.random.RandomState(i).randn(
            n_units * 15360 - (320 if i else 0)
        ).astype(np.float32)
        items.append(mod.SpeechToTextItem(
            id=f"utt{i}", index=i, source=src,
            target="hello world out there", src_text="hallo welt da draussen",
            trajectory=["hello world", "out there"][:n_units]
            + ["more"] * (n_units - 2),
        ))
    return items


def test_trajectory_prompt_matches_jax():
    traj = [["hello world", True], ["out there", False], "again"]
    for m, lat in ((1, True), (2, False)):
        got = TTPL.build_trajectory_prompt(BUILDER, traj, 30 * m, m, lat)
        want = JTPL.build_trajectory_prompt(JBUILDER, traj, 30 * m, m, lat)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert TTPL.IGNORE_INDEX == JTPL.IGNORE_INDEX


@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4])
def test_collators_match_jax(variant):
    """Three calls each (the RNG of collators 3 and 4 advances per call);
    collator 4 also with every batch perturbed (prob_aug 1)."""
    kws = [{}]
    if variant == 3:
        kws = [dict(perturb=(0.3, 0.3, 0.4), seed=5)]
    if variant == 4:
        kws = [dict(max_multiplier=4, seed=1),
               dict(max_multiplier=2, prob_aug=1.0, seed=2)]
    for kw in kws:
        tc = TCOL.COLLATORS[variant](BUILDER, MCFG, block_size=48, **kw)
        jc = JCOL.COLLATORS[variant](JBUILDER, JMCFG, block_size=48, **kw)
        for call in range(3):
            n_units = 2 + call % 2
            got = tc(_items(TDS, 3, n_units))
            want = jc(_items(JDS, 3, n_units))
            _assert_same(got, want)


def test_multilatency_patch_counts():
    coll = TCOL.TrajectoryMultiLatencyCollator(
        BUILDER, MCFG, block_size=48, max_multiplier=2, seed=1
    )
    batch = coll(_items(TDS, n=1, n_units=2))
    fl = int(batch["frame_lengths"][0])
    assert int(batch["patch_mask"][0].sum()) == fl // 4


def test_perturb_matches_jax():
    traj = [["a b", True], ["c", True], ["d e f", True], ["", True],
            ["g h", True]]
    for seed in range(6):
        got = TCOL.perturb_trajectory([list(x) for x in traj],
                                      np.random.RandomState(seed),
                                      cut=lambda s: s.split())
        want = JCOL.perturb_trajectory([list(x) for x in traj],
                                       np.random.RandomState(seed),
                                       cut=lambda s: s.split())
        assert got == want
        orig = "".join(seg for seg, _ in traj)
        new = "".join(seg for seg, _ in got)
        assert sorted(orig.replace(" ", "")) == sorted(new.replace(" ", ""))


def test_collator_validate_matches_jax():
    class DS:
        ids = ["a", "b"]
        n_frames = [15360, 2 * 15360]
        trajectories = [["one"], ["one", "two"]]

        def __len__(self):
            return 2

    class BadDS(DS):
        trajectories = [["one", "extra"], ["one", "two"]]

    tc = TCOL.TrajectoryCollator(BUILDER, MCFG, block_size=48)
    jc = JCOL.TrajectoryCollator(JBUILDER, JMCFG, block_size=48)
    assert tc.validate(DS()) == jc.validate(DS()) == 2
    with pytest.raises(AssertionError):
        tc.validate(BadDS())


@pytest.mark.parametrize("m,B", [(1, 3), (2, 1), (1, 4), (4, 5)])
def test_pad_to_buckets_matches_jax(m, B):
    coll = JCOL.TrajectoryMultiLatencyCollator(
        JBUILDER, JMCFG, block_size=48, max_multiplier=1, seed=0)
    raw = coll(_items(JDS, B, 2))
    got = pad_to_buckets(raw, m, MCFG.tokens.pad)
    want = jpad(raw, m, JMCFG.tokens.pad)
    _assert_same(got, want)
    assert got["input_ids"].shape[0] == max(1, 1 << (B - 1).bit_length())


def test_lengths_match_jax():
    for n in (400, 15360 + 399, 460_799, 12345):
        assert TW.conv_out_length(MCFG.w2v2, n) == \
            JW.conv_out_length(JMCFG.w2v2, n)
        f = TW.conv_out_length(MCFG.w2v2, n)
        assert TA.out_length(MCFG.adapter, f) == \
            JA.out_length(JMCFG.adapter, f)
    assert TCOL.speech_token_len(MCFG, 15360 + 399) == 12


def test_dataset_from_tsv_matches_jax(tmp_path):
    rows = []
    for i in range(3):
        wav = (np.random.RandomState(i).randn(8000 + 100 * i) * 0.1
               ).astype(np.float32)
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, wav)
        rows.append({
            "id": f"u{i}", "audio": path if i != 1 else f"{path}:100:4000",
            "n_frames": str(len(wav)), "tgt_text": f"t {i}",
            "src_text": f"s {i}", "trajectory": repr([f"t {i}"]),
            "speech_word": repr([(0.0, 0.2)]) if i == 2 else "",
            "text_word": repr([(0, 1)]) if i == 2 else "",
        })
    with open(tmp_path / "tr.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t",
                           quotechar=None, doublequote=False,
                           lineterminator="\n", quoting=csv.QUOTE_NONE)
        w.writeheader()
        w.writerows(rows)
    t = TDS.SpeechToTextDataset.from_tsv(str(tmp_path), "tr")
    j = JDS.SpeechToTextDataset.from_tsv(str(tmp_path), "tr")
    assert len(t) == len(j) == 3 and t.n_frames == j.n_frames
    for i in range(3):
        a, b = t[i], j[i]
        np.testing.assert_array_equal(a.source, b.source)
        for k in ("id", "index", "target", "src_text", "trajectory",
                  "speech_word", "text_word"):
            assert getattr(a, k) == getattr(b, k), k
    with pytest.raises(FileNotFoundError):
        TDS.SpeechToTextDataset.from_tsv(str(tmp_path), "none")
