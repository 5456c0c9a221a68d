"""``tools.smoke_profile``'s sampler: what one sample of a thread's stack
records, by phase (the chip check it profiles runs only on the card)."""

import os
import threading

from infinisst_tpu_torch.tools import smoke_profile as SP


def _here() -> str:
    return os.path.relpath(os.path.abspath(__file__), SP.ROOT)


def test_a_sample_counts_the_innermost_repository_line():
    s = SP.Sampler(threading.get_ident(), 0.5)
    s.phase = "kernels"
    for _ in range(2):  # both samples at this line
        s.sample()
    (phase, where), n = s.innermost.most_common(1)[0]
    assert (phase, n) == ("kernels", 2)
    path, function, line = where.rsplit(":", 2)
    assert (path, function) == (
        _here(), "test_a_sample_counts_the_innermost_repository_line")
    assert int(line) > 0
    # no chip_smoke.py frame on this stack: no function, no line of it
    assert not s.by_function and not s.by_line
    report = s.report()
    assert report["period_s"] == 0.5
    assert report["innermost"] == [["kernels", where, 1.0]]  # 2 x 0.5 s
    assert report["phases"] == [] and report["by_line"] == []


def test_samples_of_another_thread_follow_its_phase():
    s = SP.Sampler(threading.get_ident(), 0.25)
    for phase in ("tiny", "tiny", "flagship"):
        s.phase = phase
        t = threading.Thread(target=s.sample)
        t.start()
        t.join()
    counts = {p: n for (p, _), n in s.innermost.items()}
    assert counts == {"tiny": 2, "flagship": 1}
