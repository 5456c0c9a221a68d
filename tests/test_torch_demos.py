"""The port's demos (``infinisst_tpu_torch/examples``) on the CPU for two
chunks and two ticks: the stream demo's last action finishes the stream
(also with speculative greedy), the serving demo's pool answers every
open stream each tick, and without a card ``--device cuda`` (the
default) raises."""

import pytest
import torch

from infinisst_tpu_torch.examples import serve_demo, stream_demo

torch.set_num_threads(2)


def test_stream_demo(capsys):
    assert stream_demo.main(["--chunks", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[chunk 1] WRITE" in out and "done:" in out
    assert stream_demo.main(["--chunks", "2", "--device", "cpu",
                             "--speculative", "--spec-k", "3"]) == 0


def test_serve_demo(capsys):
    outs = serve_demo.main(["--ticks", "2", "--device", "cpu"])
    assert len(outs) == 2
    assert sorted(outs[0]) == [0, 1]  # alice and bob
    assert sorted(outs[1]) == [0, 1, 2]  # carol joined at tick 1
    assert "carol joins" in capsys.readouterr().out


def test_demos_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_demo.main(["--chunks", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_demo.main(["--ticks", "1"])
