"""Audio IO without libsndfile: stdlib ``wave`` + numpy, with soundfile
used when it is installed (a copy of ``infinisst_tpu/data/audio.py``).

Supports the sliced-path convention ``path:offset:frames`` of the
reference's TSV manifests.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

try:  # optional
    import soundfile as _sf
except Exception:  # pragma: no cover
    _sf = None


def parse_path(path: str) -> Tuple[str, int, int]:
    """'file.wav:offset:frames' -> (file, offset, frames); -1 = full file."""
    parts = path.split(":")
    if len(parts) >= 3 and parts[-1].isdigit() and parts[-2].isdigit():
        return ":".join(parts[:-2]), int(parts[-2]), int(parts[-1])
    return path, 0, -1


def read_wav(
    path: str, offset: int = 0, frames: int = -1
) -> Tuple[np.ndarray, int]:
    """Read mono PCM wav -> (float32 waveform in [-1,1], sample_rate)."""
    if _sf is not None:  # pragma: no cover - env dependent
        data, sr = _sf.read(
            path, dtype="float32", start=offset,
            frames=frames if frames > 0 else -1,
        )
        if data.ndim > 1:
            data = data.mean(axis=1)
        return data.astype(np.float32), sr

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_chan = w.getnchannels()
        sampwidth = w.getsampwidth()
        total = w.getnframes()
        if offset:
            w.setpos(min(offset, total))
        n = frames if frames > 0 else total - offset
        raw = w.readframes(n)
    if sampwidth == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:  # pragma: no cover
        raise ValueError(f"unsupported sample width {sampwidth}")
    if n_chan > 1:
        data = data.reshape(-1, n_chan).mean(axis=1)
    return data, sr


def get_waveform(path: str) -> Tuple[np.ndarray, int]:
    p, off, fr = parse_path(path)
    return read_wav(p, off, fr)


def write_wav(path: str, data: np.ndarray, sr: int = 16000):
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
