"""Host-side audio utilities (a copy of ``fish_diffusion_tpu/utils/audio.py``).

``slice_audio`` splits on silence with frame-RMS dB gating, as
``librosa.effects.split`` does, and chunks runs longer than a maximum
duration. WAV IO uses the standard library. Pure numpy.

Vocal separation (``separate_vocals`` in the JAX package) is not ported:
it needs demucs and its weights (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import math
import wave
from typing import Iterable, Tuple

import numpy as np


def _frame_db(audio: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Per-frame RMS in dB relative to the loudest frame."""
    if audio.ndim > 1:
        audio = np.max(np.abs(audio), axis=tuple(range(audio.ndim - 1)))
    else:
        audio = np.abs(audio)

    n_frames = max(1 + (len(audio) - frame_length) // hop_length, 1)
    frames = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        seg = audio[i * hop_length : i * hop_length + frame_length]
        frames[i] = np.sqrt(np.mean(seg**2) + 1e-12)

    ref = frames.max() + 1e-12
    return 20.0 * np.log10(frames / ref + 1e-12)


def split_silence(
    audio: np.ndarray,
    top_db: int = 60,
    frame_length: int = 2048,
    hop_length: int = 512,
):
    """Non-silent intervals [(start_sample, end_sample)]."""
    db = _frame_db(audio, frame_length, hop_length)
    non_silent = db > -top_db

    intervals = []
    in_run = False
    run_start = 0
    for i, ns in enumerate(non_silent):
        if ns and not in_run:
            in_run, run_start = True, i
        elif not ns and in_run:
            in_run = False
            intervals.append(
                (run_start * hop_length, min(i * hop_length + frame_length, len(audio)))
            )
    if in_run:
        intervals.append((run_start * hop_length, len(audio)))

    return intervals


def slice_audio(
    audio: np.ndarray,
    rate: int,
    max_duration: float = 30.0,
    top_db: int = 60,
    frame_length: int = 2048,
    hop_length: int = 512,
    min_silence_duration: float = 0,
) -> Iterable[Tuple[int, int]]:
    """Silence split, runs closer than ``min_silence_duration`` merged, runs
    of 0.1 s or less dropped, runs over ``max_duration`` cut into equal
    chunks. Yields (start, end) sample indices."""
    intervals = split_silence(
        audio.T if audio.ndim > 1 else audio,
        top_db=top_db,
        frame_length=frame_length,
        hop_length=hop_length,
    )

    if min_silence_duration > 0:
        merged = []
        for start, end in intervals:
            if merged and merged[-1][1] + min_silence_duration * rate >= start:
                merged[-1] = (merged[-1][0], end)
            else:
                merged.append((start, end))
        intervals = merged

    for start, end in intervals:
        if end - start <= rate * max_duration:
            if end - start <= rate * 0.1:  # too short, unlikely vocal
                continue
            yield start, end
            continue

        n_chunks = math.ceil((end - start) / (max_duration * rate))
        chunk_size = math.ceil((end - start) / n_chunks)
        for i in range(start, end, chunk_size):
            yield i, i + chunk_size


def save_wav(path, audio: np.ndarray, sample_rate: int = 44100):
    """Write mono/stereo float [-1, 1] audio as 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)

    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())


def load_wav(path) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV to float32 [-1, 1] mono."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)

    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {width}")

    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sr
