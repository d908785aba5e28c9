"""SVC serving (``fish_diffusion_tpu/inference/svc.py:SVCInference``).

``inference`` converts a file into a file: load, resample, loudness
normalisation, silence slicing, one request per segment (or batched by
bucket), overlap-write. A request is one audio segment (``forward``) or
several (``forward_batch``) with a target speaker. Each segment goes
through the pitch extractor (Harvest, unless the caller gives the f0
curve), HubertSoft content features, condition assembly, reverse diffusion
over the WaveNet denoiser (UniPC, PLMS or naive; shallow from the input's
own mel when ``skip_steps`` > 0) and the NSF-HiFiGAN vocoder. Segments are
padded to a frame bucket and masked, as in the JAX server.

Everything runs on ``device``, the card unless the caller asks for the CPU.
Not ported: vocal separation (``extract_vocals``), energy extractors, and
the JAX server's multi-device mesh (ROADMAP Queue 1 items 9 and 11).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..models import build_model
from ..ops.tensor import repeat_expand_np
from ..registry import FEATURE_EXTRACTORS, PITCH_EXTRACTORS, VOCODERS
from ..utils import resolve_device
from ..utils.audio import load_wav, save_wav, slice_audio

# frame buckets: ~1.5 s .. 30 s at hop 512 / 44.1 kHz
_BUCKETS = (128, 256, 512, 1024, 1536, 2048, 2600)


def _bucket_for(n_frames: int) -> int:
    for b in _BUCKETS:
        if n_frames <= b:
            return b
    return ((n_frames + 255) // 256) * 256


class SVCInference:
    def __init__(self, config, checkpoint: Optional[str] = None, device="cuda"):
        if isinstance(config, (str, Path)):
            config = Config.fromfile(config)
        self.config = config
        self.device = resolve_device(device)

        from .. import extractors  # noqa: F401  (registers the extractors)

        pre = config.preprocessing
        self.text_features_extractor = FEATURE_EXTRACTORS.build(
            dict(pre.text_features_extractor), device=self.device
        )
        pitch_cfg = dict(pre.pitch_extractor)
        self.pitch_extractor = (
            PITCH_EXTRACTORS.build(pitch_cfg, device=self.device)
            if pitch_cfg["type"] in PITCH_EXTRACTORS
            else None
        )
        self.pitch_extractor_type = pitch_cfg["type"]
        if pre.get("energy_extractor"):
            raise NotImplementedError("energy extractors are not ported yet")

        self.model = build_model(config.model).to(self.device).eval()
        self.has_params = False
        if checkpoint is not None:
            self.load_checkpoint(checkpoint)

        try:
            self.vocoder = VOCODERS.build(
                dict(config.model.vocoder), device=self.device
            )
        except FileNotFoundError as e:
            print(f"[inference] vocoder checkpoint unavailable ({e}); "
                  "call set_vocoder() before synthesis")
            self.vocoder = None

        self.sampling_rate = config.model.vocoder.get("sampling_rate", 44100)
        self.hop_length = config.model.vocoder.get("hop_length", 512)
        self.mel_channels = config.model.vocoder.get("mel_channels", 128)

    # -- weights -------------------------------------------------------------

    def load_checkpoint(self, path):
        """A pickle of the JAX package's DiffSinger params (``{"params":
        ...}``, ``{"ema_params": ...}`` or the bare tree), carried across by
        ``convert.diffsinger_from_jax``. The JAX package's Orbax checkpoint
        directories need JAX to read and are not taken here: export the
        params to a pickle first."""
        from ..convert import diffsinger_from_jax

        if Path(path).is_dir():
            raise NotImplementedError(
                f"{path} is a directory: Orbax checkpoints need JAX; pass a "
                "pickle of the params"
            )
        with open(path, "rb") as f:
            state = pickle.load(f)
        if isinstance(state, dict) and "ema_params" in state:
            state = state["ema_params"]
        self.load_state_dict(diffsinger_from_jax(state))

    def load_state_dict(self, state_dict: dict):
        self.model.load_state_dict(state_dict)
        self.has_params = True

    def init_random(self, seed: int = 0):
        from ..utils import init_random_

        init_random_(self.model, seed)
        self.has_params = True

    def set_vocoder(self, vocoder):
        self.vocoder = vocoder

    # -- speakers ------------------------------------------------------------

    def parse_speaker(self, speaker) -> torch.Tensor:
        """An id, a name from ``speaker_mapping``, or a mix ``"a:0.6,b:0.4"``
        (a weighted mean of embedding rows, [1, 1, H] float)."""
        mapping = self.config.get("speaker_mapping", {}) or {}

        def ids(i):
            return torch.tensor([int(i)], dtype=torch.long, device=self.device)

        if isinstance(speaker, (int, np.integer)):
            return ids(speaker)
        speaker = str(speaker)
        if speaker.isdigit():
            return ids(speaker)
        if ":" not in speaker:
            if speaker not in mapping:
                raise ValueError(f"unknown speaker {speaker!r}")
            return ids(mapping[speaker])

        if not self.has_params:
            raise RuntimeError("a speaker mix needs loaded params")
        table = self.model.speaker_encoder.embedding.weight.detach().float().cpu().numpy()
        mixed = np.zeros(table.shape[1], np.float32)
        total = 0.0
        for part in speaker.split(","):
            name, weight = part.split(":")
            weight = float(weight)
            idx = int(mapping[name]) if name in mapping else int(name)
            mixed += weight * table[idx]
            total += weight
        mixed /= max(total, 1e-8)
        return torch.from_numpy(mixed)[None, None, :].to(self.device)

    # -- per-segment preparation ---------------------------------------------

    def _prepare_segment(self, audio: np.ndarray, pitch_adjust: float,
                         pitches: Optional[np.ndarray], bucket: int,
                         shallow: bool = False):
        """Content features and f0 padded to ``bucket`` frames, and for a
        shallow request the segment's own mel (``original_mel`` [bucket, M]
        on the device); None for an unvoiced segment. Without ``pitches``
        the pitch extractor runs on the bucket-padded audio, cropped to the
        segment's frames."""
        mel_len = len(audio) // self.hop_length
        audio_padded = np.pad(
            np.asarray(audio, np.float32),
            (0, bucket * self.hop_length - len(audio)),
        )

        if pitches is not None:
            pitches = np.nan_to_num(np.asarray(pitches, np.float32))
            pitches = repeat_expand_np(pitches, mel_len)
        elif self.pitch_extractor is None:
            raise NotImplementedError(
                f"no f0 given and the pitch extractor "
                f"{self.pitch_extractor_type!r} is not ported yet (ROADMAP "
                "Queue 1 item 15): pass the f0 curve as pitches= or "
                "pitches_list="
            )
        else:
            f0_raw = self.pitch_extractor(audio_padded, self.sampling_rate, pad_to=None)
            n_true = int(np.ceil(len(audio) / self.pitch_extractor.hop_length))
            pitches = self.pitch_extractor.post_process(
                audio, self.sampling_rate, f0_raw[:n_true], mel_len
            )
        pitches = pitches * 2 ** (pitch_adjust / 12)
        if (pitches == 0).all():
            return None

        contents = self.text_features_extractor(audio_padded, self.sampling_rate)
        t_feat = contents.shape[-1]
        t_true = max(int(round(t_feat * len(audio) / len(audio_padded))), 1)
        contents = repeat_expand_np(np.asarray(contents)[0, :, :t_true], mel_len).T

        pad = bucket - mel_len
        original_mel = None
        if shallow:
            mel = self.vocoder.wav2spec(self._tensor(audio)[None])[0]
            if mel.shape[0] != mel_len:
                raise AssertionError(f"wav2spec gave {mel.shape[0]} frames for "
                                     f"{len(audio)} samples, expected {mel_len}")
            original_mel = torch.nn.functional.pad(mel, (0, 0, 0, pad))
        return {
            "contents": np.pad(contents, ((0, pad), (0, 0))),
            "pitches": np.pad(pitches, (0, pad)),
            "pitches_true": pitches[:mel_len],
            "mel_len": mel_len,
            "original_mel": original_mel,
        }

    def _check_request(self):
        if not self.has_params:
            raise RuntimeError("no model weights: load a checkpoint first")
        if self.vocoder is None:
            raise RuntimeError("no vocoder: call set_vocoder() first")

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _pitch_shift(self, n: int):
        if self.config.model.get("pitch_shift_encoder"):
            return torch.zeros((n, 1), device=self.device)
        return None

    # -- requests ------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, audio: np.ndarray, speakers, pitch_adjust: float = 0.0,
                sampler_interval: Optional[int] = None, skip_steps: int = 0,
                noise_predictor: Optional[str] = None, seed: int = 0,
                pitches: Optional[np.ndarray] = None) -> np.ndarray:
        """One segment -> converted audio of the same length. ``speakers``
        comes from ``parse_speaker``; ``pitches`` is the frame f0 curve
        (Harvest's when None)."""
        self._check_request()
        mel_len = len(audio) // self.hop_length
        bucket = _bucket_for(mel_len)
        shallow = skip_steps > 0
        seg = self._prepare_segment(audio, pitch_adjust, pitches, bucket, shallow)
        if seg is None:
            return np.zeros_like(audio)

        gen = torch.Generator(device=self.device).manual_seed(seed)
        mel = self.model.sample(
            speakers,
            self._tensor(seg["contents"])[None],
            contents_lens=self._tensor([mel_len], torch.long),
            mel_lens=self._tensor([mel_len], torch.long),
            pitches=self._tensor(seg["pitches"])[None],
            pitch_shift=self._pitch_shift(1),
            sampler_interval=sampler_interval,
            skip_steps=skip_steps,
            original_mel=seg["original_mel"][None] if shallow else None,
            noise_predictor=noise_predictor,
            generator=gen,
        )
        wav = self.vocoder.spec2wav(
            mel[:, :mel_len].contiguous(),
            self._tensor(seg["pitches_true"])[None],
            generator=gen,
        )
        return wav[0].float().cpu().numpy()[: len(audio)]

    @torch.inference_mode()
    def forward_batch(self, segments, speakers, pitch_adjust: float = 0.0,
                      sampler_interval: Optional[int] = None,
                      skip_steps: int = 0,
                      noise_predictor: Optional[str] = None, seed: int = 0,
                      pitches_list=None):
        """N segments in one batched sample call at the largest segment's
        bucket; the vocoder runs at the bucket and each output is cropped.
        Unvoiced segments come back as silence."""
        self._check_request()
        n = len(segments)
        if n == 0:
            return []
        if pitches_list is None:
            pitches_list = [None] * n

        shallow = skip_steps > 0
        bucket = max(_bucket_for(len(a) // self.hop_length) for a in segments)
        preps, voiced_idx = [], []
        for i, (audio, pf) in enumerate(zip(segments, pitches_list)):
            seg = self._prepare_segment(audio, pitch_adjust, pf, bucket, shallow)
            if seg is not None:
                preps.append(seg)
                voiced_idx.append(i)

        outputs = [np.zeros_like(np.asarray(a, np.float32)) for a in segments]
        if not preps:
            return outputs

        nb = len(preps)
        contents = self._tensor(np.stack([p["contents"] for p in preps]))
        pitches = self._tensor(np.stack([p["pitches"] for p in preps]))
        lens = self._tensor([p["mel_len"] for p in preps], torch.long)
        speakers_b = speakers.repeat((nb,) + (1,) * (speakers.ndim - 1))

        gen = torch.Generator(device=self.device).manual_seed(seed)
        mel = self.model.sample(
            speakers_b,
            contents,
            contents_lens=lens,
            mel_lens=lens,
            pitches=pitches,
            pitch_shift=self._pitch_shift(nb),
            sampler_interval=sampler_interval,
            skip_steps=skip_steps,
            original_mel=(torch.stack([p["original_mel"] for p in preps])
                          if shallow else None),
            noise_predictor=noise_predictor,
            generator=gen,
        )
        wav = self.vocoder.spec2wav(mel, pitches, generator=gen)
        wav = wav.float().cpu().numpy()
        for j, i in enumerate(voiced_idx):
            n_samples = min(len(segments[i]), preps[j]["mel_len"] * self.hop_length)
            outputs[i][:n_samples] = wav[j, :n_samples]
        return outputs

    # -- end to end ----------------------------------------------------------

    def inference(
        self,
        input_path,
        output_path,
        speaker=0,
        pitch_adjust: float = 0.0,
        sampler_interval: Optional[int] = None,
        skip_steps: int = 0,
        noise_predictor: Optional[str] = None,
        silence_threshold: int = 60,
        max_slice_duration: float = 30.0,
        min_silence_duration: float = 0,
        pitches_path: Optional[str] = None,
        extract_vocals: bool = False,
        seed: int = 0,
        batch_segments: int = 0,
    ) -> np.ndarray:
        """File to file: load (resampled to the model's rate), normalise the
        loudness to -23 dB RMS (clipped to +-1), slice on silence, convert
        each segment with seed ``seed + i`` (or, with ``batch_segments`` > 1,
        groups of up to that many segments of one bucket with seed
        ``seed + first index``), overlap-write and save. ``pitches_path``
        (.json list or .npy array of frame f0s over the whole input)
        replaces the pitch extractor. Returns the converted audio."""
        self._check_request()
        if extract_vocals:
            raise NotImplementedError(
                "vocal separation needs demucs and is not ported (ROADMAP "
                "Queue 1 item 9): run without extract_vocals"
            )

        audio, sr = load_wav(input_path)
        if sr != self.sampling_rate:
            from ..extractors.feature import resample_linear

            audio = resample_linear(audio, sr, self.sampling_rate)

        rms = np.sqrt(np.mean(audio**2) + 1e-12)
        audio = np.clip(audio * (10 ** (-23 / 20) / (rms + 1e-12)), -1, 1)

        full_pitches = None
        if pitches_path is not None:
            if Path(pitches_path).suffix == ".json":
                with open(pitches_path) as f:
                    full_pitches = np.asarray(json.load(f), np.float32)
            else:
                full_pitches = np.load(pitches_path).astype(np.float32)

        speakers = self.parse_speaker(speaker)
        generated = np.zeros_like(audio)
        segments = list(slice_audio(
            audio, self.sampling_rate, max_duration=max_slice_duration,
            top_db=silence_threshold, min_silence_duration=min_silence_duration,
        ))
        print(f"[inference] {len(segments)} segments")

        def seg_pitches(start, end):
            if full_pitches is None:
                return None
            return full_pitches[start // self.hop_length : end // self.hop_length]

        request = dict(pitch_adjust=pitch_adjust, sampler_interval=sampler_interval,
                       skip_steps=skip_steps, noise_predictor=noise_predictor)
        if batch_segments > 1 and len(segments) > 1:
            groups = {}
            for i, (start, end) in enumerate(segments):
                groups.setdefault(_bucket_for((end - start) // self.hop_length),
                                  []).append(i)
            for b in sorted(groups):
                idxs = groups[b]
                for c0 in range(0, len(idxs), batch_segments):
                    chunk = idxs[c0 : c0 + batch_segments]
                    outs = self.forward_batch(
                        [audio[s:e] for s, e in (segments[i] for i in chunk)],
                        speakers, seed=seed + chunk[0],
                        pitches_list=[seg_pitches(*segments[i]) for i in chunk],
                        **request,
                    )
                    for i, out in zip(chunk, outs):
                        start, end = segments[i]
                        generated[start : start + len(out)] = out[: end - start]
        else:
            for i, (start, end) in enumerate(segments):
                out = self.forward(audio[start:end], speakers, seed=seed + i,
                                   pitches=seg_pitches(start, end), **request)
                generated[start : start + len(out)] = out[: end - start]

        save_wav(output_path, generated, self.sampling_rate)
        return generated

    def batch_inference(self, input_dir, output_dir, **kwargs):
        """Every ``*.wav`` under ``input_dir`` to the same relative path
        under ``output_dir``."""
        input_dir, output_dir = Path(input_dir), Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for wav in sorted(input_dir.rglob("*.wav")):
            out = output_dir / wav.relative_to(input_dir)
            out.parent.mkdir(parents=True, exist_ok=True)
            print(f"[inference] {wav} -> {out}")
            self.inference(wav, out, **kwargs)
