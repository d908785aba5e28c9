"""SVC serving (``fish_diffusion_tpu/inference/svc.py:SVCInference``).

A request is one audio segment (``forward``) or several (``forward_batch``)
with a target speaker and a caller-supplied f0 curve. Each segment goes
through HubertSoft content features, condition assembly, UniPC reverse
diffusion over the WaveNet denoiser, and the NSF-HiFiGAN vocoder. Segments
are padded to a frame bucket and masked, as in the JAX server.

Not ported yet: the pitch extractor (a request must carry its f0;
ROADMAP Queue 1 item 9), the file-to-file ``inference`` and shallow
diffusion (``skip_steps``, which needs the mel transform; item 6).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..models import build_model
from ..ops.tensor import repeat_expand_np
from ..registry import FEATURE_EXTRACTORS, PITCH_EXTRACTORS, VOCODERS

# frame buckets: ~1.5 s .. 30 s at hop 512 / 44.1 kHz
_BUCKETS = (128, 256, 512, 1024, 1536, 2048, 2600)


def _bucket_for(n_frames: int) -> int:
    for b in _BUCKETS:
        if n_frames <= b:
            return b
    return ((n_frames + 255) // 256) * 256


class SVCInference:
    def __init__(self, config, checkpoint: Optional[str] = None, device="cpu"):
        if isinstance(config, (str, Path)):
            config = Config.fromfile(config)
        self.config = config
        self.device = torch.device(device)

        from .. import extractors  # noqa: F401  (registers the extractors)

        pre = config.preprocessing
        self.text_features_extractor = FEATURE_EXTRACTORS.build(
            dict(pre.text_features_extractor), device=self.device
        )
        pitch_cfg = dict(pre.pitch_extractor)
        self.pitch_extractor = (
            PITCH_EXTRACTORS.build(pitch_cfg)
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
        ...}`` or the bare tree), carried across by
        ``convert.diffsinger_from_jax``."""
        from ..convert import diffsinger_from_jax

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
                         pitches: Optional[np.ndarray], bucket: int):
        """Content features and f0 padded to ``bucket`` frames; None for an
        unvoiced segment."""
        if pitches is None:
            raise NotImplementedError(
                f"no f0 given and the pitch extractor "
                f"{self.pitch_extractor_type!r} is not ported yet (ROADMAP "
                "Queue 1 item 9): pass the f0 curve as pitches= or "
                "pitches_list="
            )
        mel_len = len(audio) // self.hop_length
        audio_padded = np.pad(
            np.asarray(audio, np.float32),
            (0, bucket * self.hop_length - len(audio)),
        )

        pitches = np.nan_to_num(np.asarray(pitches, np.float32))
        pitches = repeat_expand_np(pitches, mel_len)
        pitches = pitches * 2 ** (pitch_adjust / 12)
        if (pitches == 0).all():
            return None

        contents = self.text_features_extractor(audio_padded, self.sampling_rate)
        t_feat = contents.shape[-1]
        t_true = max(int(round(t_feat * len(audio) / len(audio_padded))), 1)
        contents = repeat_expand_np(np.asarray(contents)[0, :, :t_true], mel_len).T

        pad = bucket - mel_len
        return {
            "contents": np.pad(contents, ((0, pad), (0, 0))),
            "pitches": np.pad(pitches, (0, pad)),
            "pitches_true": pitches[:mel_len],
            "mel_len": mel_len,
        }

    def _check_request(self, skip_steps: int):
        if not self.has_params:
            raise RuntimeError("no model weights: load a checkpoint first")
        if self.vocoder is None:
            raise RuntimeError("no vocoder: call set_vocoder() first")
        if skip_steps:
            raise NotImplementedError(
                "shallow diffusion needs the mel transform, which is not "
                "ported yet (ROADMAP Queue 1 item 6)"
            )

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
        comes from ``parse_speaker``; ``pitches`` is the frame f0 curve."""
        self._check_request(skip_steps)
        mel_len = len(audio) // self.hop_length
        bucket = _bucket_for(mel_len)
        seg = self._prepare_segment(audio, pitch_adjust, pitches, bucket)
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
        self._check_request(skip_steps)
        n = len(segments)
        if n == 0:
            return []
        if pitches_list is None:
            pitches_list = [None] * n

        bucket = max(_bucket_for(len(a) // self.hop_length) for a in segments)
        preps, voiced_idx = [], []
        for i, (audio, pf) in enumerate(zip(segments, pitches_list)):
            seg = self._prepare_segment(audio, pitch_adjust, pf, bucket)
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
            noise_predictor=noise_predictor,
            generator=gen,
        )
        wav = self.vocoder.spec2wav(mel, pitches, generator=gen)
        wav = wav.float().cpu().numpy()
        for j, i in enumerate(voiced_idx):
            n_samples = min(len(segments[i]), preps[j]["mel_len"] * self.hop_length)
            outputs[i][:n_samples] = wav[j, :n_samples]
        return outputs
