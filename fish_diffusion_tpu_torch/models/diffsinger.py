"""DiffSinger / DiffSVC: condition assembly + diffusion
(``fish_diffusion_tpu/models/diffsinger.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masking import get_mask_from_lengths
from ..registry import ARCHS, DIFFUSIONS, ENCODERS


@ARCHS.register_module(name="DiffSVC")
@ARCHS.register_module()
class DiffSinger(nn.Module):
    """Text/content encoder + optional speaker, pitch, pitch-shift and energy
    encoders summed into one condition, then reverse diffusion to mel.
    Submodule names are fish-diffusion's state-dict prefixes."""

    def __init__(
        self,
        text_encoder: dict,
        diffusion: dict,
        speaker_encoder: Optional[dict] = None,
        pitch_encoder: Optional[dict] = None,
        pitch_shift_encoder: Optional[dict] = None,
        energy_encoder: Optional[dict] = None,
    ):
        super().__init__()
        self.text_encoder = ENCODERS.build(dict(text_encoder))
        self.diffusion = DIFFUSIONS.build(dict(diffusion))
        for name, cfg in (
            ("speaker_encoder", speaker_encoder),
            ("pitch_encoder", pitch_encoder),
            ("pitch_shift_encoder", pitch_shift_encoder),
            ("energy_encoder", energy_encoder),
        ):
            setattr(self, name, ENCODERS.build(dict(cfg)) if cfg else None)

    @staticmethod
    def _with_time_axis(embed: torch.Tensor) -> torch.Tensor:
        return embed[:, None, :] if embed.ndim == 2 else embed

    def forward_features(
        self,
        speakers: Optional[torch.Tensor],
        contents: torch.Tensor,
        contents_lens: Optional[torch.Tensor],
        mel_lens: Optional[torch.Tensor] = None,
        mel_max_len: Optional[int] = None,
        pitches: Optional[torch.Tensor] = None,
        pitch_shift: Optional[torch.Tensor] = None,
        energy: Optional[torch.Tensor] = None,
    ) -> dict:
        """contents [B, T, C]; speakers [B] ids or a [B, H] / [B, 1, H]
        float embedding (a speaker mix). Returns the summed condition
        ``features`` [B, T, H] and the padding masks (True at padding)."""
        src_masks = (
            get_mask_from_lengths(contents_lens, contents.shape[1])
            if contents_lens is not None
            else None
        )
        mel_masks = (
            get_mask_from_lengths(mel_lens, mel_max_len or contents.shape[1])
            if mel_lens is not None
            else None
        )

        features = self.text_encoder(contents, src_masks)

        speaker_embed = None
        if (
            speakers is not None
            and speakers.ndim in (2, 3)
            and speakers.is_floating_point()
        ):
            speaker_embed = speakers
        elif speakers is not None and self.speaker_encoder is not None:
            speaker_embed = self.speaker_encoder(speakers)
        if speaker_embed is not None:
            features = features + self._with_time_axis(speaker_embed)

        if self.pitch_encoder is not None:
            features = features + self.pitch_encoder(pitches)
        if pitch_shift is not None and self.pitch_shift_encoder is not None:
            features = features + self._with_time_axis(
                self.pitch_shift_encoder(pitch_shift)
            )
        if energy is not None and self.energy_encoder is not None:
            features = features + self._with_time_axis(self.energy_encoder(energy))

        return dict(
            features=features,
            x_masks=mel_masks,
            x_lens=mel_lens,
            cond_masks=mel_masks,
        )

    def sample(
        self,
        speakers,
        contents,
        contents_lens=None,
        mel_lens=None,
        mel_max_len=None,
        pitches=None,
        pitch_shift=None,
        energy=None,
        sampler_interval: Optional[int] = None,
        skip_steps: int = 0,
        original_mel: Optional[torch.Tensor] = None,
        noise_predictor: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Condition assembly + reverse diffusion -> mel [B, T, M]; shallow
        when ``skip_steps`` > 0 with ``original_mel`` [B, T, M]."""
        features = self.forward_features(
            speakers=speakers,
            contents=contents,
            contents_lens=contents_lens,
            mel_lens=mel_lens,
            mel_max_len=mel_max_len,
            pitches=pitches,
            pitch_shift=pitch_shift,
            energy=energy,
        )
        return self.diffusion(
            features["features"],
            sampler_interval=sampler_interval,
            skip_steps=skip_steps,
            original_mel=original_mel,
            noise_predictor=noise_predictor,
            x_masks=features["x_masks"],
            cond_masks=features["cond_masks"],
            generator=generator,
            x_T=x_T,
        )
