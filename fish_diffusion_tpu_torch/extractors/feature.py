"""Content features: HuBERT-Soft (``fish_diffusion_tpu/extractors/feature.py``).

Plain PyTorch. Module and parameter names are those of HF
``transformers.HubertModel`` (plus ``proj``, the soft-unit head), so that
``tools/preprocessing/convert_hubert_checkpoint.py:convert_hf_hubert`` reads
a port state dict. Attention is a plain matmul and softmax, as flax's
``MultiHeadDotProductAttention`` computes it. Only the post-norm tower that
HubertSoft uses is ported.
"""

from __future__ import annotations

import math
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import FEATURE_EXTRACTORS
from ..utils import resolve_device

_CONV_LAYERS = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


def resample_linear(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Linear-interpolation resampling on the host."""
    if orig_sr == target_sr:
        return audio
    new_len = int(round(len(audio) * target_sr / orig_sr))
    return np.interp(
        np.linspace(0, len(audio) - 1, new_len), np.arange(len(audio)), audio
    ).astype(np.float32)


class BaseFeatureExtractor:
    """``preprocess`` resamples host audio to ``self.sampling_rate``."""

    sampling_rate: int = 16000

    def preprocess(self, audio: np.ndarray, sampling_rate: int) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 2:
            audio = audio.mean(0)
        return resample_linear(audio, sampling_rate, self.sampling_rate)

    def __call__(self, audio, sampling_rate) -> np.ndarray:
        raise NotImplementedError


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=False)
        self.layer_norm = nn.GroupNorm(c_out, c_out, eps=1e-5) if group_norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class ConvFeatureExtractor(nn.Module):
    """7 strided convs, GELU, group norm on the first:
    [B, T_samples] -> [B, T_frames, 512]."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = _CONV_LAYERS):
        super().__init__()
        chans = [1] + [c for c, _, _ in conv_layers]
        self.conv_layers = nn.ModuleList(
            _ConvLayer(chans[i], c, k, s, i == 0)
            for i, (c, k, s) in enumerate(conv_layers)
        )

    def forward(self, x):
        x = x[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, c_in: int, dim: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c_in, eps=1e-5)
        self.projection = nn.Linear(c_in, dim)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, T, dim = x.shape
        hd = dim // self.heads

        def split(t):
            return t.view(B, T, self.heads, hd).transpose(1, 2)  # [B, H, T, D]

        q = split(self.q_proj(x)) / math.sqrt(hd)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        out = (weights @ v).transpose(1, 2).reshape(B, T, dim)
        return self.out_proj(out)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(dim, ffn_dim)
        self.output_dense = nn.Linear(ffn_dim, dim)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class TransformerLayer(nn.Module):
    """Post-norm transformer layer (the JAX ``TransformerLayer`` with
    ``layer_norm_first=False``)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.attention = _Attention(dim, heads)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.feed_forward = _FeedForward(dim, ffn_dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class _PosConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 128, padding=64, groups=16)

    def forward(self, x):
        T = x.shape[1]
        pos = self.conv(x.transpose(1, 2))[:, :, :T].transpose(1, 2)
        return F.gelu(pos)


class _Encoder(nn.Module):
    def __init__(self, dim: int, num_layers: int, heads: int, ffn_dim: int):
        super().__init__()
        self.pos_conv_embed = _PosConv(dim)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.layers = nn.ModuleList(
            TransformerLayer(dim, heads, ffn_dim) for _ in range(num_layers)
        )


class HubertEncoder(nn.Module):
    """Post-norm HuBERT tower: [B, T_samples] -> the hidden states of every
    transformer layer (list of [B, T_frames, dim])."""

    def __init__(self, dim: int = 768, num_layers: int = 12, heads: int = 12,
                 ffn_dim: int = 3072):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor()
        self.feature_projection = _FeatureProjection(512, dim)
        self.encoder = _Encoder(dim, num_layers, heads, ffn_dim)

    def forward(self, audio: torch.Tensor) -> list:
        x = self.feature_projection(self.feature_extractor(audio))
        x = x + self.encoder.pos_conv_embed(x)
        x = self.encoder.layer_norm(x)
        hiddens = []
        for layer in self.encoder.layers:
            x = layer(x)
            hiddens.append(x)
        return hiddens


class HubertSoftModel(HubertEncoder):
    """The tower + the 256-d soft-unit head ``proj``."""

    def __init__(self, dim: int = 768, **kwargs):
        super().__init__(dim=dim, **kwargs)
        self.proj = nn.Linear(dim, 256)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.proj(super().forward(audio)[-1])


@FEATURE_EXTRACTORS.register_module()
class HubertSoft(BaseFeatureExtractor):
    """bshall HuBERT-Soft: host audio -> soft units [1, 256, T_frames].

    ``checkpoint_path`` names a pickle of the JAX package's params (the
    format ``tools/preprocessing/convert_hubert_checkpoint.py`` writes),
    carried across by ``convert.hubert_soft_from_jax``; without one,
    ``random_init`` draws every parameter from ``seed``. Runs on ``device``,
    the card unless the caller asks for the CPU."""

    sampling_rate = 16000

    def __init__(self, checkpoint_path: Optional[str] = None,
                 random_init: bool = False, seed: int = 0, device="cuda",
                 **encoder_kwargs):
        self.device = resolve_device(device)
        self.model = HubertSoftModel(**encoder_kwargs)
        self.has_weights = False
        if checkpoint_path:
            from ..convert import hubert_soft_from_jax

            with open(checkpoint_path, "rb") as f:
                self.load_state_dict(hubert_soft_from_jax(pickle.load(f)))
        elif random_init:
            self.init_random(seed)
        self.model.to(self.device).eval()

    def load_state_dict(self, state_dict: dict):
        self.model.load_state_dict(state_dict)
        self.has_weights = True

    def init_random(self, seed: int = 0):
        from ..utils import init_random_

        init_random_(self.model, seed)
        self.has_weights = True

    @torch.inference_mode()
    def __call__(self, audio, sampling_rate=44100) -> np.ndarray:
        if not self.has_weights:
            raise RuntimeError(
                "HubertSoft has no weights: give checkpoint_path or random_init"
            )
        audio = self.preprocess(audio, sampling_rate)
        x = torch.from_numpy(audio)[None].to(self.device)
        return self.model(x).transpose(1, 2).float().cpu().numpy()
