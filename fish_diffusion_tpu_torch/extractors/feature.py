"""Content features: the HuBERT front ends
(``fish_diffusion_tpu/extractors/feature.py``): HubertSoft, ContentVec,
ChineseHubert and ChineseHubertSoft.

Plain PyTorch. Module and parameter names are those of HF
``transformers.HubertModel`` (plus the heads ``proj`` and ``final_proj``),
so that ``tools/preprocessing/convert_hubert_checkpoint.py:convert_hf_hubert``
reads a port state dict. Attention is a plain matmul and softmax, as flax's
``MultiHeadDotProductAttention`` computes it. The tower runs in either
order: post-norm (HubertSoft) or pre-norm (``layer_norm_first``: the
others), which, as in the JAX package, has no norm after the positional
conv and none after the last layer.
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
    """The JAX ``TransformerLayer``: post-norm, or pre-norm with
    ``layer_norm_first`` (``layer_norm`` before the attention,
    ``final_layer_norm`` before the feed-forward, both residuals outside)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, layer_norm_first: bool = False):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.attention = _Attention(dim, heads)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.feed_forward = _FeedForward(dim, ffn_dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        if self.layer_norm_first:
            x = x + self.attention(self.layer_norm(x))
            return x + self.feed_forward(self.final_layer_norm(x))
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
    def __init__(self, dim: int, num_layers: int, heads: int, ffn_dim: int,
                 layer_norm_first: bool):
        super().__init__()
        self.pos_conv_embed = _PosConv(dim)
        # post-norm only: the norm after the positional conv (JAX ``pre_norm``)
        self.layer_norm = None if layer_norm_first else nn.LayerNorm(dim, eps=1e-5)
        self.layers = nn.ModuleList(
            TransformerLayer(dim, heads, ffn_dim, layer_norm_first)
            for _ in range(num_layers)
        )


class HubertEncoder(nn.Module):
    """HuBERT tower: [B, T_samples] -> the hidden states of every
    transformer layer (list of [B, T_frames, dim])."""

    def __init__(self, dim: int = 768, num_layers: int = 12, heads: int = 12,
                 ffn_dim: int = 3072, layer_norm_first: bool = False):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor()
        self.feature_projection = _FeatureProjection(512, dim)
        self.encoder = _Encoder(dim, num_layers, heads, ffn_dim, layer_norm_first)

    def forward(self, audio: torch.Tensor) -> list:
        x = self.feature_projection(self.feature_extractor(audio))
        x = x + self.encoder.pos_conv_embed(x)
        if self.encoder.layer_norm is not None:
            x = self.encoder.layer_norm(x)
        hiddens = []
        for layer in self.encoder.layers:
            x = layer(x)
            hiddens.append(x)
        return hiddens


class HubertHeadModel(HubertEncoder):
    """The tower, the hidden state ``hiddens[layer]`` and an optional
    256-d head named ``head`` (``"proj"`` or ``"final_proj"``), then, with
    ``gate_size``, the top-k gate: each frame keeps its values at or above
    its ``gate_size``-th largest (ties keep more) and zeroes the rest."""

    def __init__(self, dim: int = 768, head: Optional[str] = None, layer: int = -1,
                 gate_size: Optional[int] = None, **kwargs):
        super().__init__(dim=dim, **kwargs)
        self.head, self.layer, self.gate_size = head, layer, gate_size
        if head is not None:
            setattr(self, head, nn.Linear(dim, 256))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        feats = super().forward(audio)[self.layer]
        if self.head is not None:
            feats = getattr(self, self.head)(feats)
        if self.gate_size is not None:
            threshold = feats.topk(self.gate_size, dim=-1).values[..., -1:]
            feats = torch.where(feats >= threshold, feats, torch.zeros_like(feats))
        return feats


class HubertSoftModel(HubertHeadModel):
    """The post-norm tower + the 256-d soft-unit head ``proj``."""

    def __init__(self, dim: int = 768, **kwargs):
        super().__init__(dim=dim, head="proj", **kwargs)


class _HubertExtractor(BaseFeatureExtractor):
    """Host audio -> features [1, C, T_frames] through ``model``.

    ``checkpoint_path`` names a pickle of the JAX package's params (the
    format ``tools/preprocessing/convert_hubert_checkpoint.py`` writes),
    carried across by ``convert.hubert_from_jax``; without one,
    ``random_init`` draws every parameter from ``seed``. Runs on ``device``,
    the card unless the caller asks for the CPU."""

    sampling_rate = 16000

    def __init__(self, model: nn.Module, checkpoint_path: Optional[str],
                 random_init: bool, seed: int, device):
        self.device = resolve_device(device)
        self.model = model
        self.has_weights = False
        if checkpoint_path:
            from ..convert import hubert_from_jax

            with open(checkpoint_path, "rb") as f:
                self.load_state_dict(hubert_from_jax(pickle.load(f)))
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
                f"{type(self).__name__} has no weights: give checkpoint_path or "
                "random_init"
            )
        audio = self.preprocess(audio, sampling_rate)
        x = torch.from_numpy(audio)[None].to(self.device)
        return self.model(x).transpose(1, 2).float().cpu().numpy()


@FEATURE_EXTRACTORS.register_module()
class HubertSoft(_HubertExtractor):
    """bshall HuBERT-Soft: the post-norm tower and the soft-unit head ->
    [1, 256, T_frames]."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 random_init: bool = False, seed: int = 0, device="cuda",
                 **encoder_kwargs):
        super().__init__(HubertSoftModel(**encoder_kwargs), checkpoint_path,
                         random_init, seed, device)


@FEATURE_EXTRACTORS.register_module()
class ContentVec(_HubertExtractor):
    """ContentVec: the pre-norm tower's layer ``output_layer`` (1-based),
    then ``final_proj`` to 256 unless ``use_projection`` is False."""

    def __init__(self, checkpoint_path: Optional[str] = None, output_layer: int = 9,
                 use_projection: bool = True, random_init: bool = False, seed: int = 0,
                 device="cuda", **encoder_kwargs):
        model = HubertHeadModel(head="final_proj" if use_projection else None,
                                layer=output_layer - 1, layer_norm_first=True,
                                **encoder_kwargs)
        super().__init__(model, checkpoint_path, random_init, seed, device)


@FEATURE_EXTRACTORS.register_module()
class ChineseHubert(_HubertExtractor):
    """Chinese HuBERT: the pre-norm tower's hidden state
    ``hiddens[output_layer]`` (the last by default)."""

    def __init__(self, checkpoint_path: Optional[str] = None, output_layer: int = -1,
                 random_init: bool = False, seed: int = 0, device="cuda",
                 **encoder_kwargs):
        model = HubertHeadModel(layer=output_layer, layer_norm_first=True,
                                **encoder_kwargs)
        super().__init__(model, checkpoint_path, random_init, seed, device)


@FEATURE_EXTRACTORS.register_module()
class ChineseHubertSoft(_HubertExtractor):
    """Chinese HuBERT-Soft: the pre-norm tower, the soft-unit head ``proj``
    and the top-k gate of ``gate_size`` over the 256 channels of a frame."""

    def __init__(self, checkpoint_path: Optional[str] = None, gate_size: int = 10,
                 random_init: bool = False, seed: int = 0, device="cuda",
                 **encoder_kwargs):
        model = HubertHeadModel(head="proj", gate_size=gate_size, layer_norm_first=True,
                                **encoder_kwargs)
        super().__init__(model, checkpoint_path, random_init, seed, device)
