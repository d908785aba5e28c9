"""JAX parameter trees -> the port's state dicts.

Each function takes a nested dict of numpy arrays in the flax layout of the
JAX package and returns a ``state_dict`` for the matching port module. The
keys are fish-diffusion's torch keys, the inverse of the torch -> JAX
converters in ``tools/``:

- ``diffsinger_from_jax``: ``DiffSinger``/``DiffSVC`` (inverse of
  ``tools/diffusion/convert_torch_checkpoint.py:convert_diffsinger``), and
  ``wavenet_from_jax`` for the denoiser alone;
- ``nsf_hifigan_from_jax``: ``NsfHifiGANGenerator`` (inverse of
  ``tools/nsf_hifigan/convert_checkpoint.py:convert``);
- ``hubert_soft_from_jax``: the HubertSoft tower with HF ``HubertModel``
  keys (inverse of
  ``tools/preprocessing/convert_hubert_checkpoint.py:convert_hf_hubert``).

Layouts: flax Dense ``[in, out]`` is torch Linear ``[out, in]``; flax Conv
``[k, in, out]`` is torch ``[out, in, k]``; the flax ConvTranspose
``transpose_kernel`` layout ``[k, out, in]`` is torch ``[in, out, k]``; the
WaveNet blocks are stacked on a leading ``[L]`` axis; flax attention kernels
are ``[dim, heads, head_dim]`` (out: ``[heads, head_dim, dim]``).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1x1(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _encoder(sd, prefix, p):
    if "embedding" in p:
        sd[f"{prefix}.embedding.weight"] = _t(p["embedding"]["embedding"])
    elif "projection" in p:
        _linear(sd, f"{prefix}.projection", p["projection"])
    else:
        _linear(sd, f"{prefix}.projection.0", p["projection_0"])
        _linear(sd, f"{prefix}.projection.1", p["projection_1"])


def _wavenet(sd, prefix, p):
    _conv1x1(sd, f"{prefix}.input_projection.conv", p["input_projection"]["Dense_0"])
    _linear(sd, f"{prefix}.mlp.0.linear", p["mlp_0"]["Dense_0"])
    _linear(sd, f"{prefix}.mlp.2.linear", p["mlp_1"]["Dense_0"])
    _conv1x1(sd, f"{prefix}.skip_projection.conv", p["skip_projection"]["Dense_0"])
    _conv1x1(sd, f"{prefix}.output_projection.conv", p["output_projection"]["Dense_0"])

    blk = p["residual_layers"]
    conv = blk["conv_layer"]
    taps = [np.asarray(conv[n]["kernel"]) for n in ("w_left", "w_center", "w_right")]
    for i in range(taps[0].shape[0]):
        q = f"{prefix}.residual_layers.{i}"
        # [C, 2R] per tap -> [2R, C, 3], tap 0 reading x[t - d]
        sd[f"{q}.conv_layer.conv.weight"] = _t(
            np.stack([t[i].T for t in taps], axis=-1)
        )
        sd[f"{q}.conv_layer.conv.bias"] = _t(conv["bias"][i])
        for name, fn in (
            ("diffusion_projection", _linear),
            ("conditioner_projection", _conv1x1),
            ("output_projection", _conv1x1),
        ):
            inner = blk[name]["Dense_0"]
            layer = {k: np.asarray(v)[i] for k, v in inner.items()}
            suffix = "linear" if fn is _linear else "conv"
            fn(sd, f"{q}.{name}.{suffix}", layer)


def wavenet_from_jax(params: dict) -> dict:
    """``WaveNet`` denoiser params -> its state dict (no prefix)."""
    sd: dict = {}
    _wavenet(sd, "", params)
    return {k.lstrip("."): v for k, v in sd.items()}


def diffsinger_from_jax(params: dict) -> dict:
    """``DiffSinger`` params (with or without a ``{"params": ...}`` wrap)."""
    params = params.get("params", params)
    sd: dict = {}
    for enc in ("text_encoder", "speaker_encoder", "pitch_encoder",
                "pitch_shift_encoder", "energy_encoder"):
        if f"{enc}_mod" in params:
            _encoder(sd, enc, params[f"{enc}_mod"])
    _wavenet(sd, "diffusion.denoise_fn", params["diffusion_mod"]["denoise_fn"])
    return sd


def nsf_hifigan_from_jax(params: dict) -> dict:
    """``NsfHifiGANGenerator`` params (the plain and blocked JAX layouts
    share one tree)."""
    sd: dict = {}
    _conv(sd, "conv_pre", params["conv_pre"])
    _conv(sd, "conv_post", params["conv_post"])
    _linear(sd, "m_source.l_linear", params["m_source"]["l_linear"])
    i = 0
    while f"ups_{i}" in params:
        # flax transpose_kernel [k, out, in] -> torch ConvTranspose1d [in, out, k]
        _conv(sd, f"ups.{i}", params[f"ups_{i}"])
        _conv(sd, f"noise_convs.{i}", params[f"noise_convs_{i}"])
        i += 1
    r = 0
    while f"resblocks_{r}" in params:
        block = params[f"resblocks_{r}"]
        j = 0
        while f"convs1_{j}" in block:
            _conv(sd, f"resblocks.{r}.convs1.{j}", block[f"convs1_{j}"]["Conv_0"])
            _conv(sd, f"resblocks.{r}.convs2.{j}", block[f"convs2_{j}"]["Conv_0"])
            j += 1
        r += 1
    return sd


def hubert_soft_from_jax(params: dict) -> dict:
    """HubertSoft params: the ``HubertEncoder`` tree plus ``soft_proj``."""
    sd: dict = {}
    fe = params["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        _conv(sd, f"feature_extractor.conv_layers.{i}.conv", fe[f"conv_{i}"])
        i += 1
    _norm(sd, "feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    _norm(sd, "feature_projection.layer_norm", params["feat_norm"])
    _linear(sd, "feature_projection.projection", params["feature_projection"])
    _conv(sd, "encoder.pos_conv_embed.conv", params["pos_conv"])
    _norm(sd, "encoder.layer_norm", params["pre_norm"])

    i = 0
    while f"layer_{i}" in params:
        lp, q = params[f"layer_{i}"], f"encoder.layers.{i}"
        attn = lp["attn"]
        for name in ("query", "key", "value"):
            kernel = np.asarray(attn[name]["kernel"])  # [dim, heads, head_dim]
            proj = f"{q}.attention.{name[0]}_proj"
            sd[f"{proj}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
            sd[f"{proj}.bias"] = _t(np.asarray(attn[name]["bias"]).reshape(-1))
        out = np.asarray(attn["out"]["kernel"])  # [heads, head_dim, dim]
        sd[f"{q}.attention.out_proj.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[f"{q}.attention.out_proj.bias"] = _t(attn["out"]["bias"])
        _norm(sd, f"{q}.layer_norm", lp["norm1"])
        _linear(sd, f"{q}.feed_forward.intermediate_dense", lp["fc1"])
        _linear(sd, f"{q}.feed_forward.output_dense", lp["fc2"])
        _norm(sd, f"{q}.final_layer_norm", lp["norm2"])
        i += 1

    _linear(sd, "proj", params["soft_proj"])
    return sd
