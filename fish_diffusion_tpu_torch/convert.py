"""JAX parameter trees -> the port's state dicts.

Each function takes a nested dict of numpy arrays in the flax layout of the
JAX package and returns a ``state_dict`` for the matching port module. The
keys are fish-diffusion's torch keys, the inverse of the torch -> JAX
converters in ``tools/``:

- ``diffsinger_from_jax``: ``DiffSinger``/``DiffSVC`` with the WaveNet or
  the ConvNeXt denoiser (inverse of
  ``tools/diffusion/convert_torch_checkpoint.py:convert_diffsinger`` and
  ``convert_convnext``), and ``wavenet_from_jax`` and ``convnext_from_jax``
  for the denoisers alone;
- ``nsf_hifigan_from_jax``: ``NsfHifiGANGenerator`` (inverse of
  ``tools/nsf_hifigan/convert_checkpoint.py:convert``), and
  ``istft_net_from_jax`` for ``ISTFTNetGenerator``, whose tree has the
  same layout;
- ``hubert_from_jax`` (alias ``hubert_soft_from_jax``): the HuBERT tower in
  either order (post-norm, as HubertSoft, or pre-norm, as ChineseHubert,
  ChineseHubertSoft and ContentVec) with its head, if any, in HF
  ``HubertModel`` keys (inverse of
  ``tools/preprocessing/convert_hubert_checkpoint.py:convert_hf_hubert``);
- ``refinegan_from_jax``: ``RefineGANGenerator`` (inverse of
  ``tools/refinegan/convert_checkpoint.py:convert_refinegan``, plus the
  sine template's ``template_gen.merge`` when the tree has one);
- ``discriminators_from_jax``: the GAN discriminators of either flavor
  (MPD + MSD with its spectral-norm state, or MPD + MRD), in
  fish-diffusion's torch names (reference ``nsf_hifigan/models.py:525-613``,
  ``refinegan/mrd.py``);
- ``crepe_from_jax``: the CREPE network (flax params and batch_stats) in
  torchcrepe's keys (inverse of
  ``tools/preprocessing/convert_crepe_checkpoint.py:convert_state_dict``).

Layouts: flax Dense ``[in, out]`` is torch Linear ``[out, in]``; flax Conv
``[k, in, out]`` is torch ``[out, in, k]``; the flax ConvTranspose
``transpose_kernel`` layout ``[k, out, in]`` is torch ``[in, out, k]``; the
WaveNet and ConvNeXt blocks are stacked on a leading ``[L]`` axis (a
ConvNeXt depthwise kernel ``[L, 7, C]`` is torch ``[C, 1, 7]`` a block);
flax attention kernels
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


def _convnext(sd, prefix, p):
    if "block" not in p.get("residual_layers", {}):
        raise NotImplementedError(
            "a ConvNext tree without the scanned residual_layers stack (the "
            "cross-attention layout) is not ported yet (ROADMAP Queue 1, Other "
            "denoisers: ConvNeXt cross-attention)")
    _conv1x1(sd, f"{prefix}.input_projection", p["input_projection"]["Dense_0"])
    _linear(sd, f"{prefix}.diffusion_embedding.1", p["diff_mlp1"])
    _linear(sd, f"{prefix}.diffusion_embedding.3", p["diff_mlp2"])
    _conv1x1(sd, f"{prefix}.conditioner_projection.0", p["cond_proj1"]["Dense_0"])
    _conv1x1(sd, f"{prefix}.conditioner_projection.2", p["cond_proj2"]["Dense_0"])
    _conv1x1(sd, f"{prefix}.output_projection.0", p["out_proj1"]["Dense_0"])
    _conv1x1(sd, f"{prefix}.output_projection.2", p["out_proj2"]["Dense_0"])

    blk = p["residual_layers"]["block"]
    dw = np.asarray(blk["dwconv"]["kernel"])  # [L, 7, C]
    for i in range(dw.shape[0]):
        q = f"{prefix}.residual_layers.{i}"

        def layer(tree):
            return {k: np.asarray(v)[i] for k, v in tree.items()}

        sd[f"{q}.dwconv.weight"] = _t(dw[i].T[:, None, :])
        sd[f"{q}.dwconv.bias"] = _t(np.asarray(blk["dwconv"]["bias"])[i])
        _norm(sd, f"{q}.norm", layer(blk["norm"]))
        _linear(sd, f"{q}.pwconv1", layer(blk["pwconv1"]))
        _linear(sd, f"{q}.pwconv2", layer(blk["pwconv2"]))
        sd[f"{q}.gamma"] = _t(np.asarray(blk["gamma"])[i])
        for name in ("diffusion_step_projection", "condition_projection"):
            _conv1x1(sd, f"{q}.{name}", layer(blk[name]["Dense_0"]))


def convnext_from_jax(params: dict) -> dict:
    """``ConvNext`` denoiser params (the scanned stack) -> its state dict."""
    sd: dict = {}
    _convnext(sd, "", params)
    return {k.lstrip("."): v for k, v in sd.items()}


def diffsinger_from_jax(params: dict) -> dict:
    """``DiffSinger`` params (with or without a ``{"params": ...}`` wrap);
    the denoiser is a ConvNext when its stack has a ``dwconv``, else a
    WaveNet."""
    params = params.get("params", params)
    sd: dict = {}
    for enc in ("text_encoder", "speaker_encoder", "pitch_encoder",
                "pitch_shift_encoder", "energy_encoder"):
        if f"{enc}_mod" in params:
            _encoder(sd, enc, params[f"{enc}_mod"])
    den = params["diffusion_mod"]["denoise_fn"]
    if "dwconv" in den.get("residual_layers", {}).get("block", {}):
        _convnext(sd, "diffusion.denoise_fn", den)
    else:
        _wavenet(sd, "diffusion.denoise_fn", den)
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


# ``ISTFTNetGenerator``'s tree is NSF-HiFiGAN's (fewer levels, an n_fft + 2
# channel ``conv_post``)
istft_net_from_jax = nsf_hifigan_from_jax


def hubert_from_jax(params: dict) -> dict:
    """A HuBERT extractor's params: the ``HubertEncoder`` tree, post-norm
    (with ``pre_norm``, HF's ``encoder.layer_norm``) or pre-norm (without),
    and its head: ``soft_proj`` (HF ``proj``; HubertSoft, ChineseHubertSoft),
    ``final_proj`` (ContentVec) or none (ChineseHubert)."""
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
    if "pre_norm" in params:
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

    for name, key in (("soft_proj", "proj"), ("final_proj", "final_proj")):
        if name in params:
            _linear(sd, key, params[name])
    return sd


hubert_soft_from_jax = hubert_from_jax


def _wn_conv(sd, prefix, p, name, kernel_axes):
    """flax ``nn.WeightNorm`` around ``<name>_conv``: the scale ->
    ``weight_g`` [C_out, 1, ...], the kernel -> ``weight_v`` (torch layout)."""
    kernel = np.asarray(p[f"{name}_conv"]["kernel"]).transpose(kernel_axes)
    scale = np.asarray(p[name][f"{name}_conv/kernel/scale"])
    sd[f"{prefix}.weight_g"] = _t(scale.reshape((-1,) + (1,) * (kernel.ndim - 1)))
    sd[f"{prefix}.weight_v"] = _t(kernel)
    sd[f"{prefix}.bias"] = _t(p[f"{name}_conv"]["bias"])


def _resblock(sd, prefix, p):
    j = 0
    while f"convs1_{j}" in p:
        _wn_conv(sd, f"{prefix}.convs1.{j}", p, f"convs1_{j}", (2, 1, 0))
        _wn_conv(sd, f"{prefix}.convs2.{j}", p, f"convs2_{j}", (2, 1, 0))
        j += 1


def refinegan_from_jax(params: dict) -> dict:
    """``RefineGANGenerator`` params (the plain and blocked JAX layouts share
    one tree) -> the port's state dict, in fish-diffusion's torch names."""
    sd: dict = {}
    for name in ("template_conv", "mel_conv", "output_conv"):
        _wn_conv(sd, name, params, name, (2, 1, 0))
    _conv(sd, "source_conv", params["source_conv"])
    if "merge" in params.get("template_gen", {}):  # the sine template
        _linear(sd, "template_gen.merge", params["template_gen"]["merge"])
    i = 0
    while f"down_res_{i}" in params:
        _resblock(sd, f"downsample_blocks.{i}.1", params[f"down_res_{i}"])
        i += 1
    i = 0
    while f"up_res_{i}" in params:
        block, q = params[f"up_res_{i}"], f"upsample_conv_blocks.{i}"
        _conv(sd, f"{q}.input_conv", block["input_conv"])
        m = 0
        for k in (3, 7, 11):
            if f"res_k{k}" not in block:
                continue
            sd[f"{q}.blocks.{m}.0.weight"] = _t(block[f"adain1_k{k}"]["weight"])
            _resblock(sd, f"{q}.blocks.{m}.1", block[f"res_k{k}"])
            sd[f"{q}.blocks.{m}.2.weight"] = _t(block[f"adain2_k{k}"]["weight"])
            m += 1
        i += 1
    return sd


MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def discriminators_from_jax(params_d: dict, spectral_d: dict,
                            resolutions=MRD_RESOLUTIONS):
    """The JAX ``Discriminators`` params and ``spectral_d`` -> (state dict of
    the port's ``training.gan.Discriminators``, its spectral state). Flavor
    v1's second stack is the MSD (``disc_s*``), v2's the MRD (``disc_r*``,
    no spectral state). Weight-normed convs become ``weight_g``/``weight_v``,
    the spectral-normed scale's kernels ``weight_orig``; the u/v vectors are
    carried across as they are. The MPD's periods are taken in increasing
    order, the MRD's in the order of ``resolutions`` (a tree that passed
    through ``jax.tree_util`` has its keys sorted as strings)."""
    sd: dict = {}
    mpd = params_d["mpd"]
    for j, name in enumerate(sorted(mpd, key=lambda n: int(n[len("disc_p"):]))):
        disc = mpd[name]
        i = 0
        while f"convs_{i}_conv" in disc:  # flax [kh, kw, in, out]
            _wn_conv(sd, f"mpd.discriminators.{j}.convs.{i}", disc, f"convs_{i}",
                     (3, 2, 0, 1))
            i += 1
        _wn_conv(sd, f"mpd.discriminators.{j}.conv_post", disc, "conv_post",
                 (3, 2, 0, 1))
    if "disc_s0" not in params_d["second"]:
        for j, (n_fft, hop, _) in enumerate(resolutions):
            disc = params_d["second"][f"disc_r{n_fft}_{hop}"]
            for i in range(5):
                _wn_conv(sd, f"mrd.discriminators.{j}.convs.{i}", disc, f"convs_{i}",
                         (3, 2, 0, 1))
            _wn_conv(sd, f"mrd.discriminators.{j}.conv_post", disc, "conv_post",
                     (3, 2, 0, 1))
        return sd, {}
    spectral = {}
    for j in range(3):
        disc = params_d["second"][f"disc_s{j}"]
        uv = (spectral_d.get("second") or {}).get(f"disc_s{j}")
        names = [f"convs_{i}" for i in range(7)] + ["conv_post"]
        for name in names:
            torch_name = f"msd.discriminators.{j}." + (
                "conv_post" if name == "conv_post" else f"convs.{name[6:]}")
            if uv is None:
                _wn_conv(sd, torch_name, disc, name, (2, 1, 0))
                continue
            conv = disc[f"{name}_conv"]
            sd[f"{torch_name}.weight_orig"] = _t(np.asarray(conv["kernel"]).transpose(2, 1, 0))
            sd[f"{torch_name}.bias"] = _t(conv["bias"])
            spectral[f"{torch_name}.weight_u"] = _t(uv[f"{name}_u"])
            spectral[f"{torch_name}.weight_v"] = _t(uv[f"{name}_v"])
    return sd, spectral


def crepe_from_jax(variables: dict) -> dict:
    """``{"params", "batch_stats"}`` of the JAX package's ``Crepe`` -> a
    state dict in torchcrepe's layout (``conv{i}`` weights [out, in, k, 1],
    ``conv{i}_BN`` with running statistics, ``classifier``)."""
    p, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for i in range(1, 7):
        _conv(sd, f"conv{i}", p[f"conv{i}"])
        sd[f"conv{i}.weight"] = sd[f"conv{i}.weight"][..., None]
        _norm(sd, f"conv{i}_BN", p[f"conv{i}_BN"])
        sd[f"conv{i}_BN.running_mean"] = _t(stats[f"conv{i}_BN"]["mean"])
        sd[f"conv{i}_BN.running_var"] = _t(stats[f"conv{i}_BN"]["var"])
    _linear(sd, "classifier", p["classifier"])
    return sd
