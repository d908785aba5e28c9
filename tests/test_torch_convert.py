"""Weights across the two packages: JAX params -> ``fish_diffusion_tpu_torch.convert``
-> the port's modules (strict ``load_state_dict``) -> ``state_dict`` -> the
repository's torch -> JAX converters in ``tools/`` -> equal to the input."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from fish_diffusion_tpu.extractors import feature as jfeature
from fish_diffusion_tpu.extractors.crepe import CrepePitchExtractor as JCrepe
from fish_diffusion_tpu.extractors.feature import HubertSoft as JHubertSoft
from fish_diffusion_tpu.models.diffsinger import DiffSinger as JDiffSinger
from fish_diffusion_tpu.models.vocoders.istft_net import (
    ISTFTNetGenerator as JISTFTNet,
)
from fish_diffusion_tpu.models.vocoders.nsf_hifigan import (
    NsfHifiGANGenerator as JGenerator,
)
from fish_diffusion_tpu.models.vocoders.refinegan import (
    RefineGANGenerator as JRefineGAN,
)
from fish_diffusion_tpu_torch.convert import (
    convnext_from_jax,
    crepe_from_jax,
    diffsinger_from_jax,
    hubert_from_jax,
    hubert_soft_from_jax,
    istft_net_from_jax,
    nsf_hifigan_from_jax,
    refinegan_from_jax,
)
from fish_diffusion_tpu_torch.extractors.crepe import Crepe
from fish_diffusion_tpu_torch.extractors.feature import HubertSoftModel
from fish_diffusion_tpu_torch.models.convnext import ConvNext
from fish_diffusion_tpu_torch.models.diffsinger import DiffSinger
from fish_diffusion_tpu_torch.models.vocoders.istft_net import ISTFTNetGenerator
from fish_diffusion_tpu_torch.models.vocoders.nsf_hifigan import NsfHifiGANGenerator
from fish_diffusion_tpu_torch.models.vocoders.refinegan import RefineGANGenerator
from fish_diffusion_tpu_torch.registry import FEATURE_EXTRACTORS

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def load_tool(rel, name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(a, b, path=""):
    assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), f"{path}/{k}"


def round_trip(port_module, state_dict):
    port_module.load_state_dict(state_dict)  # strict: every key matches
    return {k: v.numpy() for k, v in port_module.state_dict().items()}


def test_diffsinger_round_trip():
    cfg = dict(
        text_encoder=dict(type="NaiveProjectionEncoder", input_size=24, output_size=16),
        speaker_encoder=dict(type="NaiveProjectionEncoder", input_size=4,
                             output_size=16, use_embedding=True),
        pitch_encoder=dict(type="NaiveProjectionEncoder", input_size=1,
                           output_size=16, preprocessing="pitch_to_scale"),
        diffusion=dict(
            type="GaussianDiffusion", mel_channels=8, timesteps=100,
            spec_min=[-5], spec_max=[0],
            denoiser=dict(type="WaveNetDenoiser", mel_channels=8, d_encoder=16,
                          residual_channels=16, residual_layers=3,
                          dilation_cycle=2, use_linear_bias=True),
        ),
    )
    params = numpy_tree(jax.jit(JDiffSinger(**cfg).init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.zeros((1,), jnp.int32), jnp.ones((1, 6, 24)),
        mel=jnp.zeros((1, 6, 8)), pitches=jnp.full((1, 6), 200.0),
    )["params"])
    sd = round_trip(DiffSinger(**cfg), diffsinger_from_jax(params))
    convert = load_tool("diffusion/convert_torch_checkpoint.py", "diffsinger_convert")
    assert_trees_equal(params, convert.convert_diffsinger(sd))


def test_convnext_diffsinger_round_trip():
    """DiffSinger with the ConvNeXt denoiser (the scanned block stack ->
    per-block tensors): ``diffsinger_from_jax`` dispatches on the tree, and
    ``convert_diffsinger`` (through ``convert_convnext``) reads the port's
    state dict back, bit-equal; ``convnext_from_jax`` gives the denoiser's
    own keys."""
    cfg = dict(
        text_encoder=dict(type="NaiveProjectionEncoder", input_size=24, output_size=16),
        speaker_encoder=dict(type="NaiveProjectionEncoder", input_size=4,
                             output_size=16, use_embedding=True),
        pitch_encoder=dict(type="NaiveProjectionEncoder", input_size=1,
                           output_size=16, preprocessing="pitch_to_scale"),
        diffusion=dict(
            type="GaussianDiffusion", mel_channels=8, timesteps=100,
            spec_min=[-5], spec_max=[0],
            denoiser=dict(type="ConvNextDenoiser", mel_channels=8, dim=16, mlp_factor=2,
                          condition_dim=16, num_layers=3, dilation_cycle=2),
        ),
    )
    params = numpy_tree(jax.jit(JDiffSinger(**cfg).init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.zeros((1,), jnp.int32), jnp.ones((1, 6, 24)),
        mel=jnp.zeros((1, 6, 8)), pitches=jnp.full((1, 6), 200.0),
    )["params"])
    sd = round_trip(DiffSinger(**cfg), diffsinger_from_jax(params))
    assert sd["diffusion.denoise_fn.residual_layers.2.dwconv.weight"].shape == (16, 1, 7)
    convert = load_tool("diffusion/convert_torch_checkpoint.py", "convnext_convert_rt")
    assert_trees_equal(params, convert.convert_diffsinger(sd))
    den = round_trip(ConvNext(mel_channels=8, dim=16, mlp_factor=2, condition_dim=16,
                              num_layers=3, dilation_cycle=2),
                     convnext_from_jax(params["diffusion_mod"]["denoise_fn"]))
    prefix = "diffusion.denoise_fn."
    assert den.keys() == {k[len(prefix):] for k in sd if k.startswith(prefix)}


def test_nsf_hifigan_round_trip():
    gen_cfg = dict(num_mels=16, hop_size=8, upsample_rates=(2, 2, 2),
                   upsample_kernel_sizes=(4, 4, 4), upsample_initial_channel=32,
                   resblock_kernel_sizes=(3, 7),
                   resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
    # the plain path declares the same parameter tree and compiles faster
    jgen = JGenerator(**gen_cfg, blocked_tail=False)
    params = numpy_tree(jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 16)), jnp.full((1, 4), 220.0),
    )["params"])
    sd = round_trip(NsfHifiGANGenerator(**gen_cfg), nsf_hifigan_from_jax(params))
    convert = load_tool("nsf_hifigan/convert_checkpoint.py", "nsf_convert_rt")
    assert_trees_equal(params, convert.convert(sd, n_ups=3))


def test_refinegan_round_trip():
    """RefineGAN in fish-diffusion's torch key layout, read back by
    ``tools/refinegan/convert_checkpoint.py:convert_refinegan``."""
    gen_cfg = dict(hop_length=16, downsample_rates=(2, 2, 2, 2),
                   upsample_rates=(2, 2, 2, 2), num_mels=16, start_channels=4)
    # the plain path declares the same parameter tree and compiles faster
    jgen = JRefineGAN(**gen_cfg, blocked_tail=False)
    params = numpy_tree(jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 16)), jnp.full((1, 4), 220.0),
    )["params"])
    sd = round_trip(RefineGANGenerator(**gen_cfg), refinegan_from_jax(params))
    convert = load_tool("refinegan/convert_checkpoint.py", "refinegan_convert_rt")
    assert_trees_equal(params, convert.convert_refinegan(sd))


def test_istft_net_round_trip():
    """iSTFTNet's tree has NSF-HiFiGAN's layout: read back by
    ``tools/nsf_hifigan/convert_checkpoint.py:convert`` with its two
    levels."""
    gen_cfg = dict(num_mels=16, hop_size=128, upsample_rates=(4, 4),
                   upsample_kernel_sizes=(8, 8), upsample_initial_channel=32)
    params = numpy_tree(jax.jit(JISTFTNet(**gen_cfg).init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 16)), jnp.full((1, 4), 220.0),
    )["params"])
    sd = round_trip(ISTFTNetGenerator(**gen_cfg), istft_net_from_jax(params))
    assert sd["conv_post.weight"].shape == (18, 8, 7)
    convert = load_tool("nsf_hifigan/convert_checkpoint.py", "istft_convert_rt")
    assert_trees_equal(params, convert.convert(sd, n_ups=2))


def test_refinegan_sine_round_trip():
    """RefineGAN with the sine template: the tool reads back every key but
    the template's merge, which ``refinegan_from_jax`` carries as
    ``template_gen.merge`` (a Linear, [out, in])."""
    gen_cfg = dict(hop_length=16, downsample_rates=(2, 2, 2, 2),
                   upsample_rates=(2, 2, 2, 2), num_mels=16, start_channels=4,
                   template_generator="sine")
    jgen = JRefineGAN(**gen_cfg, blocked_tail=False)
    params = numpy_tree(jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 16)), jnp.full((1, 4), 220.0),
    )["params"])
    sd = round_trip(RefineGANGenerator(**gen_cfg), refinegan_from_jax(params))
    merge = params["template_gen"]["merge"]
    np.testing.assert_array_equal(sd.pop("template_gen.merge.weight"), merge["kernel"].T)
    np.testing.assert_array_equal(sd.pop("template_gen.merge.bias"), merge["bias"])
    convert = load_tool("refinegan/convert_checkpoint.py", "refinegan_sine_convert_rt")
    assert_trees_equal({k: v for k, v in params.items() if k != "template_gen"},
                       convert.convert_refinegan(sd))


def test_hubert_soft_round_trip():
    params = numpy_tree(JHubertSoft(num_layers=1, random_init=True).params)
    sd = round_trip(HubertSoftModel(num_layers=1), hubert_soft_from_jax(params))
    convert = load_tool("preprocessing/convert_hubert_checkpoint.py", "hubert_convert_rt")
    assert_trees_equal(params, convert.convert_hf_hubert(sd))


def test_pre_norm_hubert_round_trip():
    """The pre-norm front ends (ChineseHubertSoft's ``soft_proj``,
    ContentVec's ``final_proj``, ChineseHubert's no head) through
    ``hubert_from_jax`` into the port's models and back through
    ``tools/preprocessing/convert_hubert_checkpoint.py:convert_hf_hubert``:
    the tool reads a tower without ``encoder.layer_norm`` as pre-norm (no
    ``pre_norm``), and the heads by their HF keys (``proj``,
    ``final_proj``): bit-equal."""
    convert = load_tool("preprocessing/convert_hubert_checkpoint.py", "hubert_pre_rt")
    for name in ("ChineseHubertSoft", "ContentVec", "ChineseHubert"):
        jext = getattr(jfeature, name)(num_layers=1, random_init=True)
        params = numpy_tree(jext.params)
        assert "pre_norm" not in params
        port = FEATURE_EXTRACTORS.build(dict(type=name, num_layers=1, output_layer=1)
                                        if name == "ContentVec"
                                        else dict(type=name, num_layers=1), device="cpu")
        sd = round_trip(port.model, hubert_from_jax(params))
        assert_trees_equal(params, convert.convert_hf_hubert(sd))


def test_crepe_round_trip():
    """CREPE (full capacity) in torchcrepe's key layout, read back by
    ``tools/preprocessing/convert_crepe_checkpoint.py:convert_state_dict``."""
    variables = numpy_tree(JCrepe(model="full").init_random(jax.random.PRNGKey(0)))
    sd = round_trip(Crepe("full"), crepe_from_jax(variables))
    convert = load_tool("preprocessing/convert_crepe_checkpoint.py", "crepe_convert_rt")
    assert set(k for k in sd if "num_batches_tracked" not in k) == set(convert.TORCHCREPE_KEYS)
    assert_trees_equal(variables, convert.convert_state_dict(sd))
