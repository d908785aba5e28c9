"""Weights across the two packages: JAX params -> ``fish_diffusion_tpu_torch.convert``
-> the port's modules (strict ``load_state_dict``) -> ``state_dict`` -> the
repository's torch -> JAX converters in ``tools/`` -> equal to the input."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from fish_diffusion_tpu.extractors.feature import HubertSoft as JHubertSoft
from fish_diffusion_tpu.models.diffsinger import DiffSinger as JDiffSinger
from fish_diffusion_tpu.models.vocoders.nsf_hifigan import (
    NsfHifiGANGenerator as JGenerator,
)
from fish_diffusion_tpu_torch.convert import (
    diffsinger_from_jax,
    hubert_soft_from_jax,
    nsf_hifigan_from_jax,
)
from fish_diffusion_tpu_torch.extractors.feature import HubertSoftModel
from fish_diffusion_tpu_torch.models.diffsinger import DiffSinger
from fish_diffusion_tpu_torch.models.vocoders.nsf_hifigan import NsfHifiGANGenerator

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


def test_hubert_soft_round_trip():
    params = numpy_tree(JHubertSoft(num_layers=1, random_init=True).params)
    sd = round_trip(HubertSoftModel(num_layers=1), hubert_soft_from_jax(params))
    convert = load_tool("preprocessing/convert_hubert_checkpoint.py", "hubert_convert_rt")
    assert_trees_equal(params, convert.convert_hf_hubert(sd))
