"""PyTorch port vs the JAX package: schedules, UniPC tables, small ops,
condition encoders and DiffSinger condition assembly.

Inputs are made with numpy from a seed and go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models import diffusion as jdiff
from fish_diffusion_tpu.models.common import diffusion_embedding as j_embedding
from fish_diffusion_tpu.models.common import mish as j_mish
from fish_diffusion_tpu.models.diffsinger import DiffSinger as JDiffSinger
from fish_diffusion_tpu.models.encoders import NaiveProjectionEncoder as JEncoder
from fish_diffusion_tpu.ops import masking as jmask
from fish_diffusion_tpu.ops import pitch as jpitch
from fish_diffusion_tpu.ops import tensor as jtensor
from fish_diffusion_tpu.ops.schedule import get_noise_schedule_list as j_schedule
from fish_diffusion_tpu_torch.convert import diffsinger_from_jax
from fish_diffusion_tpu_torch.models import diffusion as tdiff
from fish_diffusion_tpu_torch.models.common import diffusion_embedding, mish
from fish_diffusion_tpu_torch.models.diffsinger import DiffSinger
from fish_diffusion_tpu_torch.models.encoders import NaiveProjectionEncoder
from fish_diffusion_tpu_torch.ops import masking, pitch, tensor
from fish_diffusion_tpu_torch.ops.schedule import get_noise_schedule_list


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, seed):
    """Replace every leaf of a JAX param tree with seeded numpy draws."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    new = [
        (rng.standard_normal(np.shape(x)) * 0.3).astype(np.float32) for x in leaves
    ]
    return jax.tree_util.tree_unflatten(treedef, new)


@pytest.mark.parametrize(
    "schedule,steps,t_start,variant,order",
    [
        ("linear", 100, None, "bh2", 2),
        ("linear", 100, None, "bh1", 3),
        ("cosine", 20, 0.5, "bh2", 1),
        ("linear", 7, None, "bh2", 3),
    ],
)
def test_schedule_and_unipc_tables_exact(schedule, steps, t_start, variant, order):
    """Tolerance: exact (both are the same float64 numpy algebra)."""
    betas = get_noise_schedule_list(schedule, 1000)
    assert np.array_equal(betas, j_schedule(schedule, 1000))
    jc, tc = jdiff.ScheduleCoefficients(betas), tdiff.ScheduleCoefficients(betas)
    for name, value in vars(jc).items():
        assert np.array_equal(value, getattr(tc, name)), name
    jt = jdiff.unipc_step_table(jc, steps, t_start, variant, order)
    tt = tdiff.unipc_step_table(tc, steps, t_start, variant, order)
    assert jt.keys() == tt.keys()
    for k in jt:
        assert jt[k].dtype == tt[k].dtype and np.array_equal(jt[k], tt[k]), k


def test_small_ops_match():
    """pitch_to_scale, masks, repeat_expand_np: <= 1e-6; mish and the step
    embedding: a few float32 ulps of their arguments (sin of t * freq with
    t up to 999 carries the float32 ulp of 999, 6e-5)."""
    rng = np.random.default_rng(0)
    f0 = rng.uniform(0, 1500, (3, 50)).astype(np.float32)
    np.testing.assert_allclose(
        pitch.pitch_to_scale(torch.from_numpy(f0)).numpy(),
        np.asarray(jpitch.pitch_to_scale(jnp.asarray(f0))), atol=1e-6,
    )
    lens = np.array([50, 17, 1])
    np.testing.assert_array_equal(
        masking.get_mask_from_lengths(torch.from_numpy(lens), 50).numpy(),
        np.asarray(jmask.get_mask_from_lengths(jnp.asarray(lens), 50)),
    )
    content = rng.standard_normal((256, 37)).astype(np.float32)
    for mode in ("nearest", "linear"):
        for n in (37, 100, 20):
            np.testing.assert_allclose(
                tensor.repeat_expand_np(content, n, mode),
                jtensor.repeat_expand_np(content, n, mode), atol=1e-6,
            )
    x = rng.standard_normal((4, 64)).astype(np.float32) * 5
    np.testing.assert_allclose(
        mish(torch.from_numpy(x)).numpy(), np.asarray(j_mish(jnp.asarray(x))),
        atol=1e-6, rtol=1e-6,
    )
    t = np.array([0, 13.5, 500, 999], np.float32)
    np.testing.assert_allclose(
        diffusion_embedding(torch.from_numpy(t), 64).numpy(),
        np.asarray(j_embedding(jnp.asarray(t), 64)), atol=1e-4,
    )


@pytest.mark.parametrize(
    "kwargs,x",
    [
        (dict(input_size=10, output_size=16, use_embedding=True),
         np.array([[0, 3, 9]], np.int32)),
        (dict(input_size=1, output_size=16, preprocessing="pitch_to_scale"),
         np.array([[0.0, 110.0, 440.0, 1200.0]], np.float32)),
        (dict(input_size=24, output_size=16, use_neck=True, neck_size=8),
         np.random.default_rng(1).standard_normal((2, 5, 24)).astype(np.float32)),
    ],
    ids=["embedding", "linear_pitch", "neck"],
)
def test_naive_projection_encoder(kwargs, x):
    """Tolerance 1e-5."""
    jenc = JEncoder(**kwargs)
    params = randomize(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    sd = {}
    if "embedding" in params:
        sd["embedding.weight"] = torch.from_numpy(params["embedding"]["embedding"])
    for i, name in enumerate(("projection", "projection_0", "projection_1")):
        if name in params:
            key = "projection" if i == 0 else f"projection.{i - 1}"
            sd[f"{key}.weight"] = torch.from_numpy(params[name]["kernel"].T.copy())
            sd[f"{key}.bias"] = torch.from_numpy(params[name]["bias"])
    tenc = NaiveProjectionEncoder(**kwargs)
    tenc.load_state_dict(sd)
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def diffsinger_cfg(text_neck: bool):
    hidden = 16
    return dict(
        text_encoder=dict(type="NaiveProjectionEncoder", input_size=24,
                          output_size=hidden, use_neck=text_neck),
        speaker_encoder=dict(type="NaiveProjectionEncoder", input_size=4,
                             output_size=hidden, use_embedding=True),
        pitch_encoder=dict(type="NaiveProjectionEncoder", input_size=1,
                           output_size=hidden, preprocessing="pitch_to_scale"),
        diffusion=dict(
            type="GaussianDiffusion", mel_channels=8, timesteps=100,
            sampler_interval=10, spec_min=[-5], spec_max=[0],
            denoiser=dict(type="WaveNetDenoiser", mel_channels=8,
                          d_encoder=hidden, residual_channels=16,
                          residual_layers=2, dilation_cycle=2,
                          use_linear_bias=True),
        ),
    )


@pytest.mark.parametrize("text_neck", [False, True])
@pytest.mark.parametrize("speaker", ["id", "mix"])
def test_forward_features(text_neck, speaker):
    """Condition assembly with an id speaker and a float speaker mix:
    <= 1e-5."""
    rng = np.random.default_rng(3)
    B, T = 2, 12
    contents = rng.standard_normal((B, T, 24)).astype(np.float32)
    pitches = rng.uniform(80, 600, (B, T)).astype(np.float32)
    lens = np.array([T, 7], np.int32)
    mel = rng.uniform(-4, 0, (B, T, 8)).astype(np.float32)
    spk = (np.array([1, 3], np.int32) if speaker == "id"
           else rng.standard_normal((B, 1, 16)).astype(np.float32))

    cfg = diffsinger_cfg(text_neck)
    jmodel = JDiffSinger(**cfg)
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.asarray([0, 1]), jnp.asarray(contents), jnp.asarray(lens),
        mel=jnp.asarray(mel), pitches=jnp.asarray(pitches),
    )["params"]
    params = randomize(params, 4)
    ref = jmodel.apply(
        {"params": params}, jnp.asarray(spk), jnp.asarray(contents),
        jnp.asarray(lens), mel_lens=jnp.asarray(lens),
        pitches=jnp.asarray(pitches), method=jmodel.forward_features,
    )

    tmodel = DiffSinger(**cfg)
    tmodel.load_state_dict(diffsinger_from_jax(params))
    with torch.no_grad():
        got = tmodel.forward_features(
            torch.from_numpy(spk), torch.from_numpy(contents),
            torch.from_numpy(lens).long(), mel_lens=torch.from_numpy(lens).long(),
            pitches=torch.from_numpy(pitches),
        )
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(ref["features"]), atol=1e-5)
    np.testing.assert_array_equal(got["x_masks"].numpy(), np.asarray(ref["x_masks"]))


def test_q_sample():
    """Forward noising at integer steps: <= 1e-6."""
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((3, 10, 8)).astype(np.float32)
    noise = rng.standard_normal((3, 10, 8)).astype(np.float32)
    t = np.array([0, 50, 99], np.int32)
    cfg = diffsinger_cfg(False)["diffusion"]
    jd = jdiff.GaussianDiffusion(**{k: v for k, v in cfg.items() if k != "type"})
    ref = jd.apply({}, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                   method=jd.q_sample)
    td = tdiff.GaussianDiffusion(**{k: v for k, v in cfg.items() if k != "type"})
    got = td.q_sample(torch.from_numpy(x0), torch.from_numpy(t).long(),
                      torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_unported_samplers_raise():
    """An unknown sampler raises; PLMS, naive and shallow diffusion (ported
    since) give finite mels of the input's shape."""
    cfg = diffsinger_cfg(False)["diffusion"]
    td = tdiff.GaussianDiffusion(**{k: v for k, v in cfg.items() if k != "type"})
    feats = torch.zeros(1, 4, 16)
    with pytest.raises(NotImplementedError, match="unknown noise predictor"):
        td(feats, noise_predictor="ddim")
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for kwargs in (dict(noise_predictor="plms"), dict(noise_predictor="naive"),
                       dict(skip_steps=10, original_mel=torch.zeros(1, 4, 8))):
            mel = td(feats, generator=gen, **kwargs)
            assert mel.shape == (1, 4, 8) and torch.isfinite(mel).all()
