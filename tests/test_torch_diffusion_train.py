"""PyTorch port vs the JAX package: the diffusion training step of DiffSVC.

- the loss of ``DiffSinger.forward`` (``GaussianDiffusion.train_step``) and
  every parameter's gradient against ``jax.value_and_grad`` of the JAX
  ``DiffSinger.__call__``, on ``__graft_entry__``'s tiny DiffSVC (R 64, 4
  layers) and on a DiffSVC with the ConvNeXt denoiser (dim 32, 5 blocks,
  dilations 1, 2, 4, 8, 1) with padded items, t and the noise injected
  into both: loss within 1e-5 relative, each gradient within 1e-4
  relative L2;
- ``mel_loss`` of every kind against the JAX ``mel_loss``;
- three steps of the port's ``make_train_step`` against the JAX
  ``make_train_step`` (warmup-cosine AdamW, clip 0.5, EMA 0.9), for both
  denoisers: loss and
  ``grad_norm`` within 1e-3 relative, parameters and EMA within
  2 * lr * steps (AdamW with eps = 1e-9 makes a first update about
  lr * sign(g));
- the schedules, the clip and the accumulation against optax.

The JAX value-and-grad and train step compile once each.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _model_and_batch
from fish_diffusion_tpu.models import build_model as j_build_model
from fish_diffusion_tpu.models.diffusion import mel_loss as j_mel_loss
from fish_diffusion_tpu.training import optim as j_optim
from fish_diffusion_tpu.training.state import TrainState as JTrainState
from fish_diffusion_tpu.training.state import make_train_step as j_make_train_step
from fish_diffusion_tpu_torch.convert import diffsinger_from_jax
from fish_diffusion_tpu_torch.models import build_model
from fish_diffusion_tpu_torch.models.diffusion import mel_loss
from fish_diffusion_tpu_torch.training import optim
from fish_diffusion_tpu_torch.training.diffusion_state import (create_train_state,
                                                               make_train_step)
from tests.test_torch_wavenet import randomize

OPTIMIZER = dict(type="AdamW", lr=1.0, weight_decay=1e-2, betas=(0.9, 0.98), eps=1e-9)
SCHEDULER = dict(type="LambdaLR", lr_lambda=dict(
    type="LambdaWarmUpCosineScheduler", warm_up_steps=1000, val_final=2e-5, val_base=8e-4,
    val_start=1e-5, max_decay_steps=300000))  # configs/_base_/schedulers/warmup_cosine.py
EMA, CLIP, STEPS = 0.9, 0.5, 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The tiny JAX DiffSVC with seeded random parameters, a batch whose
    second item is padded (mel_lens 128, 90), and t and the noise that both
    packages are given."""
    jmodel, batch = _model_and_batch(tiny=True)
    lens = jnp.asarray([128, 90], jnp.int32)
    batch = {**batch, "mel_lens": lens, "contents_lens": lens}
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)}, **batch)
    params = randomize(variables["params"], 5)
    rng = np.random.default_rng(9)
    t = np.array([731, 42], np.int32)
    noise = rng.standard_normal(batch["mel"].shape).astype(np.float32)
    # JAX build_model(training=True) adds a lowering flag that is not a config key
    denoiser = {k: v for k, v in jmodel.diffusion["denoiser"].items()
                if k != "static_dilation_shifts"}
    cfg = dict(type="DiffSVC", text_encoder=dict(jmodel.text_encoder),
               diffusion={**jmodel.diffusion, "denoiser": denoiser},
               speaker_encoder=dict(jmodel.speaker_encoder),
               pitch_encoder=dict(jmodel.pitch_encoder))
    return jmodel, batch, params, t, noise, cfg


@pytest.fixture(scope="module")
def convnext_setup():
    """The JAX DiffSVC with the ConvNeXt denoiser (dim 32, 5 blocks: dilations
    1, 2, 4, 8, 1; ``build_model(training=True)``'s static dilation shifts),
    seeded random parameters, a batch whose second item is padded (mel_lens
    128, 90), t and the noise."""
    hidden, B, T = 32, 2, 128
    denoiser = dict(type="ConvNextDenoiser", mel_channels=128, dim=32, mlp_factor=2,
                    condition_dim=hidden, num_layers=5, dilation_cycle=4)
    cfg = dict(
        type="DiffSVC",
        diffusion=dict(type="GaussianDiffusion", mel_channels=128, noise_schedule="linear",
                       timesteps=1000, noise_loss="smoothed-l1", denoiser=denoiser,
                       sampler_interval=10, spec_min=[-5], spec_max=[0]),
        text_encoder=dict(type="NaiveProjectionEncoder", input_size=256, output_size=hidden),
        speaker_encoder=dict(type="NaiveProjectionEncoder", input_size=10, output_size=hidden,
                             use_embedding=True),
        pitch_encoder=dict(type="NaiveProjectionEncoder", input_size=1, output_size=hidden,
                           use_embedding=False, preprocessing="pitch_to_scale"),
    )
    jmodel = j_build_model(cfg, training=True)
    assert jmodel.diffusion["denoiser"]["static_dilation_shifts"]
    rng = np.random.default_rng(12)
    lens = jnp.asarray([T, 90], jnp.int32)
    batch = {
        "speakers": jnp.asarray([0, 3], jnp.int32),
        "contents": jnp.asarray(rng.standard_normal((B, T, 256)), jnp.float32),
        "contents_lens": lens,
        "mel": jnp.asarray(rng.uniform(-4, 0, (B, T, 128)), jnp.float32),
        "mel_lens": lens,
        "pitches": jnp.asarray(rng.uniform(80, 600, (B, T)), jnp.float32),
    }
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)}, **batch)
    params = randomize(variables["params"], 6)
    t = np.array([650, 17], np.int32)
    noise = rng.standard_normal((B, T, 128)).astype(np.float32)
    return jmodel, batch, params, t, noise, cfg


@contextlib.contextmanager
def injected(t, noise):
    """``jax.random.randint`` / ``normal`` replaced by the given draws at
    their shapes (other draws untouched)."""
    randint, normal = jax.random.randint, jax.random.normal

    def fixed_randint(key, shape, *args, **kwargs):
        return jnp.asarray(t) if tuple(shape) == t.shape else randint(key, shape, *args, **kwargs)

    def fixed_normal(key, shape=(), *args, **kwargs):
        return jnp.asarray(noise) if tuple(shape) == noise.shape else normal(key, shape, *args,
                                                                           **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", fixed_randint)
        mp.setattr(jax.random, "normal", fixed_normal)
        yield


def port_model(cfg, params, noise_loss=None):
    cfg = dict(cfg)
    if noise_loss is not None:
        cfg["diffusion"] = {**cfg["diffusion"], "noise_loss": noise_loss}
    model = build_model(cfg)
    model.load_state_dict(diffsinger_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if np.asarray(v).dtype.kind == "i"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def check_loss_and_gradients(setup):
    """The loss <= 1e-5 relative and each parameter's gradient <= 1e-4
    relative L2 of ``jax.value_and_grad`` (one compile)."""
    jmodel, batch, params, t, noise, cfg = setup

    def loss_fn(p):
        return jmodel.apply({"params": p}, **batch, rngs={"diffusion": jax.random.PRNGKey(3)})[
            "loss"]

    with injected(t, noise):
        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want_grads = diffsinger_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    model = port_model(cfg, params)
    out = model(**torch_batch(batch), t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    out["loss"].backward()
    loss = float(out["loss"].detach())
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want)), (loss, float(want))
    assert (out["epsilon"][1, 90:] == 0).all() and (out["noised_mels"][1, 90:] == 0).all()
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, g in want_grads.items():
        err = float((got[name].grad - g).norm() / g.norm())
        assert err <= 1e-4, (name, err)


def test_loss_and_gradients_match_jax(setup):
    """The config's smoothed-l1 loss and every gradient (the masked items'
    padding included): loss <= 1e-5 relative, each parameter's gradient
    <= 1e-4 relative L2."""
    check_loss_and_gradients(setup)


def test_convnext_loss_and_gradients_match_jax(convnext_setup):
    """The same with the ConvNeXt denoiser (K10's forward and backward run
    their plain versions on the CPU): every block's gradient, the depthwise
    taps and the norms included, <= 1e-4 relative L2, the loss <= 1e-5."""
    check_loss_and_gradients(convnext_setup)


@pytest.mark.parametrize("kind", ["l1", "smoothed-l1", "l2", "weighted", "callable"])
def test_mel_loss_matches_jax(kind):
    """Every ``noise_loss`` on the same masked noise and prediction:
    <= 1e-6 relative."""
    rng = np.random.default_rng(1)
    noise, eps = (rng.standard_normal((2, 16, 8)).astype(np.float32) * 2 for _ in range(2))
    noise[1, 10:] = eps[1, 10:] = 0.0
    spec = {"weighted": [(0.3, "l1"), (0.7, "smoothed-l1")]}.get(kind, kind)
    j_spec, t_spec = spec, spec
    if kind == "callable":
        j_spec = lambda n, e: jnp.mean(jnp.abs(n - e) ** 3)  # noqa: E731
        t_spec = lambda n, e: torch.mean(torch.abs(n - e) ** 3)  # noqa: E731
    want = float(j_mel_loss(j_spec, jnp.asarray(noise), jnp.asarray(eps)))
    got = float(mel_loss(t_spec, torch.from_numpy(noise), torch.from_numpy(eps)))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def check_three_steps(setup, clip):
    """Three steps of the JAX ``make_train_step`` (one compile) and of the
    port's from the same parameters on the same batch and draws: loss and
    ``grad_norm`` <= 1e-3 relative, parameters and EMA within
    2 * lr * steps."""
    jmodel, batch, params, t, noise, cfg = setup
    tx = j_optim.build_optimizer(OPTIMIZER, SCHEDULER, grad_clip_val=clip)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params),
                         ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jstep = j_make_train_step(jmodel, tx, EMA, donate=False)
    ref = []
    with injected(t, noise):
        for _ in range(STEPS):
            jstate, m = jstep(jstate, batch, jax.random.PRNGKey(0))
            ref.append({k: float(v) for k, v in m.items()})

    model = port_model(cfg, params)
    state = create_train_state(
        model, optim.build_optimizer(OPTIMIZER, SCHEDULER, grad_clip_val=clip), EMA)
    step = make_train_step(EMA)
    tb = torch_batch(batch)
    for i in range(STEPS):
        state, m = step(state, tb, t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - ref[i][key]) <= 1e-3 * abs(ref[i][key]), (i, key)
    assert state.step == STEPS and state.optimizer.count == STEPS

    lr = max(state.optimizer.schedule(c) for c in range(STEPS))
    for got, want in ((state.model, jstate.params), (state.ema, jstate.ema_params)):
        want = diffsinger_from_jax(jax.tree_util.tree_map(np.asarray, want))
        for name, p in got.state_dict().items():
            err = float((p - want[name]).abs().max())
            assert err <= 2 * lr * STEPS, (name, err)
    return ref


@pytest.mark.parametrize("clip", [CLIP, 0.05])
def test_three_steps_match_jax(setup, clip):
    """Three steps from the same parameters on the same batch and draws:
    warmup-cosine AdamW, EMA 0.9, and the clip of the configs (0.5, above
    this model's gradient norm) or one that the norm exceeds (0.05)."""
    ref = check_three_steps(setup, clip)
    assert (ref[0]["grad_norm"] > 2 * clip) == (clip < CLIP)


def test_convnext_three_steps_match_jax(convnext_setup):
    """Three steps of the ConvNeXt DiffSVC at the configs' clip (0.5)
    against the JAX step, with the WaveNet case's tolerances."""
    check_three_steps(convnext_setup, CLIP)


@pytest.mark.parametrize("name,kwargs", [
    ("LambdaWarmUpCosineScheduler", SCHEDULER["lr_lambda"]),
    ("LambdaCosineScheduler", dict(lr_min=1e-5, lr_max=1e-3, max_decay_steps=200000)),
    ("StepLR", dict(step_size=1000, gamma=0.5)),
])
def test_schedules_match_jax(name, kwargs):
    """The port's schedules against the JAX package's (optax, float32) at
    update counts 0, 1, 999, 1000, 150000 and 300000: <= 1e-6 relative."""
    kwargs = {k: v for k, v in kwargs.items() if k != "type"}
    got = optim.LR_SCHEDULERS.build({"type": name, **kwargs})
    want = j_optim.LR_SCHEDULERS.build({"type": name, **kwargs})
    for count in (0, 1, 999, 1000, 150000, 300000):
        a, b = got(count), float(want(count))
        assert abs(a - b) <= 1e-6 * abs(b) + 1e-12, (count, a, b)


def test_build_lr_schedule_lambda_lr_matches_jax():
    """``LambdaLR`` around the warmup-cosine factor, base lr 1.0."""
    got = optim.build_lr_schedule(SCHEDULER, 1.0)
    want = j_optim.build_lr_schedule(SCHEDULER, 1.0)
    for count in (0, 1, 999, 1000, 150000, 300000):
        assert abs(got(count) - float(want(count))) <= 1e-6 * float(want(count))


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("kind", ["AdamW", "SGD"])
def test_optimizer_with_clip_and_accumulation_matches_optax(kind, accumulate):
    """``build_optimizer`` with clip 0.5 and ``accumulate_grad_batches``
    against the JAX chain (``optax.MultiSteps`` around clip and the
    optimizer) on a small tree over 6 gradient draws: parameters <= 1e-6,
    the schedule counting updates."""
    cfg = (dict(type="AdamW", lr=1e-2, weight_decay=1e-2, betas=(0.9, 0.98), eps=1e-9)
           if kind == "AdamW" else dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=1e-3))
    sched = dict(type="StepLR", step_size=2, gamma=0.5)
    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in init.items()}
             for s in (2.0, 0.01, 1.0, 3.0, 0.05, 1.5)]

    tx = j_optim.build_optimizer(cfg, sched, grad_clip_val=CLIP,
                                 accumulate_grad_batches=accumulate)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = optim.build_optimizer(cfg, sched, grad_clip_val=CLIP,
                                accumulate_grad_batches=accumulate)(list(params.values()))
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == len(grads) // accumulate
    for k, p in params.items():
        assert float((p.detach() - torch.from_numpy(np.array(jparams[k]))).abs().max()) <= 1e-6


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """No epsilon: below the limit the gradients are unchanged, above it
    they are g / norm * max exactly as optax computes them."""
    rng = np.random.default_rng(int(scale))
    tree = [(rng.standard_normal(s) * scale).astype(np.float32) for s in ((5, 3), (7,))]
    want, _ = optax.clip_by_global_norm(CLIP).update([jnp.asarray(a) for a in tree], None)
    got = [torch.from_numpy(a.copy()) for a in tree]
    norm = optim.clip_by_global_norm_(got, CLIP)
    assert abs(float(norm) - float(optax.global_norm([jnp.asarray(a) for a in tree]))) <= 1e-6 * \
        float(norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
