"""PyTorch port vs the JAX package: RefineGAN vocoder training (GAN flavor v2).

- three full v2 GAN steps (MPD + MRD, averaged LSGAN, 45 x mel smoothed-L1
  and the envelope; ``make_gan_train_step`` through the JAX
  ``VocoderTrainer``) against the port's, from the same weights, batches
  and draws: every loss <= 1e-3 relative, every parameter within
  2 * lr * steps (AdamW with eps = 1e-9 makes a first update about
  lr * sign(g), so a gradient near zero may take the other sign). The JAX
  generator's draws are injected in call order: the template's noise, then
  the AdaINs' in module order; the JAX step runs its generator twice (D and
  G phase) with one key, so the order repeats;
- the port's ``VocoderTrainer`` builds RefineGAN from a config and the CLI
  trains it for two steps on the CPU.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.config.config import Config as JConfig
from fish_diffusion_tpu_torch.config.config import Config
from fish_diffusion_tpu_torch.convert import discriminators_from_jax, refinegan_from_jax
from fish_diffusion_tpu_torch.models.vocoders.refinegan import RefineGANGenerator
from fish_diffusion_tpu_torch.training.vocoder_trainer import VocoderTrainer

HOP, SEG, SR = 16, 2048, 8000
MRD = ((64, 8, 32), (128, 16, 64))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config(**trainer):
    return dict(
        model=dict(
            type="RefineGAN",
            generator=dict(type="RefineGAN", sampling_rate=SR, hop_length=HOP,
                           downsample_rates=(2, 2, 2, 2), upsample_rates=(2, 2, 2, 2),
                           num_mels=16, start_channels=4),
            mpd=dict(periods=(2, 3), channels=(1, 8, 16, 16, 32, 32)),
            mrd=dict(resolutions=MRD),
            multi_scale_mels=[(256, 16, 256), (128, 32, 64)],
        ),
        optimizer=dict(type="AdamW", lr=2e-4, betas=(0.8, 0.99), eps=1e-9),
        scheduler=dict(type="ExponentialLR", base_lr=1.0, gamma=0.5, interval="epoch"),
        trainer=dict(precision="32-true", discriminator_dtype="float32", **trainer),
    )


def batches(n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f0 = rng.uniform(110, 440, (batch, SEG // HOP))
        f0[:, 40:50] = 0.0  # an unvoiced stretch
        phase = 2 * np.pi * np.cumsum(np.repeat(f0, HOP, axis=1), axis=1) / SR
        audio = 0.4 * np.sin(phase) + 0.02 * rng.standard_normal((batch, SEG))
        out.append({"audio": audio.astype(np.float32),
                    "pitches": np.repeat(f0, HOP, axis=1).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Three steps of the JAX trainer's compiled v2 step (float32, one
    compile) from its own initial state, with the generator's draws
    injected in call order; returns the initial and final parameters, the
    metrics, the batches and the draws."""
    from fish_diffusion_tpu.parallel import make_mesh
    from fish_diffusion_tpu.parallel.distributed import make_global_batch
    from fish_diffusion_tpu.training.vocoder_trainer import VocoderTrainer as JTrainer
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(axis_shapes=(1,), axis_names=("data",), devices=jax.devices()[:1])
    trainer = JTrainer(JConfig(**tiny_config()), log_dir=str(tmp_path_factory.mktemp("j")),
                       mesh=mesh, steps_per_epoch=1)
    assert trainer.discs.flavor == "v2"
    data = batches(3)
    # committed to the mesh as the step returns it, so that the step
    # compiles once (an uncommitted first state traces it a second time)
    state = jax.device_put(trainer.init_state(data[0], seed=3), NamedSharding(mesh, P()))
    init = jax.tree_util.tree_map(np.array, (state.params_g, state.params_d))

    rng = np.random.default_rng(17)
    shapes = RefineGANGenerator(**{k: v for k, v in tiny_config()["model"]["generator"].items()
                                   if k != "type"}).noise_shapes(2, SEG // HOP)
    draws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    calls = []

    def in_order(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        calls.append(tuple(shape))
        return jnp.asarray(draws[(len(calls) - 1) % len(draws)].reshape(shape))

    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", in_order)
        for batch in data:
            sb = make_global_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
            state, m = trainer._train_step(state, sb, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
    # traced once: the D phase's generator call, then the G phase's
    assert len(calls) == 2 * len(draws)
    final = jax.tree_util.tree_map(np.array, (state.params_g, state.params_d))
    return init, final, metrics, data, [torch.from_numpy(d) for d in draws]


def test_three_v2_gan_steps_match_jax(jax_run, tmp_path):
    (params_g, params_d), (final_g, final_d), ref, data, draws = jax_run
    trainer = VocoderTrainer(Config(**tiny_config()), log_dir=str(tmp_path),
                             steps_per_epoch=1, device="cpu")
    assert trainer.discs.flavor == "v2" and trainer.hop_length == HOP
    state = trainer.init_state(seed=0)
    state.params_g.load_state_dict(refinegan_from_jax(params_g))
    sd, spectral = discriminators_from_jax(params_d, {}, resolutions=MRD)
    state.params_d.load_state_dict(sd)
    assert spectral == {} and state.spectral_d == {}

    for step, batch in enumerate(data):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, metrics = trainer._train_step(state, batch, draws)
        assert set(metrics) == set(ref[step])
        for key, want in ref[step].items():
            if key.startswith("loss"):
                got = float(metrics[key])
                assert abs(got - want) <= 1e-3 * abs(want), (step, key, got, want)
    assert state.step == 3 and state.opt_state_g.count == 3

    lr, steps = 2e-4, 3
    want_g = refinegan_from_jax(final_g)
    want_d, _ = discriminators_from_jax(final_d, {}, resolutions=MRD)
    for got, want in ((state.params_g.state_dict(), want_g),
                      (state.params_d.state_dict(), want_d)):
        assert set(got) == set(want)
        for k in want:
            err = (got[k] - want[k]).abs().max().item()
            assert err <= 2 * lr * steps, (k, err)


def test_cli_trains_refinegan_on_the_cpu(tmp_path):
    """``vocoder_cli`` on a tiny RefineGAN config and a synthetic dataset:
    two steps of the v2 step, a validation, a checkpoint."""
    from fish_diffusion_tpu_torch.training import vocoder_cli

    rng = np.random.default_rng(4)
    for split, n in (("train", 4), ("valid", 2)):
        (tmp_path / split).mkdir()
        for i in range(n):
            np.save(tmp_path / split / f"{i}.npy", {
                "path": f"{i}.wav", "audio": (0.3 * rng.standard_normal(3000)).astype(np.float32),
                "pitches": rng.uniform(100, 300, 3000 // HOP + 1).astype(np.float32),
                "sampling_rate": SR})
    cfg = tiny_config(max_steps=2)
    cfg["trainer"]["precision"] = "bf16-mixed"  # the CLI sets float32
    cfg["dataset"] = dict(
        train=dict(type="NaiveVOCODERDataset", path=str(tmp_path / "train"),
                   segment_size=SEG, sampling_rate=SR, hop_length=HOP),
        valid=dict(type="NaiveVOCODERDataset", path=str(tmp_path / "valid"),
                   segment_size=None, sampling_rate=SR, hop_length=HOP))
    cfg["dataloader"] = dict(train=dict(batch_size=2, shuffle=True, num_workers=0),
                             valid=dict(batch_size=2, shuffle=False, num_workers=0))
    path = tmp_path / "config.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    state = vocoder_cli.main(["--config", str(path), "--log-dir", str(tmp_path / "logs"),
                              "--device", "cpu"])
    assert state.step == 2 and state.params_d.flavor == "v2"
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert any("valid_mel_l1" in r and np.isfinite(r["valid_mel_l1"]) for r in rows)
    assert Path(tmp_path / "logs" / "checkpoints" / "2.pt").exists()
