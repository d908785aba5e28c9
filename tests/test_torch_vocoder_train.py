"""PyTorch port vs the JAX package: NSF-HiFiGAN vocoder training.

- three full v1 GAN steps (``make_gan_train_step`` through the JAX
  ``VocoderTrainer``) against the port's, from the same weights, batches
  and draws: every loss <= 1e-3 relative, every parameter within
  2 * lr * steps (AdamW with eps = 1e-9 makes a first update about
  lr * sign(g), so a gradient near zero may take the other sign);
- AdamW with the per-epoch exponential schedule against optax;
- ``NaiveVOCODERDataset`` against the JAX one;
- the port's ``VocoderTrainer.fit`` (validation, metrics, checkpoints,
  resume, the stale-step rule, the float32-only rule) and the CLI, on the
  CPU at tiny dims.
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
from fish_diffusion_tpu_torch.convert import discriminators_from_jax, nsf_hifigan_from_jax
from fish_diffusion_tpu_torch.training.vocoder_trainer import VocoderTrainer

HOP, SEG = 16, 2048


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config(**trainer):
    return dict(
        model=dict(
            type="NSFHiFiGAN",
            generator=dict(type="NsfHifiGAN", num_mels=16, sampling_rate=8000,
                           hop_size=HOP, upsample_rates=(4, 4),
                           upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
                           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)),
            mpd=dict(periods=(2, 3), channels=(1, 8, 16, 16, 32, 32)),
            multi_scale_mels=[(256, 16, 256)],
        ),
        optimizer=dict(type="AdamW", lr=2e-4, betas=(0.8, 0.99), eps=1e-9),
        # gamma 0.5 per one-step epoch: the schedule's count convention shows
        scheduler=dict(type="ExponentialLR", base_lr=1.0, gamma=0.5, interval="epoch"),
        trainer=dict(precision="32-true", discriminator_dtype="float32", **trainer),
    )


def batches(n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f0 = rng.uniform(110, 440, (batch, SEG // HOP))
        phase = 2 * np.pi * np.cumsum(np.repeat(f0, HOP, axis=1), axis=1) / 8000
        audio = 0.4 * np.sin(phase) + 0.02 * rng.standard_normal((batch, SEG))
        out.append({"audio": audio.astype(np.float32),
                    "pitches": np.repeat(f0, HOP, axis=1).astype(np.float32)})
    return out


# ---------------------------------------------------------------------------
# three GAN steps against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Three steps of the JAX trainer's compiled step (float32 throughout,
    one compile) from its own initial state, with the generator's draws
    injected by shape; returns the initial and final states, the metrics,
    the batches and the draws."""
    from fish_diffusion_tpu.parallel import make_mesh
    from fish_diffusion_tpu.parallel.distributed import make_global_batch
    from fish_diffusion_tpu.training.vocoder_trainer import VocoderTrainer as JTrainer

    mesh = make_mesh(axis_shapes=(1,), axis_names=("data",), devices=jax.devices()[:1])
    trainer = JTrainer(JConfig(**tiny_config()), log_dir=str(tmp_path_factory.mktemp("j")),
                       mesh=mesh, steps_per_epoch=1)
    data = batches(3)
    state = trainer.init_state(data[0], seed=3)
    init = jax.tree_util.tree_map(np.array, (state.params_g, state.params_d, state.spectral_d))

    rng = np.random.default_rng(17)
    B, T = 2, SEG // HOP
    rand_ini = rng.uniform(size=(B, 9)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    noise = rng.standard_normal((B, T, HOP, 9)).astype(np.float32)
    extra = rng.standard_normal((B, T * HOP, 1)).astype(np.float32)
    by_shape = {(B, 9): rand_ini, (B, T, HOP, 9): noise, (B, T * HOP, 1): extra}

    def lookup(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(by_shape[tuple(shape)])

    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lookup)
        mp.setattr(jax.random, "normal", lookup)
        for batch in data:
            sb = make_global_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
            state, m = trainer._train_step(state, sb, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree_util.tree_map(np.array, (state.params_g, state.params_d))
    draws = (torch.from_numpy(rand_ini), torch.from_numpy(noise.reshape(B, T * HOP, 9)))
    return init, final, metrics, data, draws


def test_three_gan_steps_match_jax(jax_run, tmp_path):
    (params_g, params_d, spectral_d), (final_g, final_d), ref, data, draws = jax_run
    trainer = VocoderTrainer(Config(**tiny_config()), log_dir=str(tmp_path),
                             steps_per_epoch=1, device="cpu")
    state = trainer.init_state(seed=0)
    state.params_g.load_state_dict(nsf_hifigan_from_jax(params_g))
    sd, spectral = discriminators_from_jax(params_d, spectral_d)
    state.params_d.load_state_dict(sd)
    state.spectral_d = spectral

    for step, batch in enumerate(data):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, metrics = trainer._train_step(state, batch, draws)
        for key, want in ref[step].items():
            if key.startswith("loss"):
                got = float(metrics[key])
                assert abs(got - want) <= 1e-3 * abs(want), (step, key, got, want)
    assert state.step == 3 and state.opt_state_g.count == 3

    lr, steps = 2e-4, 3
    want_g = nsf_hifigan_from_jax(final_g)
    want_d, _ = discriminators_from_jax(final_d, spectral_d)
    for got, want in ((state.params_g.state_dict(), want_g),
                      (state.params_d.state_dict(), want_d)):
        assert set(got) == set(want)
        for k in want:
            err = (got[k] - want[k]).abs().max().item()
            assert err <= 2 * lr * steps, (k, err)


def test_scheduled_adamw_matches_optax():
    """AdamW(0.0002, (0.8, 0.99), eps 1e-9, weight decay 1e-2) with
    ExponentialLR(0.5) per epoch of 2 steps: the learning rate is evaluated
    at the update count (0 first), as optax does. Five updates agree to a
    few float32 roundings (1e-6 relative)."""
    from fish_diffusion_tpu.training.optim import build_optimizer as jbuild
    from fish_diffusion_tpu_torch.training.optim import build_optimizer

    opt_cfg = dict(type="AdamW", lr=2e-4, betas=(0.8, 0.99), eps=1e-9)
    sched = dict(type="ExponentialLR", base_lr=1.0, gamma=0.5, interval="epoch")
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(7).astype(np.float32)
    grads = [rng.standard_normal(7).astype(np.float32) for _ in range(5)]

    tx = jbuild(opt_cfg, sched, steps_per_epoch=2)
    jp = jnp.asarray(p0)
    jstate = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer(opt_cfg, sched, steps_per_epoch=2)([p])
    lrs = []
    for g in grads:
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = jp + upd
        lrs.append(opt.lr)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    assert lrs == [2e-4, 2e-4, 1e-4, 1e-4, 5e-5]
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=0, rtol=1e-6)


def test_vocoder_dataset_matches_jax(tmp_path):
    """The same clip with the same ``np.random`` state: identical crop,
    pitch shift and loudness shift, and identical collation."""
    from fish_diffusion_tpu.datasets.naive import NaiveVOCODERDataset as JDataset
    from fish_diffusion_tpu_torch.datasets import NaiveVOCODERDataset

    rng = np.random.default_rng(2)
    for i in range(2):
        np.save(tmp_path / f"{i}.npy", {
            "path": f"{i}.wav", "audio": rng.standard_normal(9000).astype(np.float32),
            "pitches": rng.uniform(100, 300, 9000 // 512 + 1).astype(np.float32),
            "sampling_rate": 44100})
    kw = dict(path=str(tmp_path), segment_size=4096, pitch_shift=[-12, 12],
              loudness_shift=[0.1, 0.9])
    got_ds, ref_ds = NaiveVOCODERDataset(**kw), JDataset(**kw)
    np.random.seed(5)
    got = got_ds.collate_fn([got_ds[0], got_ds[1]])
    np.random.seed(5)
    ref = ref_ds.collate_fn([ref_ds[0], ref_ds[1]])
    assert set(got) == set(ref)
    for k in ("audio", "pitches", "audio_lens"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["audio"].shape == (2, 1, 4096)


# ---------------------------------------------------------------------------
# the port's trainer and CLI
# ---------------------------------------------------------------------------


def test_fit_validates_logs_and_saves(tmp_path):
    """Validation at the periodic step and the last; metrics rows at the
    log interval with the JAX keys; checkpoints at the save interval and
    the last; the validation audio as wav files."""
    trainer = VocoderTrainer(Config(**tiny_config()), log_dir=str(tmp_path),
                             steps_per_epoch=2, device="cpu")
    val_steps = []
    validate = trainer.validate
    trainer.validate = lambda state, loader, step: (val_steps.append(step),
                                                    validate(state, loader, step))[1]
    state = trainer.fit(batches(2), max_steps=5, valid_loader=batches(1, seed=1),
                        valid_every=4, log_every=2, save_every=4)
    assert state.step == 5 and val_steps == [4, 5]
    assert trainer.ckpt.all_steps() == [4, 5]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if "loss_g" in r]
    assert [r["step"] for r in train] == [2, 4]
    keys = {"loss_d", "loss_g", "loss_mel", "loss_env", "loss_adv", "loss_fm",
            "loss_stft", "d_score_real", "d_score_fake", "steps_per_sec"}
    assert all(keys <= set(r) and np.isfinite(r["loss_g"]) for r in train)
    assert [r["step"] for r in rows if "valid_mel_l1" in r] == [4, 5]
    assert (tmp_path / "val_pred_5.wav").exists() and (tmp_path / "val_gt_5.wav").exists()


def test_resume_restores_parameters_optimizers_and_step(tmp_path):
    cfg = Config(**tiny_config())
    first = VocoderTrainer(cfg, log_dir=str(tmp_path), steps_per_epoch=2, device="cpu")
    saved = first.fit(batches(2), max_steps=2, save_every=2)
    params = {k: v.clone() for k, v in saved.params_g.state_dict().items()}
    spectral = {k: v.clone() for k, v in saved.spectral_d.items()}

    second = VocoderTrainer(cfg, log_dir=str(tmp_path), steps_per_epoch=2, device="cpu")
    state = second.ckpt.restore(second.init_state(seed=123))
    assert state.step == 2 and state.opt_state_g.count == state.opt_state_d.count == 2
    for k, v in state.params_g.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, v in state.spectral_d.items():
        assert torch.equal(v, spectral[k]), k
    assert second.fit(batches(2), max_steps=3, resume=True).step == 3


def test_stale_checkpoint_of_a_previous_run_is_overwritten(tmp_path):
    """A step that a previous run left in the directory is replaced when
    this run saves it, never kept."""
    cfg = Config(**tiny_config())
    VocoderTrainer(cfg, log_dir=str(tmp_path), steps_per_epoch=1, device="cpu").fit(
        batches(1), max_steps=1, seed=1)
    trainer = VocoderTrainer(cfg, log_dir=str(tmp_path), steps_per_epoch=1, device="cpu")
    state = trainer.fit(batches(1), max_steps=1, seed=2)
    restored = trainer.ckpt.restore(VocoderTrainer(
        cfg, log_dir=str(tmp_path), steps_per_epoch=1, device="cpu").init_state(seed=9))
    for k, v in restored.params_g.state_dict().items():
        assert torch.equal(v, state.params_g.state_dict()[k]), k


def test_trainer_is_float32_only_and_runs_on_the_card_by_default(tmp_path):
    cfg = tiny_config()
    cfg["trainer"]["precision"] = "bf16-mixed"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VocoderTrainer(Config(**cfg), log_dir=str(tmp_path), steps_per_epoch=1,
                       device="cpu")
    cfg = tiny_config()
    cfg["trainer"]["discriminator_dtype"] = "bfloat16"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VocoderTrainer(Config(**cfg), log_dir=str(tmp_path), steps_per_epoch=1,
                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VocoderTrainer(Config(**tiny_config()), log_dir=str(tmp_path),
                           steps_per_epoch=1)


def test_fit_on_an_empty_loader_returns_none(tmp_path):
    trainer = VocoderTrainer(Config(**tiny_config()), log_dir=str(tmp_path),
                             steps_per_epoch=1, device="cpu")
    assert trainer.fit([], max_steps=3) is None


def test_cli_trains_on_the_cpu(tmp_path):
    """``vocoder_cli`` on a tiny config and a synthetic dataset: two steps,
    a validation, a checkpoint."""
    from fish_diffusion_tpu_torch.training import vocoder_cli

    rng = np.random.default_rng(4)
    for split, n in (("train", 4), ("valid", 2)):
        (tmp_path / split).mkdir()
        for i in range(n):
            np.save(tmp_path / split / f"{i}.npy", {
                "path": f"{i}.wav", "audio": (0.3 * rng.standard_normal(3000)).astype(np.float32),
                "pitches": rng.uniform(100, 300, 3000 // HOP + 1).astype(np.float32),
                "sampling_rate": 8000})
    cfg = tiny_config(max_steps=2)
    cfg["trainer"]["precision"] = "bf16-mixed"  # the CLI sets float32
    cfg["dataset"] = dict(
        train=dict(type="NaiveVOCODERDataset", path=str(tmp_path / "train"),
                   segment_size=SEG, sampling_rate=8000, hop_length=HOP),
        valid=dict(type="NaiveVOCODERDataset", path=str(tmp_path / "valid"),
                   segment_size=None, sampling_rate=8000, hop_length=HOP))
    cfg["dataloader"] = dict(train=dict(batch_size=2, shuffle=True, num_workers=0),
                             valid=dict(batch_size=2, shuffle=False, num_workers=0))
    path = tmp_path / "config.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    state = vocoder_cli.main(["--config", str(path), "--log-dir", str(tmp_path / "logs"),
                              "--device", "cpu"])
    assert state.step == 2
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert any("valid_mel_l1" in r and np.isfinite(r["valid_mel_l1"]) for r in rows)
    assert Path(tmp_path / "logs" / "checkpoints" / "2.pt").exists()
