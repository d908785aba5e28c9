"""The port's diffusion training around the step, on the CPU at tiny dims:

- ``NaiveSVCDataset`` and ``NaiveDenoiserDataset`` with their collates,
  and ``ConcatDataset``, against the JAX package's on the same ``.npy``
  dicts (keys, shapes, dtypes, values, padding to a bucket of 128 frames);
- the ConvNeXt DiffSVC (``configs/denoiser_cn_hubert.py``'s model) at tiny
  dims: ``fit`` and ``--resume`` over ``NaiveSVCDataset`` items,
  ``--pretrained`` from a pickle of the JAX package's parameters, and the
  config's own ``NaiveDenoiserDataset`` batches, which carry no pitches:
  the JAX model fails on them with a ``TypeError``, the port raises a
  ``ValueError`` that says why;
- ``DiffusionTrainer.fit`` (validation with samples and vocoded audio,
  checkpoints, ``metrics.jsonl``), the CLI's ``--resume``, ``--pretrained``
  (the same skips as the JAX ``load_pretrained_params``) and
  ``--only-train-speaker-embeddings`` (every other parameter bit-equal);
- the JAX CLI's ``optax.masked`` freeze, which passes a frozen leaf's
  gradient through as its update (a fault the port does not copy);
- what the trainer does not port raises.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fish_diffusion_tpu.datasets import naive as j_naive
from fish_diffusion_tpu.datasets import wrappers as j_wrappers
from fish_diffusion_tpu.models import build_model as j_build_model
from fish_diffusion_tpu.training.checkpoint import (
    load_pretrained_params as j_load_pretrained_params,
)
from fish_diffusion_tpu_torch.config import Config
from fish_diffusion_tpu_torch.convert import diffsinger_from_jax
from fish_diffusion_tpu_torch.datasets import (ConcatDataset, NaiveDenoiserDataset,
                                               NaiveSVCDataset)
from fish_diffusion_tpu_torch.models import build_model
from fish_diffusion_tpu_torch.training import diffusion_cli
from fish_diffusion_tpu_torch.training.diffusion_checkpoint import load_pretrained_params
from fish_diffusion_tpu_torch.training.diffusion_state import batch_to_device, model_kwargs
from fish_diffusion_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from tests.test_torch_wavenet import randomize


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_items(root: Path, lengths, seed=0):
    """SVC ``.npy`` dicts (the preprocessing contract): mel [128, T] in
    [-5, 0], contents [256, T], pitches [T], key_shift, time_stretch."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i, T in enumerate(lengths):
        np.save(root / f"{i}.npy", {
            "path": f"{i}.wav", "time_stretch": 1.0, "key_shift": float(i % 3 - 1),
            "mel": rng.uniform(-5, 0, (128, T)).astype(np.float32),
            "contents": rng.standard_normal((256, T)).astype(np.float32),
            "pitches": rng.uniform(80, 600, T).astype(np.float32)})


def assert_same_batch(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind in "fiub":
            np.testing.assert_array_equal(a, b)
        else:
            assert a.tolist() == b.tolist()


def test_svc_dataset_matches_jax(tmp_path):
    write_items(tmp_path / "d", [100, 150, 37])
    port, ref = NaiveSVCDataset(str(tmp_path / "d"), speaker_id=3), \
        j_naive.NaiveSVCDataset(str(tmp_path / "d"), speaker_id=3)
    assert len(port) == len(ref) == 3
    for i in range(3):
        assert_same_batch(port[i], ref[i])
    got = NaiveSVCDataset.collate_fn([port[i] for i in range(3)])
    want = j_naive.NaiveSVCDataset.collate_fn([ref[i] for i in range(3)])
    assert_same_batch(got, want)
    assert got["mel"].shape == (3, 256, 128) and got["pitches"].shape == (3, 256, 1)
    assert list(got["mel_lens"]) == [100, 150, 37] and got["mel_max_len"] == 256


def test_concat_dataset_matches_jax(tmp_path):
    write_items(tmp_path / "a", [20, 30], seed=1)
    write_items(tmp_path / "b", [25], seed=2)
    parts = [dict(type="NaiveSVCDataset", path=str(tmp_path / "a"), speaker_id=0),
             dict(type="NaiveSVCDataset", path=str(tmp_path / "b"), speaker_id=1)]
    port, ref = ConcatDataset(parts), j_wrappers.ConcatDataset(parts)
    assert len(port) == len(ref) == 3
    assert [port[i]["speaker"] for i in range(3)] == [0, 0, 1]
    assert_same_batch(port.collate_fn([port[i] for i in range(3)]),
                      ref.collate_fn([ref[i] for i in range(3)]))


def tiny_config(data: Path, **trainer):
    hidden = 32
    return dict(
        model=dict(
            type="DiffSVC",
            diffusion=dict(type="GaussianDiffusion", mel_channels=128, timesteps=1000,
                           noise_loss="smoothed-l1", sampler_interval=10, spec_min=[-5],
                           spec_max=[0],
                           denoiser=dict(type="WaveNetDenoiser", mel_channels=128,
                                         d_encoder=hidden, residual_channels=64,
                                         residual_layers=2, dilation_cycle=2,
                                         use_linear_bias=True)),
            text_encoder=dict(type="NaiveProjectionEncoder", input_size=256,
                              output_size=hidden),
            speaker_encoder=dict(type="NaiveProjectionEncoder", input_size=4,
                                 output_size=hidden, use_embedding=True),
            pitch_encoder=dict(type="NaiveProjectionEncoder", input_size=1, output_size=hidden,
                               use_embedding=False, preprocessing="pitch_to_scale"),
            vocoder=dict(type="NsfHifiGAN", random_init=True, use_natural_log=False,
                         generator_config=dict(upsample_initial_channel=32)),
        ),
        optimizer=dict(type="AdamW", lr=3e-3, weight_decay=1e-2, betas=(0.9, 0.98), eps=1e-9),
        scheduler=None,
        ema_momentum=0.9,
        trainer={**dict(gradient_clip_val=0.5, log_every_n_steps=1, val_check_interval=4,
                        max_steps=8, precision="bf16-mixed", limit_val_batches=1,
                        val_sampler_interval=250, checkpoint=dict(save_top_k=-1)), **trainer},
        dataset=dict(train=dict(type="NaiveSVCDataset", path=str(data / "train")),
                     valid=dict(type="NaiveSVCDataset", path=str(data / "valid"))),
        dataloader=dict(train=dict(batch_size=2, shuffle=True, num_workers=0),
                        valid=dict(batch_size=2, shuffle=False, num_workers=0)),
    )


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("svc")
    write_items(root / "train", [60, 64, 50, 64], seed=3)
    write_items(root / "valid", [64, 40], seed=4)
    return root


def write_config(path: Path, cfg: dict) -> str:
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return str(path)


def run_cli(tmp_path, cfg, *flags):
    config = write_config(tmp_path / "config.py", cfg)
    return diffusion_cli.main(["--config", config, "--log-dir", str(tmp_path / "logs"),
                               "--name", "run", "--device", "cpu", *flags])


def test_cli_fits_validates_and_resumes(tmp_path, data):
    """8 steps through the CLI (float32 over the config's bf16): the
    validation loss falls between its checks, metrics, samples and
    checkpoints are written; ``--resume`` goes on from the last checkpoint
    with the state it saved."""
    state = run_cli(tmp_path, tiny_config(data))
    run = tmp_path / "logs" / "run"
    assert state.step == 8 and state.optimizer.count == 8
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    val = [r["valid_loss"] for r in rows if "valid_loss" in r]
    train = [r for r in rows if "train_loss" in r]
    assert len(val) == 2 and val[1] < val[0], val
    assert len(train) == 8 and all(np.isfinite(r["grad_norm"]) and r["lr"] == 3e-3
                                   for r in train)
    assert any("wall_total_s" in r for r in rows)
    assert sorted(p.name for p in (run / "checkpoints").glob("*.pt")) == ["4.pt", "8.pt"]
    for step in (4, 8):
        for idx in (0, 1):
            gt = np.load(run / f"sample-{idx}_mel_gt_{step}.npy")
            pred = np.load(run / f"sample-{idx}_mel_pred_{step}.npy")
            assert gt.shape == pred.shape == ((64, 128) if idx == 0 else (40, 128))
            assert np.isfinite(pred).all()
            assert (run / f"sample-{idx}_wav_gt_{step}.wav").exists()
            assert (run / f"sample-{idx}_wav_pred_{step}.wav").exists()

    saved = torch.load(run / "checkpoints" / "8.pt", weights_only=True)
    cfg = tiny_config(data, max_steps=10)
    trainer = DiffusionTrainer(Config(**{**cfg, "trainer": {**cfg["trainer"],
                                                            "precision": "32-true"}}),
                               log_dir=str(run), device="cpu")
    restored = trainer.ckpt.restore(trainer.init_state(seed=7))
    assert restored.step == 8 and restored.optimizer.count == 8
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    for k, v in restored.ema.state_dict().items():
        assert torch.equal(v, saved["ema"][k]), k
    resumed = run_cli(tmp_path, cfg, "--resume")
    assert resumed.step == 10 and resumed.optimizer.count == 10


def flat_to_tree(sd: dict) -> dict:
    tree: dict = {}
    for key, value in sd.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.numpy()
    return tree


def test_pretrained_skips_the_keys_jax_skips(tmp_path, data, capsys):
    """``--pretrained`` from a checkpoint with another speaker count and an
    extra tensor: the port's surgery skips the same keys for the same
    reasons as the JAX ``load_pretrained_params`` on the same tree, and
    every other tensor is copied."""
    cfg = tiny_config(data, max_steps=1)
    other = tiny_config(data)
    other["model"]["speaker_encoder"]["input_size"] = 7
    source = DiffusionTrainer(Config(**{**other, "trainer": {**other["trainer"],
                                                             "precision": "32-true"}}),
                              log_dir=str(tmp_path / "src"), device="cpu")
    pretrained = dict(source.init_state(seed=11).model.state_dict())
    pretrained["extra.weight"] = torch.ones(3)
    torch.save({"params": pretrained}, tmp_path / "pre.pt")

    state = run_cli(tmp_path, cfg, "--pretrained", str(tmp_path / "pre.pt"))
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("[pretrained] skipped")]
    init = torch.load(tmp_path / "logs" / "run" / "checkpoints" / "0.pt", weights_only=True)

    port_target = {k: v for k, v in init["params"].items()}
    merged = load_pretrained_params(pretrained, port_target)
    j_skipped = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("builtins.print", lambda msg: j_skipped.append(msg))
        j_load_pretrained_params(flat_to_tree(pretrained), flat_to_tree(port_target))
    want = sorted(m.replace("/", ".") for m in j_skipped)
    assert want == ["[pretrained] skipped extra.weight: unexpected",
                    "[pretrained] skipped speaker_encoder.embedding.weight: shape mismatch"]
    # the CLI prints the surgery for the parameters and for the EMA
    assert sorted(printed) == sorted(want * 2)
    for k, v in init["params"].items():
        if k != "speaker_encoder.embedding.weight":
            assert torch.equal(v, pretrained[k]) and torch.equal(merged[k], pretrained[k]), k
    assert state.step == 1


def test_only_train_speaker_embeddings_freezes_the_rest(tmp_path, data):
    """Every parameter outside ``speaker_encoder`` stays bit-equal over the
    steps (the EMA of a frozen parameter too); the speaker table trains."""
    cfg = tiny_config(data, max_steps=3, val_check_interval=100)
    trainer = DiffusionTrainer(Config(**{**cfg, "trainer": {**cfg["trainer"],
                                                            "precision": "32-true"}}),
                               log_dir=str(tmp_path / "ref"), device="cpu")
    before = {k: v.clone() for k, v in trainer.init_state(seed=42).model.state_dict().items()}
    state = run_cli(tmp_path, cfg, "--only-train-speaker-embeddings")
    assert state.step == 3
    moved = []
    for k, v in state.model.state_dict().items():
        if k.startswith("speaker_encoder."):
            moved.append(not torch.equal(v, before[k]))
        else:
            assert torch.equal(v, before[k]), k
            assert torch.equal(state.ema.state_dict()[k], before[k]), k
    assert moved and all(moved)


def test_jax_masked_freeze_moves_frozen_leaves():
    """The JAX CLI's ``--only-train-speaker-embeddings`` builds
    ``optax.chain(optax.masked(base_tx, mask))``: ``optax.masked`` passes
    the gradient of a masked-out leaf through as its update, so a frozen
    parameter moves by +1 x its gradient every step."""
    params = {"frozen": jnp.ones(3), "speaker_encoder": jnp.ones(3)}
    grads = {k: jnp.full(3, 0.5) for k in params}
    tx = optax.chain(optax.masked(optax.adamw(1e-3), {"frozen": False,
                                                      "speaker_encoder": True}))
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    np.testing.assert_allclose(np.asarray(updates["frozen"]), 0.5)
    np.testing.assert_allclose(np.asarray(new["frozen"]), 1.5)
    np.testing.assert_allclose(np.asarray(new["speaker_encoder"]), 0.999, rtol=1e-6)
    assert jax.tree_util.tree_structure(new) == jax.tree_util.tree_structure(params)


@pytest.mark.parametrize("override", [
    dict(precision="bf16-mixed"), dict(cache_batches_on_device=True), dict(max_epochs=3),
    dict(transfer_dtype="float16"), dict(fsdp=True), "lora",
])
def test_trainer_raises_on_what_is_not_ported(tmp_path, data, override):
    cfg = tiny_config(data)
    cfg["trainer"]["precision"] = "32-true"
    if override == "lora":
        cfg["lora"] = True
    else:
        cfg["trainer"].update(override)
    with pytest.raises(NotImplementedError):
        DiffusionTrainer(Config(**cfg), log_dir=str(tmp_path), device="cpu")


def test_trainer_defaults_to_the_card(tmp_path, data):
    cfg = tiny_config(data)
    cfg["trainer"]["precision"] = "32-true"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionTrainer(Config(**cfg), log_dir=str(tmp_path))


def test_denoiser_dataset_matches_jax(tmp_path):
    """``NaiveDenoiserDataset`` picks path, mel and contents (time-major)
    and pads them to a bucket of 128 frames, as the JAX dataset does."""
    write_items(tmp_path / "d", [100, 150, 37])
    port, ref = NaiveDenoiserDataset(str(tmp_path / "d")), \
        j_naive.NaiveDenoiserDataset(str(tmp_path / "d"))
    assert len(port) == len(ref) == 3
    for i in range(3):
        assert_same_batch(port[i], ref[i])
        assert set(port[i]) == {"path", "mel", "contents"}
    got = NaiveDenoiserDataset.collate_fn([port[i] for i in range(3)])
    want = j_naive.NaiveDenoiserDataset.collate_fn([ref[i] for i in range(3)])
    assert_same_batch(got, want)
    assert got["mel"].shape == (3, 256, 128) and got["contents"].shape == (3, 256, 256)
    assert "pitches" not in got and "speaker" not in got


def convnext_config(data: Path, **trainer):
    """``tiny_config`` with ``configs/denoiser_cn_hubert.py``'s denoiser at
    tiny dims (dim 32, mlp 2, 3 blocks, dilation cycle 2)."""
    cfg = tiny_config(data, **trainer)
    cfg["model"]["diffusion"]["denoiser"] = dict(
        type="ConvNextDenoiser", mel_channels=128, dim=32, mlp_factor=2, condition_dim=32,
        num_layers=3, dilation_cycle=2)
    return cfg


def test_convnext_cli_fits_validates_and_resumes(tmp_path, data):
    """The ConvNeXt DiffSVC through the CLI over ``NaiveSVCDataset``: 4
    steps with validation (samples, vocoded audio) and checkpoints at 2 and
    4, finite losses; ``--resume`` restores the last checkpoint and goes on
    to step 6."""
    cfg = convnext_config(data, max_steps=4, val_check_interval=2)
    state = run_cli(tmp_path, cfg)
    run = tmp_path / "logs" / "run"
    assert state.step == 4 and state.optimizer.count == 4
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert len([r for r in rows if "valid_loss" in r]) == 2
    assert all(np.isfinite(r["train_loss"]) for r in rows if "train_loss" in r)
    assert sorted(p.name for p in (run / "checkpoints").glob("*.pt")) == ["2.pt", "4.pt"]
    pred = np.load(run / "sample-1_mel_pred_4.npy")
    assert pred.shape == (40, 128) and np.isfinite(pred).all()
    assert (run / "sample-0_wav_pred_4.wav").exists()
    saved = torch.load(run / "checkpoints" / "4.pt", weights_only=True)
    resumed = run_cli(tmp_path, convnext_config(data, max_steps=6, val_check_interval=2),
                      "--resume")
    assert resumed.step == 6 and resumed.optimizer.count == 6
    moved = [not torch.equal(v, saved["params"][k])
             for k, v in resumed.model.state_dict().items()]
    assert any(moved)


def jax_convnext_params(cfg: dict, seed: int):
    """Seeded random parameters of the JAX DiffSVC of ``cfg`` (the vocoder
    is not part of it), as numpy arrays."""
    model_cfg = {k: v for k, v in cfg["model"].items() if k != "vocoder"}
    jmodel = j_build_model(model_cfg, training=True)
    B, T = 2, 16
    batch = {"speakers": jnp.zeros((B,), jnp.int32),
             "contents": jnp.zeros((B, T, 256), jnp.float32),
             "contents_lens": jnp.full((B,), T, jnp.int32),
             "mel": jnp.zeros((B, T, 128), jnp.float32),
             "mel_lens": jnp.full((B,), T, jnp.int32),
             "pitches": jnp.full((B, T), 200.0, jnp.float32)}
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)}, **batch)
    return jmodel, jax.tree_util.tree_map(np.asarray, randomize(variables["params"], seed))


def test_convnext_pretrained_from_a_jax_pickle(tmp_path, data):
    """``--pretrained`` with a pickle of the JAX ConvNeXt DiffSVC's
    parameters: the step-0 checkpoint holds them (through
    ``diffsinger_from_jax``) bit for bit, the EMA too, and training goes
    on from them."""
    import pickle

    cfg = convnext_config(data, max_steps=1, val_check_interval=100)
    _, params = jax_convnext_params(cfg, 21)
    with open(tmp_path / "jax_params.pkl", "wb") as f:
        pickle.dump(params, f)
    state = run_cli(tmp_path, cfg, "--pretrained", str(tmp_path / "jax_params.pkl"))
    init = torch.load(tmp_path / "logs" / "run" / "checkpoints" / "0.pt", weights_only=True)
    want = diffsinger_from_jax(params)
    assert set(init["params"]) == set(want)
    for k, v in want.items():
        assert torch.equal(init["params"][k], v) and torch.equal(init["ema"][k], v), k
    assert state.step == 1


def test_denoiser_dataset_batches_fail_in_both_packages(tmp_path):
    """``configs/denoiser_cn_hubert.py`` pairs DiffSVC (which has a pitch
    encoder) with ``NaiveDenoiserDataset``, whose batches carry no pitches:
    the JAX model fails with a ``TypeError`` at ``models/diffsinger.py:104``
    (the pitch encoder of None), the port raises a ``ValueError`` that
    names the missing key and the dataset."""
    write_items(tmp_path / "d", [40, 30])
    data = NaiveDenoiserDataset(str(tmp_path / "d"))
    batch = NaiveDenoiserDataset.collate_fn([data[0], data[1]])
    cfg = convnext_config(tmp_path)
    jmodel, params = jax_convnext_params(cfg, 22)
    jbatch = {"contents": jnp.asarray(batch["contents"]), "mel": jnp.asarray(batch["mel"]),
              "contents_lens": jnp.asarray(batch["mel_lens"]),
              "mel_lens": jnp.asarray(batch["mel_lens"]), "speakers": None}
    with pytest.raises(TypeError) as err:
        jmodel.apply({"params": params}, **jbatch, rngs={"diffusion": jax.random.PRNGKey(0)})
    assert any(e.path.name == "diffsinger.py" and e.path.parent.parent.name ==
               "fish_diffusion_tpu" and e.lineno + 1 == 104 for e in err.traceback)

    model = build_model({k: v for k, v in cfg["model"].items() if k != "vocoder"})
    kwargs = model_kwargs(batch_to_device(batch, "cpu"))
    assert "pitches" not in kwargs
    with pytest.raises(ValueError, match="'pitches'.*NaiveDenoiserDataset"):
        model(**{"speakers": None, **kwargs})
