"""PyTorch port vs the JAX package: CREPE. The network (tiny capacity, the
JAX package's variables with randomised BatchNorm statistics, carried
across by ``convert.crepe_from_jax``) within atol 2e-5 / rtol 1e-4, the
tolerance of ``tests/test_crepe_parity.py``; framing, the NaN-aware filters
and the loudness gate; and the whole ``CrepePitchExtractor`` on the tones of
``tests/test_torch_pitch.py``: every frame's voicing identical, voiced f0
within 1 cent. The decoder is K8 CREPE's plain version on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.extractors import crepe as jcrepe
from fish_diffusion_tpu_torch.convert import crepe_from_jax
from fish_diffusion_tpu_torch.extractors import crepe
from fish_diffusion_tpu_torch.registry import PITCH_EXTRACTORS
from tests.test_torch_pitch import SIGNALS, SR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized_variables(capacity="tiny", seed=0):
    """The JAX net's variables with seeded biases, BatchNorm scales and
    running statistics (flax initialises them to the identity)."""
    v = jax.tree_util.tree_map(np.asarray, jcrepe.CrepePitchExtractor(model=capacity)
                               .init_random(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params = {k: dict(p) for k, p in v["params"].items()}
    for p in params.values():
        p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)).astype(np.float32)
        if "scale" in p:
            p["scale"] = (1 + 0.1 * rng.standard_normal(p["scale"].shape)).astype(np.float32)
    stats = {k: dict(mean=(0.3 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                     var=rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32))
             for k, s in v["batch_stats"].items()}
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def extractors():
    variables = randomized_variables()
    jext = jcrepe.CrepePitchExtractor(model="tiny")
    jext.variables = variables
    ext = PITCH_EXTRACTORS.build(dict(type="CrepePitchExtractor", model="tiny"), device="cpu")
    ext.load_state_dict(crepe_from_jax(variables))
    return jext, ext


def test_net_matches_jax(extractors):
    jext, ext = extractors
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((6, 1024)).astype(np.float32)
    frames = (frames - frames.mean(1, keepdims=True)) / frames.std(1, ddof=1, keepdims=True)
    ref = np.asarray(jext._forward(jext.variables, jnp.asarray(frames)))
    with torch.no_grad():
        got = ext.model(torch.from_numpy(frames)).numpy()
    assert got.shape == (6, 360) and ref.std() > 0.01
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_framing_filters_and_loudness_match_jax():
    """Frames within 1e-5; the NaN-aware median and mean (NaN runs, single
    values, the reflect-padded ends) within 1e-6; the loudness identical
    (the same host numpy); the bin quantisation identical."""
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal(16000)).astype(np.float32)
    audio[4000:6000] = 0.0
    ref = jcrepe.frame_audio_16k(audio, 80)
    got = crepe.frame_audio_16k(torch.from_numpy(audio), 80).numpy()
    assert got.shape == ref.shape == (201, 1024)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

    x = rng.uniform(0, 1, 60).astype(np.float32)
    x[[3, 10, 11, 12, 30, 31, 59]] = np.nan
    for name in ("median_filter", "mean_filter"):
        r = np.asarray(getattr(jcrepe, name)(jnp.asarray(x), 3))
        g = getattr(crepe, name)(torch.from_numpy(x), 3).numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g[~np.isnan(r)], r[~np.isnan(r)], rtol=0, atol=1e-6)

    np.testing.assert_array_equal(crepe.a_weighted_loudness(audio, 16000, 80, 201),
                                  jcrepe.a_weighted_loudness(audio, 16000, 80, 201))
    for f in (50.0, 1100.0, 220.0):
        for q in (np.floor, np.ceil):
            assert crepe.frequency_to_bin(f, q) == jcrepe.frequency_to_bin(f, q)
    np.testing.assert_array_equal(crepe._transition_matrix(), jcrepe._transition_matrix())


@pytest.mark.parametrize("name", list(SIGNALS))
def test_crepe_matches_jax(extractors, name):
    """At 5 ms frames (279 for 1.4 s, bucket 512): voicing identical,
    voiced f0 within 1 cent."""
    jext, ext = extractors
    x = SIGNALS[name]()
    ref = np.asarray(jext(x, SR))
    got = ext(x, SR)
    assert got.shape == ref.shape
    assert (ref > 0).sum() > 100
    np.testing.assert_array_equal(got > 0, ref > 0)
    voiced = ref > 0
    assert np.abs(1200 * np.log2(got[voiced] / ref[voiced])).max() <= 1.0


def test_frame_count_is_five_ms():
    """CREPE's frames covering a segment are its 5 ms ones (200 per second),
    where the hop-based extractors count one per 512 samples."""
    ext = crepe.CrepePitchExtractor(model="tiny", device="cpu")
    assert ext.frame_count(44100, 44100) == 200
    assert ext.frame_count(2 * 44100 + 1, 44100) == 401
    assert ext.frame_count(88200, 44100) == 400
    assert crepe.BasePitchExtractor().frame_count(88200, 44100) == 173


def test_random_init_and_missing_weights():
    """``random_init`` draws every weight from ``seed`` (the same seed, the
    same net); without weights the extractor says so."""
    a = crepe.CrepePitchExtractor(model="tiny", random_init=True, seed=3, device="cpu")
    b = crepe.CrepePitchExtractor(model="tiny", random_init=True, seed=3, device="cpu")
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    with pytest.raises(RuntimeError, match="no weights"):
        crepe.CrepePitchExtractor(model="tiny", device="cpu")(np.zeros(4000, np.float32), SR)


def test_checkpoint_path_takes_a_torchcrepe_state_dict(extractors, tmp_path):
    """``checkpoint_path``: a torchcrepe state dict (``num_batches_tracked``
    present or not); a missing or an unexpected key raises."""
    _, ext = extractors
    sd = ext.model.state_dict()
    torch.save(sd, tmp_path / "tiny.pth")
    loaded = crepe.CrepePitchExtractor(model="tiny", checkpoint_path=str(tmp_path / "tiny.pth"),
                                       device="cpu")
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bare = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    loaded.load_state_dict(bare)
    with pytest.raises(KeyError, match="classifier.bias"):
        loaded.load_state_dict({k: v for k, v in bare.items() if k != "classifier.bias"})
    with pytest.raises(KeyError, match="conv7"):
        loaded.load_state_dict({**bare, "conv7.weight": torch.zeros(1)})
