"""The source compositions with the frame-phase scan inside (``base=None``).

On the card ``nsf_merge``, ``nsf_merge_backward``, ``sine_merge`` and
``comb_merge`` form their frames' bases themselves when no base is given.
Their plain versions do the same with ``nsf_phase_base_reference`` (the
nearest mode for K3, the linear mode for K9 comb and K9 sine). Here, on the
CPU, each plain version and each wrapper given ``base=None`` is held equal,
bit for bit, to the two-step composition: the reference's bases, then the
merge given them. Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

from fish_diffusion_tpu_torch.models.vocoders import source

SR = 44100
CASES = [(2, 37, 16, 9), (1, 300, 4, 1), (2, 9, 256, 3)]


def inputs(B, T, hop, H, seed):
    """f0 [B, T] with unvoiced frames and one near sr / 2, rand_ini [B, H]
    (column 0 is 0), noise [B, T * hop, H], weight [H], bias [1]."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(60, 900, (B, T)) * (rng.uniform(size=(B, T)) > 0.2)
    f0[0, T // 2] = SR / 2 - 50
    rand_ini = rng.uniform(size=(B, H))
    rand_ini[:, 0] = 0
    arrays = (f0, rand_ini, rng.standard_normal((B, T * hop, H)), rng.standard_normal(H) / 3,
              rng.standard_normal(1) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _two_step(mode, f0, rand_ini, noise, weight, bias, hop):
    """Each plain version given ``base=None`` (and the public composition
    that passes it) against the reference's bases, then the merge given
    them: ``mode`` "nearest" for K3 and its backward, "linear" for K9 sine
    (both forms) and K9 comb."""
    base = source.nsf_phase_base_reference(f0, SR, hop, mode)
    if mode == "nearest":
        two_step = source.nsf_merge_reference(f0, base, rand_ini, noise, weight, bias, SR, hop)
        g = torch.from_numpy(np.random.default_rng(f0.shape[1]).standard_normal(two_step.shape)
                             .astype(np.float32))
        for fn in (source.nsf_merge_reference, source.nsf_merge):
            yield fn(f0, None, rand_ini, noise, weight, bias, SR, hop), two_step
        yield source.nsf_source(f0, rand_ini, noise, weight, bias, SR, hop), two_step
        ref = source.nsf_merge_backward_reference(g, two_step, f0, base, rand_ini, noise, SR,
                                                  hop)
        for fn in (source.nsf_merge_backward_reference, source.nsf_merge_backward):
            yield fn(g, two_step, f0, None, rand_ini, noise, SR, hop), ref
        return
    two_step = source.sine_merge_reference(f0, base, rand_ini, noise, weight, bias, SR, hop)
    for fn in (source.sine_merge_reference, source.sine_merge):
        yield fn(f0, None, rand_ini, noise, weight, bias, SR, hop), two_step
    yield source.sine_template(f0, rand_ini, noise, weight, bias, SR, hop), two_step
    yield tuple(source._sine_merge_plain(f0, b_, rand_ini, noise, weight, bias, SR, hop, 0.1,
                                         0.003) for b_ in (None, base))
    comb_noise = noise[..., 0].contiguous()
    comb = source.comb_merge_reference(f0, base, comb_noise, SR, hop)
    for fn in (source.comb_merge_reference, source.comb_merge):
        yield fn(f0, None, comb_noise, SR, hop), comb
    yield source.comb_tooth(f0, comb_noise, SR, hop), comb
    yield source.comb_tooth_reference(f0, comb_noise, SR, hop), comb


@pytest.mark.parametrize("mode", ["nearest", "linear"])
@pytest.mark.parametrize("B,T,hop,H", CASES)
def test_plain_versions_without_base_are_the_two_step_composition(B, T, hop, H, mode):
    f0, rand_ini, noise, weight, bias = inputs(B, T, hop, H, T + hop + (mode == "linear") * 2)
    for got, want in _two_step(mode, f0, rand_ini, noise, weight, bias, hop):
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("B,T,hop,H", CASES)
def test_nsf_merge_gradient_without_base(B, T, hop, H):
    """``_NsfMerge`` keeps a base of None for its backward: the merge's
    weight and bias gradients equal those through the given base."""
    f0, rand_ini, noise, weight, bias = inputs(B, T, hop, H, T + hop + 1)
    base = source.nsf_phase_base_reference(f0, SR, hop)
    grads = []
    for b_ in (None, base):
        w, b = weight.clone().requires_grad_(), bias.clone().requires_grad_()
        source.nsf_merge(f0, b_, rand_ini, noise, w, b, SR, hop).square().sum().backward()
        grads.append((w.grad, b.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
