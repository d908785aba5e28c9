"""PyTorch port vs the JAX package: K7, monotonic alignment
(``ops/monotonic_align.py``).

``maximum_path`` (on the CPU its plain version, the JAX scan formulation
in torch) equals the JAX ``maximum_path`` and ``maximum_path_numpy``
exactly: on random values, on values that tie everywhere or often (integer
values, whose float32 sums are exact, so ``same < left`` meets equal
operands), with t_x = t_y (the diagonal is forced) and with t_x = 1. All
cases share one shape, so the JAX op compiles once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.ops.monotonic_align import maximum_path as jmaximum_path
from fish_diffusion_tpu.ops.monotonic_align import maximum_path_numpy as jmaximum_path_numpy
from fish_diffusion_tpu_torch.ops import monotonic_align as ma
from tests.test_torch_kernels_cuda import ALIGN_B, ALIGN_CASES, ALIGN_T_X, ALIGN_T_Y, align_case

B, T_Y, T_X = ALIGN_B, ALIGN_T_Y, ALIGN_T_X


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,seed", ALIGN_CASES)
def test_maximum_path_equals_jax_and_numpy(kind, seed):
    """Paths identical to the JAX op's and the numpy golden DP's."""
    values, t_ys, t_xs = align_case(kind, seed)
    ref = np.asarray(jmaximum_path(jnp.asarray(values), jnp.asarray(t_ys), jnp.asarray(t_xs)))
    np.testing.assert_array_equal(ref, jmaximum_path_numpy(values, t_ys, t_xs))
    got = ma.maximum_path(torch.from_numpy(values), torch.from_numpy(t_ys),
                          torch.from_numpy(t_xs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ma.maximum_path_numpy(values, t_ys, t_xs), ref)
    # a valid path: one phone per frame, from (0, 0) to (t_y - 1, t_x - 1)
    for b in range(B):
        p = got.numpy()[b]
        assert p.sum() == t_ys[b] and p[: t_ys[b], : t_xs[b]].sum(axis=1).min() == 1
        assert p[0, 0] == 1 and p[t_ys[b] - 1, t_xs[b] - 1] == 1


def test_ties_meet_the_strict_comparison():
    """The ``ties`` cases do reach equal cumulative values in a backtrack
    comparison (so a ``<=`` would take another path somewhere)."""
    moved_on_tie = 0
    for kind, seed in ALIGN_CASES:
        if kind == "random":
            continue
        values, t_ys, t_xs = align_case(kind, seed)
        loose = _numpy_path_loose(values, t_ys, t_xs)
        moved_on_tie += int((loose != jmaximum_path_numpy(values, t_ys, t_xs)).any())
    assert moved_on_tie >= 2


def _numpy_path_loose(values, t_ys, t_xs):
    """``maximum_path_numpy`` with ``<=`` in the backtrack."""
    values = values.astype(np.float32).copy()
    paths = np.zeros(values.shape, np.int32)
    for b in range(values.shape[0]):
        value, t_y, t_x = values[b], int(t_ys[b]), int(t_xs[b])
        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = -1e9 if x == y else value[y - 1, x]
                v_prev = (0.0 if y == 0 else -1e9) if x == 0 else value[y - 1, x - 1]
                value[y, x] += max(v_prev, v_cur)
        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            paths[b, y, index] = 1
            if index != 0 and (index == y or value[y - 1, index] <= value[y - 1, index - 1]):
                index -= 1
    return paths


def test_maximum_path_from_mask():
    """The mask contract: lengths read from the mask, the path in the
    values' dtype, equal to the JAX op's."""
    values, t_ys, t_xs = align_case("random", 5)
    mask = ((np.arange(T_Y)[None, :, None] < t_ys[:, None, None])
            & (np.arange(T_X)[None, None, :] < t_xs[:, None, None])).astype(np.float32)
    got = ma.maximum_path_from_mask(torch.from_numpy(values), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    ref = np.asarray(jmaximum_path(jnp.asarray(values), jnp.asarray(t_ys), jnp.asarray(t_xs)))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)
