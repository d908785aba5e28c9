"""Gaussian diffusion over normalized mel (``fish_diffusion_tpu/models/diffusion.py``).

The schedule and the UniPC step table are host-side numpy float64, the
same algebra as the JAX package, cast to float32 where they meet the
device. Three samplers, each with its per-step update as K2, fused
elementwise Triton kernels over ``[B, T, 128]`` float32:

- UniPC (bh1/bh2, orders 1-3, data prediction), the default:
  ``unipc_predict``: x_pred = c_x x + c_m0 m0 + c_p0 D1s_0 + c_p1 D1s_1,
  with D1s_k = (m_{k+1} - m0) inv_rk_k, the final order-1 step too;
  ``unipc_correct``: m_t = (x_eval - sigma eps) / alpha (the data
  prediction), fused with the corrector x_new = c_x x + c_m0 m0
  + c_c0 D1s_0 + c_c1 D1s_1 + c_d1t (m_t - m0);
- PLMS: ``plms_update``: the Adams-Bashforth combination of the new eps
  and a 3-slot history, eps' = (w0 eps + w1 h_2 + w2 h_1 + w3 h_0) / den,
  fused with the transfer x + c_d (c_x x - c_e eps');
- naive DDPM: ``ddpm_update``: x0 = clip(a x - b eps, -1, 1), then
  c1 x0 + c2 x + sigma noise.

They replace the JAX package's scan bodies ``_sample_unipc``
(``fish_diffusion_tpu/models/diffusion.py:462``), ``_sample_plms`` (``:395``)
and ``_sample_naive`` (``:366``). On an H100 each update is bound by memory
bandwidth: a few tensors in and one or two out, next to a 20-block denoiser
eval. Each pass reads each tensor once and writes its outputs once, with the
step's coefficients as scalar arguments taken on the host from the float32
tables, as the JAX package's float32 device arithmetic takes them. The data
prediction is fused into the UniPC corrector because the corrector is its
first consumer: after each denoiser eval the corrector finishes step i - 1
with it, then the predictor starts step i from the corrected x. The
``*_reference`` functions are the plain versions, which the wrappers take
for CPU tensors.

Shallow diffusion (``skip_steps`` with ``original_mel``) warm-starts from
the normalized input mel noised to step T - skip; UniPC then solves from
t = (T - skip) / T, as the JAX package does (a deliberate departure from
fish-diffusion, whose UniPC always solves from t = 1).

Random draws come from one ``torch.Generator``, in this order: x_T (unless
``original_mel`` is given), the warm-start noise (when ``skip_steps``), then
one noise per naive step, in step order (t = 0 included, where it is
multiplied by 0).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..ops.schedule import get_noise_schedule_list
from ..registry import DENOISERS, DIFFUSIONS

# ---------------------------------------------------------------------------
# Host-side coefficient tables (numpy float64)
# ---------------------------------------------------------------------------


class ScheduleCoefficients:
    """Schedule-derived constants, numpy float64."""

    def __init__(self, betas: np.ndarray):
        self.betas = betas
        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])

        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1)

        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        )
        self.posterior_log_variance_clipped = np.log(
            np.maximum(self.posterior_variance, 1e-20)
        )
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        )
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev)
            * np.sqrt(alphas)
            / (1.0 - self.alphas_cumprod)
        )

        # continuous-time VP wrapping for UniPC: log alpha_t on the grid
        # t_i = (i + 1) / N, interpolated piecewise-linearly
        self.log_alphas = 0.5 * np.cumsum(np.log(1 - betas))
        self.t_array = np.linspace(0.0, 1.0, len(betas) + 1)[1:]


def _marginal_log_alpha(coeffs: ScheduleCoefficients, t: np.ndarray) -> np.ndarray:
    return np.interp(t, coeffs.t_array, coeffs.log_alphas)


def _marginal_lambda(coeffs: ScheduleCoefficients, t: np.ndarray) -> np.ndarray:
    log_alpha = _marginal_log_alpha(coeffs, t)
    log_sigma = 0.5 * np.log(1.0 - np.exp(2.0 * log_alpha))
    return log_alpha - log_sigma


def unipc_step_table(
    coeffs: ScheduleCoefficients,
    steps: int,
    t_start: Optional[float] = None,
    variant: str = "bh2",
    order: int = 2,
) -> dict:
    """Everything the UniPC multistep loop needs, for update steps
    1..``steps``: variant bh1/bh2, order <= 3, data prediction, a uniform
    time grid, lower-order final steps, the corrector on all but the last
    step. ``D1s`` has up to ``order - 1`` columns; the tables carry 2 slots
    with zeros where the step's effective order is lower."""
    if variant not in ("bh1", "bh2"):
        raise ValueError(f"unsupported UniPC variant {variant!r}")
    if not 1 <= order <= 3:
        raise ValueError(f"unsupported UniPC order {order}: supported 1-3")

    N = len(coeffs.betas)
    t_T = 1.0 if t_start is None else t_start
    t_0 = 1.0 / N
    timesteps = np.linspace(t_T, t_0, steps + 1)

    lambdas = _marginal_lambda(coeffs, timesteps)
    log_alphas = _marginal_log_alpha(coeffs, timesteps)
    alphas = np.exp(log_alphas)
    sigmas = np.sqrt(1.0 - np.exp(2.0 * log_alphas))
    model_times = (timesteps - 1.0 / N) * N

    out = {
        "model_times": model_times.astype(np.float32),
        "c_x": np.zeros(steps, np.float32),
        "c_m0": np.zeros(steps, np.float32),
        "c_pred": np.zeros((steps, 2), np.float32),
        "c_corr": np.zeros((steps, 2), np.float32),
        "c_corr_D1t": np.zeros(steps, np.float32),
        "inv_rk": np.zeros((steps, 2), np.float32),
        "alpha_in": alphas.astype(np.float32),
        "sigma_in": sigmas.astype(np.float32),
    }

    for step in range(1, steps + 1):
        i = step - 1
        lam_prev0, lam_t = lambdas[step - 1], lambdas[step]
        sigma_prev0, sigma_t = sigmas[step - 1], sigmas[step]
        alpha_t = alphas[step]

        h = lam_t - lam_prev0
        hh = -h
        h_phi_1 = np.expm1(hh)
        B_h = np.expm1(hh) if variant == "bh2" else hh

        o = min(step, order, steps + 1 - step)

        out["c_x"][i] = sigma_t / sigma_prev0
        out["c_m0"][i] = -alpha_t * h_phi_1

        rks = []
        for k in range(1, o):
            lam_prev_k = lambdas[step - 1 - k]
            rks.append((lam_prev_k - lam_prev0) / h)
            out["inv_rk"][i, k - 1] = 1.0 / rks[-1]
        rks_full = np.array(rks + [1.0])

        R_rows, b_vals = [], []
        h_phi_k = h_phi_1 / hh - 1.0
        factorial_i = 1.0
        for j in range(1, o + 1):
            R_rows.append(rks_full ** (j - 1))
            b_vals.append(h_phi_k * factorial_i / B_h)
            factorial_i *= j + 1
            h_phi_k = h_phi_k / hh - 1.0 / factorial_i
        R = np.stack(R_rows)
        b = np.array(b_vals)

        if o == 2:
            out["c_pred"][i, 0] = -alpha_t * B_h * 0.5
        elif o == 3:
            rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            out["c_pred"][i, :2] = -alpha_t * B_h * rhos_p

        if o == 1:
            out["c_corr_D1t"][i] = -alpha_t * B_h * 0.5
        else:
            rhos_c = np.linalg.solve(R, b)
            out["c_corr"][i, : o - 1] = -alpha_t * B_h * rhos_c[:-1]
            out["c_corr_D1t"][i] = -alpha_t * B_h * rhos_c[-1]

    return out


# ---------------------------------------------------------------------------
# K2: the UniPC update (Triton)
# ---------------------------------------------------------------------------

tl = None  # triton.language, bound at the first launch (no triton on import)
_TRITON: dict = {}
_BLOCK = 1024


def _unipc_predict_kernel(x_ptr, m0_ptr, m1_ptr, m2_ptr, out_ptr, n,
                          c_x, c_m0, c_p0, c_p1, ir0, ir1,
                          BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask)
    m0 = tl.load(m0_ptr + offs, mask=mask)
    m1 = tl.load(m1_ptr + offs, mask=mask)
    m2 = tl.load(m2_ptr + offs, mask=mask)
    d0 = (m1 - m0) * ir0
    d1 = (m2 - m0) * ir1
    x_t = c_x * x + c_m0 * m0
    tl.store(out_ptr + offs, x_t + c_p0 * d0 + c_p1 * d1, mask=mask)


def _unipc_correct_kernel(x_ptr, m0_ptr, m1_ptr, m2_ptr, xe_ptr, eps_ptr,
                          x_out_ptr, m_out_ptr, n, alpha, sigma,
                          c_x, c_m0, c_c0, c_c1, c_d1t, ir0, ir1,
                          BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask)
    m0 = tl.load(m0_ptr + offs, mask=mask)
    m1 = tl.load(m1_ptr + offs, mask=mask)
    m2 = tl.load(m2_ptr + offs, mask=mask)
    xe = tl.load(xe_ptr + offs, mask=mask)
    eps = tl.load(eps_ptr + offs, mask=mask)
    m_t = tl.math.div_rn(xe - sigma * eps, alpha)  # IEEE division
    d0 = (m1 - m0) * ir0
    d1 = (m2 - m0) * ir1
    x_t = c_x * x + c_m0 * m0
    x_new = x_t + c_c0 * d0 + c_c1 * d1 + c_d1t * (m_t - m0)
    tl.store(m_out_ptr + offs, m_t, mask=mask)
    tl.store(x_out_ptr + offs, x_new, mask=mask)


def _plms_update_kernel(x_ptr, e_ptr, h2_ptr, h1_ptr, h0_ptr, out_ptr, n,
                       w0, w1, w2, w3, den, c_d, c_x, c_e,
                       BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask)
    e = tl.load(e_ptr + offs, mask=mask)
    h2 = tl.load(h2_ptr + offs, mask=mask)
    h1 = tl.load(h1_ptr + offs, mask=mask)
    h0 = tl.load(h0_ptr + offs, mask=mask)
    eps = tl.math.div_rn(w0 * e + w1 * h2 + w2 * h1 + w3 * h0, den)
    tl.store(out_ptr + offs, x + c_d * (c_x * x - c_e * eps), mask=mask)


def _ddpm_update_kernel(x_ptr, e_ptr, z_ptr, out_ptr, n, a, b, c1, c2, sigma,
                        BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask)
    e = tl.load(e_ptr + offs, mask=mask)
    z = tl.load(z_ptr + offs, mask=mask)
    x0 = tl.minimum(tl.maximum(a * x - b * e, -1.0), 1.0)
    tl.store(out_ptr + offs, c1 * x0 + c2 * x + sigma * z, mask=mask)


def _triton_kernels() -> dict:
    global tl
    if not _TRITON:
        import triton
        import triton.language

        tl = triton.language
        _TRITON["predict"] = triton.jit(_unipc_predict_kernel)
        _TRITON["correct"] = triton.jit(_unipc_correct_kernel)
        _TRITON["plms"] = triton.jit(_plms_update_kernel)
        _TRITON["ddpm"] = triton.jit(_ddpm_update_kernel)
    return _TRITON


def _check_same(name, *tensors):
    kernels.require_cuda(name, *tensors)
    if tensors[0].dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {tensors[0].dtype}")
    for t in tensors[1:]:
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and "
                             f"{tuple(tensors[0].shape)} differ")


def unipc_predict_reference(x, m0, m1, m2, c_x, c_m0, c_p0, c_p1, ir0, ir1):
    d0 = (m1 - m0) * ir0
    d1 = (m2 - m0) * ir1
    x_t = c_x * x + c_m0 * m0
    return x_t + c_p0 * d0 + c_p1 * d1


def unipc_predict(x, m0, m1, m2, c_x, c_m0, c_p0, c_p1, ir0, ir1):
    """K2 predictor. Scalars are Python floats taken from the float32 step
    table."""
    if not x.is_cuda:
        return unipc_predict_reference(x, m0, m1, m2, c_x, c_m0, c_p0, c_p1,
                                       ir0, ir1)
    return _launch_elementwise("unipc_predict", "predict", (x, m0, m1, m2),
                               (c_x, c_m0, c_p0, c_p1, ir0, ir1))


def unipc_correct_reference(x, m0, m1, m2, x_eval, eps, alpha, sigma,
                            c_x, c_m0, c_c0, c_c1, c_d1t, ir0, ir1):
    # IEEE division: on CUDA, torch turns ``x / float`` into a reciprocal
    # multiplication, which rounds differently
    m_t = (x_eval - sigma * eps) / torch.tensor(alpha, device=x.device)
    d0 = (m1 - m0) * ir0
    d1 = (m2 - m0) * ir1
    x_t = c_x * x + c_m0 * m0
    x_new = x_t + c_c0 * d0 + c_c1 * d1 + c_d1t * (m_t - m0)
    return x_new, m_t


def unipc_correct(x, m0, m1, m2, x_eval, eps, alpha, sigma,
                  c_x, c_m0, c_c0, c_c1, c_d1t, ir0, ir1):
    """K2 corrector fused with the data prediction of ``eps`` at ``x_eval``.
    Returns (x_new, m_t)."""
    if not x.is_cuda:
        return unipc_correct_reference(x, m0, m1, m2, x_eval, eps, alpha,
                                       sigma, c_x, c_m0, c_c0, c_c1, c_d1t,
                                       ir0, ir1)
    _check_same("unipc_correct", x, m0, m1, m2, x_eval, eps)
    x_new, m_t = torch.empty_like(x), torch.empty_like(x)
    n = x.numel()
    _triton_kernels()["correct"][(-(-n // _BLOCK),)](
        x, m0, m1, m2, x_eval, eps, x_new, m_t, n, alpha, sigma,
        c_x, c_m0, c_c0, c_c1, c_d1t, ir0, ir1, BLOCK=_BLOCK,
    )
    kernels.count_launch("unipc_correct")
    return x_new, m_t


def sample_unipc(x: torch.Tensor, denoise, table: dict) -> torch.Tensor:
    """UniPC multistep sampling from x_T over a ``unipc_step_table``: one
    denoiser eval per step, a 2-slot history of data predictions. Inert
    history slots have zero ``inv_rk``; the final step is order-1 with no
    corrector."""
    steps = len(table["c_x"])
    f = {k: v.astype(np.float64).tolist() for k, v in table.items()}
    B = x.shape[0]

    def t_model(i):
        return torch.full((B,), f["model_times"][i], dtype=torch.float32,
                          device=x.device)

    # data prediction at x_T: the corrector with identity coefficients
    eps = denoise(x, t_model(0))
    x, m0 = unipc_correct(x, x, x, x, x, eps, f["alpha_in"][0],
                          f["sigma_in"][0], 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    m1 = m2 = m0

    for i in range(steps - 1):
        (ir0, ir1), (cp0, cp1), (cc0, cc1) = (
            f["inv_rk"][i], f["c_pred"][i], f["c_corr"][i]
        )
        x_pred = unipc_predict(x, m0, m1, m2, f["c_x"][i], f["c_m0"][i],
                               cp0, cp1, ir0, ir1)
        eps = denoise(x_pred, t_model(i + 1))
        x, m_t = unipc_correct(x, m0, m1, m2, x_pred, eps,
                               f["alpha_in"][i + 1], f["sigma_in"][i + 1],
                               f["c_x"][i], f["c_m0"][i], cc0, cc1,
                               f["c_corr_D1t"][i], ir0, ir1)
        m0, m1, m2 = m_t, m0, m1

    i = steps - 1
    (ir0, ir1), (cp0, cp1) = f["inv_rk"][i], f["c_pred"][i]
    return unipc_predict(x, m0, m1, m2, f["c_x"][i], f["c_m0"][i], cp0, cp1,
                         ir0, ir1)


def _launch_elementwise(name, kernel, tensors, scalars):
    _check_same(name, *tensors)
    out = torch.empty_like(tensors[0])
    n = out.numel()
    _triton_kernels()[kernel][(-(-n // _BLOCK),)](
        *tensors, out, n, *scalars, BLOCK=_BLOCK
    )
    kernels.count_launch(name)
    return out


# PLMS stage weights (w0, w1, w2, w3, den) on (eps, h_2, h_1, h_0), h_2 the
# newest history slot; stage 0 runs its two denoiser evals with the first
# and the last row
PLMS_WEIGHTS = (
    (3.0, -1.0, 0.0, 0.0, 2.0),
    (23.0, -16.0, 5.0, 0.0, 12.0),
    (55.0, -59.0, 37.0, -9.0, 24.0),
)
PLMS_FIRST = (1.0, 0.0, 0.0, 0.0, 1.0)
PLMS_AVERAGE = (1.0, 1.0, 0.0, 0.0, 2.0)


def plms_transfer(acp: np.ndarray, t: int, t_prev: int) -> tuple:
    """(c_d, c_x, c_e) of the PLMS transfer from step t to t_prev, from the
    float32 ``alphas_cumprod`` in float32 arithmetic."""
    a_t, a_prev = acp[t], acp[t_prev]
    a_t_sq, a_prev_sq = np.sqrt(a_t), np.sqrt(a_prev)
    one = np.float32(1.0)
    c_x = one / (a_t_sq * (a_t_sq + a_prev_sq))
    c_e = one / (a_t_sq * (np.sqrt((one - a_prev) * a_t)
                           + np.sqrt((one - a_t) * a_prev)))
    return float(a_prev - a_t), float(c_x), float(c_e)


def plms_update_reference(x, e, h2, h1, h0, w0, w1, w2, w3, den, c_d, c_x, c_e):
    # IEEE division, as in unipc_correct_reference
    eps = (w0 * e + w1 * h2 + w2 * h1 + w3 * h0) / torch.tensor(den, device=x.device)
    return x + c_d * (c_x * x - c_e * eps)


def plms_update(x, e, h2, h1, h0, w0, w1, w2, w3, den, c_d, c_x, c_e):
    """K2-PLMS: the stage's combination of the new eps ``e`` and the
    history (``h2`` the newest), fused with the transfer to t_prev."""
    if not x.is_cuda:
        return plms_update_reference(x, e, h2, h1, h0, w0, w1, w2, w3, den,
                                     c_d, c_x, c_e)
    return _launch_elementwise("plms_update", "plms", (x, e, h2, h1, h0),
                               (w0, w1, w2, w3, den, c_d, c_x, c_e))


def ddpm_update_reference(x, e, noise, a, b, c1, c2, sigma):
    x0 = torch.clamp(a * x - b * e, -1.0, 1.0)
    return c1 * x0 + c2 * x + sigma * noise


def ddpm_update(x, e, noise, a, b, c1, c2, sigma):
    """K2-naive: one DDPM ancestral step at integer t (the 1-step posterior
    coefficients at t; sigma = 0 at t = 0)."""
    if not x.is_cuda:
        return ddpm_update_reference(x, e, noise, a, b, c1, c2, sigma)
    return _launch_elementwise("ddpm_update", "ddpm", (x, e, noise),
                               (a, b, c1, c2, sigma))


def naive_step_table(coeffs: "ScheduleCoefficients") -> dict:
    """Per-t scalars of ``ddpm_update`` from the float32 tables: a, b, c1,
    c2 and sigma = exp(0.5 log_var), 0 at t = 0."""
    f32 = {k: getattr(coeffs, k).astype(np.float32) for k in (
        "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
        "posterior_mean_coef1", "posterior_mean_coef2",
        "posterior_log_variance_clipped")}
    sigma = np.exp(np.float32(0.5) * f32["posterior_log_variance_clipped"])
    sigma[0] = 0.0
    return dict(a=f32["sqrt_recip_alphas_cumprod"],
                b=f32["sqrt_recipm1_alphas_cumprod"],
                c1=f32["posterior_mean_coef1"], c2=f32["posterior_mean_coef2"],
                sigma=sigma.astype(np.float32))


def _t_batch(x, t) -> torch.Tensor:
    return torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)


def sample_plms(x, denoise, ts, interval: int, acp: np.ndarray) -> torch.Tensor:
    """PLMS multistep sampling over the integer steps ``ts`` (descending):
    two denoiser evals on the first step, one after; a 3-slot eps history.
    ``acp`` is the float32 ``alphas_cumprod``."""
    hist = []
    for stage, t in enumerate(int(t) for t in ts):
        t_prev = max(t - interval, 0)
        transfer = plms_transfer(acp, t, t_prev)
        eps = denoise(x, _t_batch(x, t))
        if stage == 0:
            x_pred = plms_update(x, eps, eps, eps, eps, *PLMS_FIRST, *transfer)
            eps_prev = denoise(x_pred, _t_batch(x, t_prev))
            x_new = plms_update(x, eps, eps_prev, eps, eps, *PLMS_AVERAGE, *transfer)
        else:
            h = [eps] * (3 - len(hist)) + hist  # weight 0 on missing slots
            x_new = plms_update(x, eps, h[2], h[1], h[0],
                                *PLMS_WEIGHTS[min(stage, 3) - 1], *transfer)
        hist = (hist + [eps])[-3:]
        x = x_new
    return x


def sample_naive(x, denoise, ts, table: dict, generator=None) -> torch.Tensor:
    """DDPM ancestral sampling over the integer steps ``ts`` (descending),
    one noise draw per step from ``generator``."""
    for t in (int(t) for t in ts):
        eps = denoise(x, _t_batch(x, t))
        noise = torch.randn(x.shape, generator=generator, device=x.device)
        x = ddpm_update(x, eps, noise, *(float(table[k][t]) for k in (
            "a", "b", "c1", "c2", "sigma")))
    return x


# ---------------------------------------------------------------------------
# The diffusion module
# ---------------------------------------------------------------------------


@DIFFUSIONS.register_module()
class GaussianDiffusion(nn.Module):
    """DDPM over mel normalized to [-1, 1]; ``forward`` runs the reverse
    process from x_T to a denormalized mel [B, T, M]."""

    def __init__(
        self,
        denoiser: dict,
        mel_channels: int = 128,
        noise_schedule: str = "linear",
        timesteps: int = 1000,
        max_beta: float = 0.01,
        s: float = 0.008,
        noise_loss="l1",  # the training loss; accepted for the configs
        sampler_interval: int = 10,
        spec_stats_path: str = "dataset/stats.json",
        spec_min: Optional[Sequence[float]] = None,
        spec_max: Optional[Sequence[float]] = None,
        noise_predictor: Optional[str] = None,
        unipc_variant: str = "bh2",
        unipc_order: int = 2,
    ):
        super().__init__()
        if unipc_variant not in ("bh1", "bh2"):
            raise ValueError(f"unsupported unipc_variant {unipc_variant!r}")
        if not 1 <= unipc_order <= 3:
            raise ValueError(f"unsupported unipc_order {unipc_order}")
        self.mel_channels = mel_channels
        self.timesteps = timesteps
        self.sampler_interval = sampler_interval
        self.unipc_variant = unipc_variant
        self.unipc_order = unipc_order
        self.denoise_fn = DENOISERS.build(dict(denoiser))

        betas = get_noise_schedule_list(
            noise_schedule, timesteps, max_beta, s
        ).astype(np.float64)
        self.coeffs = ScheduleCoefficients(betas)

        if spec_min is None:
            with open(spec_stats_path) as f:
                stats = json.load(f)
            spec_min, spec_max = stats["spec_min"], stats["spec_max"]
        if len(spec_min) != len(spec_max) or len(spec_min) not in (1, mel_channels):
            raise ValueError("spec_min/spec_max must have length 1 or mel_channels")
        self.register_buffer(
            "spec_min", torch.tensor(spec_min, dtype=torch.float32).view(1, 1, -1),
            persistent=False,
        )
        self.register_buffer(
            "spec_max", torch.tensor(spec_max, dtype=torch.float32).view(1, 1, -1),
            persistent=False,
        )

        if noise_predictor is None:
            noise_predictor = "naive" if sampler_interval == 1 else "unipc"
        self.noise_predictor = noise_predictor

    def norm_spec(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2 - 1

    def denorm_spec(self, x):
        return (x + 1) / 2 * (self.spec_max - self.spec_min) + self.spec_min

    def q_sample(self, x_start, t, noise):
        """Noising to integer step t [B]."""
        c = self.coeffs
        shape = (-1,) + (1,) * (x_start.ndim - 1)
        sqrt_acp = torch.tensor(c.sqrt_alphas_cumprod, dtype=torch.float32,
                                device=x_start.device)
        sqrt_1macp = torch.tensor(c.sqrt_one_minus_alphas_cumprod,
                                  dtype=torch.float32, device=x_start.device)
        return sqrt_acp[t].view(shape) * x_start + sqrt_1macp[t].view(shape) * noise

    def forward(
        self,
        features: torch.Tensor,
        sampler_interval: Optional[int] = None,
        skip_steps: int = 0,
        original_mel: Optional[torch.Tensor] = None,
        noise_predictor: Optional[str] = None,
        x_masks: Optional[torch.Tensor] = None,
        cond_masks: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Reverse diffusion to a denormalized mel [B, T, M]. x_T is drawn
        from ``generator`` unless given or unless ``original_mel`` [B, T, M]
        is (shallow diffusion: the warm start is ``original_mel`` noised to
        step T - ``skip_steps``)."""
        sampler_interval = sampler_interval or self.sampler_interval
        predictor = (noise_predictor or self.noise_predictor).lower()
        if predictor not in ("unipc", "plms", "naive"):
            raise NotImplementedError(f"unknown noise predictor {predictor!r}")

        if original_mel is not None:
            x = self.norm_spec(original_mel.float())
        elif x_T is not None:
            x = x_T.float()
        else:
            t_ref = x_masks if x_masks is not None else features
            shape = (features.shape[0], t_ref.shape[1], self.mel_channels)
            x = torch.randn(shape, generator=generator, device=features.device)
        if skip_steps:
            t = torch.full((x.shape[0],), self.timesteps - skip_steps,
                           dtype=torch.long, device=x.device)
            noise = torch.randn(x.shape, generator=generator, device=x.device)
            x = self.q_sample(x, t, noise)
        ts = np.arange(0, self.timesteps - skip_steps, sampler_interval)[::-1]

        plan = self.denoise_fn.prepare(features, cond_masks)

        def denoise(xt, tb):
            return self.denoise_fn(xt, tb, None, x_masks=x_masks, plan=plan)

        x = x.contiguous()
        if predictor == "naive":
            x = sample_naive(x, denoise, ts, naive_step_table(self.coeffs), generator)
        elif predictor == "plms":
            x = sample_plms(x, denoise, ts, sampler_interval,
                            self.coeffs.alphas_cumprod.astype(np.float32))
        else:
            steps = self.timesteps // sampler_interval
            t_start = None
            if skip_steps:
                steps = max((self.timesteps - skip_steps) // sampler_interval, 2)
                t_start = (self.timesteps - skip_steps) / self.timesteps
            table = unipc_step_table(self.coeffs, steps, t_start,
                                     variant=self.unipc_variant,
                                     order=self.unipc_order)
            x = sample_unipc(x, denoise, table)
        return self.denorm_spec(x)
