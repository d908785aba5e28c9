"""Gaussian diffusion over normalized mel (``fish_diffusion_tpu/models/diffusion.py``).

The schedule and the UniPC step table are host-side numpy float64, the
same algebra as the JAX package, cast to float32 where they meet the
device. The sampler is UniPC (bh1/bh2, orders 1-3, data prediction); its
per-step update is K2, two Triton kernels:

- ``unipc_predict``: x_pred = c_x x + c_m0 m0 + c_p0 D1s_0 + c_p1 D1s_1,
  with D1s_k = (m_{k+1} - m0) inv_rk_k; the final order-1 step too;
- ``unipc_correct``: m_t = (x_eval - sigma eps) / alpha (the data
  prediction), fused with the corrector x_new = c_x x + c_m0 m0
  + c_c0 D1s_0 + c_c1 D1s_1 + c_d1t (m_t - m0).

They replace the JAX package's ``_sample_unipc`` scan body
(``fish_diffusion_tpu/models/diffusion.py:462``). On an H100 the update is
bound by memory bandwidth: pure elementwise arithmetic over ``[B, T, 128]``
float32, a few tensors in and out, next to a 20-block denoiser eval. Each
pass reads each tensor once and writes its outputs once, with the step's
coefficients as scalar arguments. The data prediction is fused into the
corrector because the corrector is its first consumer: after each denoiser
eval the corrector finishes step i - 1 with it, then the predictor starts
step i from the corrected x. ``unipc_predict_reference`` and
``unipc_correct_reference`` are the plain versions; one step is the
corrector followed by the predictor.

PLMS and naive sampling and shallow diffusion are not ported yet (ROADMAP
Queue 1 items 4 and 6).
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


def _triton_kernels() -> dict:
    global tl
    if not _TRITON:
        import triton
        import triton.language

        tl = triton.language
        _TRITON["predict"] = triton.jit(_unipc_predict_kernel)
        _TRITON["correct"] = triton.jit(_unipc_correct_kernel)
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
    _check_same("unipc_predict", x, m0, m1, m2)
    out = torch.empty_like(x)
    n = x.numel()
    _triton_kernels()["predict"][(-(-n // _BLOCK),)](
        x, m0, m1, m2, out, n, c_x, c_m0, c_p0, c_p1, ir0, ir1, BLOCK=_BLOCK
    )
    kernels.count_launch("unipc_predict")
    return out


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
        """Reverse diffusion from x_T (drawn from ``generator`` unless
        given) to a denormalized mel [B, T, M]."""
        if skip_steps or original_mel is not None:
            raise NotImplementedError(
                "shallow diffusion needs the mel transform, which is not "
                "ported yet (ROADMAP Queue 1 item 6)"
            )
        sampler_interval = sampler_interval or self.sampler_interval
        predictor = (noise_predictor or self.noise_predictor).lower()
        if predictor != "unipc":
            raise NotImplementedError(
                f"the {predictor!r} sampler is not ported yet (ROADMAP Queue 1 "
                "item 4); use 'unipc'"
            )

        if x_T is None:
            t_ref = x_masks if x_masks is not None else features
            shape = (features.shape[0], t_ref.shape[1], self.mel_channels)
            x_T = torch.randn(shape, generator=generator, device=features.device)

        plan = self.denoise_fn.prepare(features, cond_masks)

        def denoise(xt, tb):
            return self.denoise_fn(xt, tb, None, x_masks=x_masks, plan=plan)

        table = unipc_step_table(
            self.coeffs,
            self.timesteps // sampler_interval,
            variant=self.unipc_variant,
            order=self.unipc_order,
        )
        return self.denorm_spec(sample_unipc(x_T.float(), denoise, table))
