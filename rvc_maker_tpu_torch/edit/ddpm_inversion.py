"""Edit-friendly DDPM inversion in PyTorch (counterpart of JAX
`edit/ddpm_inversion.py`).

The reference's AudioLDM2 editing core (main/inference/audioldm2.py
inversion_forward_process:130-174 / inversion_reverse_process:176-209,
main/library/audioldm2/models.py:60-112): draw independent x_t marginals
from x0, extract the per-step noises z_t that make the DDPM reverse
chain reproduce them exactly, then re-run the reverse chain under a
different prompt with the same z_t.

The denoiser is any callable ``eps_fn(x, t) -> (uncond_eps, cond_eps)``
on tensors; the scheduler tables are JAX's float64 numpy arrays, copied.
Each scalar of the step math is rounded as JAX rounds it: a Python
float64 cast to fp32, then `sqrt` in fp32 (`_sqrt32`).

The marginals' noise: JAX draws it with `jax.random.normal`, which torch
cannot reproduce, so `sample_xts_from_x0` takes either a torch.Generator
or that noise as a tensor of shape (N, *x0.shape); the tests pass JAX's
draw in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Precomputed DDIM scheduler tables (diffusers DDIMScheduler
    semantics with leading timestep spacing)."""

    alphas_cumprod: np.ndarray           # (num_train_timesteps,) float64
    timesteps: np.ndarray                # (num_inference_steps,) descending
    num_train_timesteps: int
    num_inference_steps: int
    final_alpha_cumprod: float

    def alpha_prod(self, t: int) -> float:
        return float(self.alphas_cumprod[t])

    def prev_timestep(self, t: int) -> int:
        return t - self.num_train_timesteps // self.num_inference_steps

    def alpha_prod_prev(self, t: int) -> float:
        prev = self.prev_timestep(t)
        return (float(self.alphas_cumprod[prev]) if prev >= 0
                else self.final_alpha_cumprod)

    def variance(self, t: int) -> float:
        """DDIM posterior variance (diffusers DDIMScheduler._get_variance)."""
        a_t = self.alpha_prod(t)
        a_prev = self.alpha_prod_prev(t)
        beta_t = 1.0 - a_t
        beta_prev = 1.0 - a_prev
        return (beta_prev / beta_t) * (1.0 - a_t / a_prev)


def make_schedule(num_inference_steps: int, *,
                  num_train_timesteps: int = 1000,
                  beta_start: float = 0.0015, beta_end: float = 0.0195,
                  beta_schedule: str = "scaled_linear",
                  steps_offset: int = 1,
                  set_alpha_to_one: bool = False) -> DDIMSchedule:
    """Defaults follow the audioldm2 DDIMScheduler config."""
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2
    elif beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps + 1) / num_train_timesteps
        f = np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(num_inference_steps) * step_ratio).round()
    timesteps = (timesteps[::-1].astype(np.int64) + steps_offset)
    timesteps = np.clip(timesteps, 0, num_train_timesteps - 1)
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    return DDIMSchedule(alphas_cumprod=alphas_cumprod, timesteps=timesteps,
                        num_train_timesteps=num_train_timesteps,
                        num_inference_steps=num_inference_steps,
                        final_alpha_cumprod=final)


def _sqrt32(v: float) -> float:
    """sqrt as `jnp.sqrt` takes it of a Python float: cast to fp32 first,
    then rounded in fp32 (the result is exact in fp32)."""
    return float(np.sqrt(np.float32(v)))


def sample_xts_from_x0(rng: torch.Generator | torch.Tensor, x0: torch.Tensor,
                       sched: DDIMSchedule):
    """Independent forward marginals x_t ~ q(x_t | x0) for every inference
    timestep (models.py:60-71).  rng: a torch.Generator or the noise
    itself, (N, *x0.shape).  Returns (N+1, *x0.shape) with xts[0] = x0,
    xts[idx] at increasing noise."""
    n = sched.num_inference_steps
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != (n, *x0.shape):
            raise ValueError(f"noise must be {(n, *x0.shape)}, got {tuple(rng.shape)}")
        noise = rng.to(device=x0.device, dtype=x0.dtype)
    else:
        noise = torch.randn((n, *x0.shape), generator=rng, device=x0.device, dtype=x0.dtype)
    a = torch.tensor(np.asarray(sched.alphas_cumprod[sched.timesteps], np.float32),
                     device=x0.device).to(x0.dtype)        # (N,) descending t
    # idx = n - position; timesteps descending -> idx 1..n ascending noise
    scale = torch.sqrt(a).flip(0)[:, None]
    sigma = torch.sqrt(1.0 - a).flip(0)[:, None]
    flat = x0.reshape(-1)
    xts = scale * flat[None] + sigma * noise.reshape(n, -1)
    return torch.cat([flat[None], xts], dim=0).reshape(n + 1, *x0.shape)


def _pred_x0(xt, eps, a_t: float):
    return (xt - _sqrt32(1.0 - a_t) * eps) / _sqrt32(a_t)


def _guided(eps_fn: Callable, x, t: int, cfg_scale: float):
    uncond, cond = eps_fn(x, t)
    return uncond if cond is None else uncond + cfg_scale * (cond - uncond)


def inversion_forward(eps_fn: Callable, x0, sched: DDIMSchedule, *,
                      cfg_scale: float = 3.5,
                      etas: float | Sequence[float] = 1.0,
                      rng: torch.Generator | torch.Tensor | None = None,
                      numerical_fix: bool = False, zero_first: bool = True):
    """Extract the edit-friendly noise maps (audioldm2.py:130-174).

    eps_fn(xt, t) -> (uncond_eps, cond_eps); cond_eps None for an
    unconditional inversion.  rng: a torch.Generator, the marginals'
    noise (N, *x0.shape), or None (a generator on x0's device seeded 0).
    Returns (xT, zs, xts): zs[idx] is the noise that reproduces xts[idx]
    from xts[idx+1] in the reverse chain."""
    if rng is None:
        rng = torch.Generator(device=x0.device).manual_seed(0)
    n = sched.num_inference_steps
    if isinstance(etas, (int, float)):
        etas = [float(etas)] * n
    xts = list(sample_xts_from_x0(rng, x0, sched))       # mutable per index
    zs = [None] * n
    for pos, t in enumerate(sched.timesteps):
        idx = n - pos - 1
        t = int(t)
        xt = xts[idx + 1]
        noise_pred = _guided(eps_fn, xt, t, cfg_scale)
        a_prev, var = sched.alpha_prod_prev(t), sched.variance(t)
        mu = (_sqrt32(a_prev) * _pred_x0(xt, noise_pred, sched.alpha_prod(t))
              + _sqrt32(1.0 - a_prev - etas[idx] * var) * noise_pred)
        z = (xts[idx] - mu) / (etas[idx] * var ** 0.5)
        zs[idx] = z
        if numerical_fix:
            xts[idx] = mu + etas[idx] * var ** 0.5 * z
    if zero_first:
        zs[0] = torch.zeros_like(zs[0])    # reference audioldm2.py:173
    return xts[-1], torch.stack(zs), torch.stack(xts)


def reverse_step(eps, t: int, xt, sched: DDIMSchedule, *,
                 variance_noise=None, eta: float = 0.0):
    """One DDIM/DDPM reverse step with caller-provided variance noise
    (models.py:92-112 reverse_step_with_custom_noise)."""
    a_prev, var = sched.alpha_prod_prev(t), sched.variance(t)
    prev = (_sqrt32(a_prev) * _pred_x0(xt, eps, sched.alpha_prod(t))
            + _sqrt32(1.0 - a_prev - eta * var) * eps)
    if eta > 0 and variance_noise is not None:
        prev = prev + eta * var ** 0.5 * variance_noise
    return prev


def inversion_reverse(eps_fn: Callable, xts, zs, sched: DDIMSchedule, *,
                      tstart: int, cfg_scale: float = 12.0,
                      etas: float | Sequence[float] = 1.0):
    """Re-run the reverse chain from noise level xts[tstart] under a
    (different) prompt with the stored noise maps (audioldm2.py:176-209).
    tstart: how many inference steps of noise the edit starts from —
    larger changes more of the source."""
    n = sched.num_inference_steps
    if isinstance(etas, (int, float)):
        etas = [float(etas)] * n
    xt = xts[tstart]
    for k, t in enumerate(sched.timesteps[n - tstart:]):
        idx = tstart - k - 1
        noise_pred = _guided(eps_fn, xt, int(t), cfg_scale)
        xt = reverse_step(noise_pred, int(t), xt, sched,
                          variance_noise=zs[idx], eta=etas[idx])
    return xt


def low_pass_filter(audio: np.ndarray, cutoff: float = 7500.0,
                    sr: int = 16000) -> np.ndarray:
    """Output polish filter on the host (reference audioldm2.py:94-96)."""
    from scipy.signal import butter, filtfilt

    b, a = butter(4, cutoff / (sr / 2), btype="low")
    return filtfilt(b, a, audio).astype(audio.dtype)
