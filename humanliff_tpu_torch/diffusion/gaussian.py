"""DDPM ancestral and DDIM sampling with x_cond threaded through (port of
``humanliff_tpu/diffusion/gaussian.py``; reference improved_diffusion/
gaussian_diffusion.py).

Schedule constants are float64 numpy on the host and become fp32 device
tensors once per device, so the sampling loop makes no host round trip.
Samples are NHWC, so the learned-sigma split is on the last axis.

Model callable: ``model_fn(x, t_scaled, x_cond, **model_kwargs) -> output``,
where ``t_scaled`` already carries the respacing map and the [0, 1000) rescale.

Noise: JAX draws each step's noise from ``jax.random.split(k_loop, T)``,
which torch cannot reproduce. The sampling loops (ancestral, DDIM, and their
progressive forms) draw from a ``torch.Generator``, or take the initial noise
and a per-step noise source from the caller, which is how the tests feed both
packages the same noise. A DDIM step draws its noise at any ``eta``, as JAX
splits a key for it, so one noise source serves every loop.

Training (``training_losses``, gaussian_diffusion.py:688-772) and the
bits-per-dim loop (``calc_bpd_loop``) take their noise from the caller or
from a ``torch.Generator``, for the same reason.
"""

from __future__ import annotations

import enum
import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from humanliff_tpu_torch.diffusion.losses import (
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
)

ModelFn = Callable[..., torch.Tensor]
StepNoise = Union[Sequence[torch.Tensor], Callable[[int], torch.Tensor]]


class ModelMeanType(enum.Enum):
    """What the model predicts."""

    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()  # MSE, plus the vb term scaled by T / 1000 (learned sigma)
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


class GaussianDiffusion:
    def __init__(
        self,
        betas: np.ndarray,
        model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
        model_var_type: ModelVarType = ModelVarType.FIXED_LARGE,
        loss_type: LossType = LossType.MSE,
        rescale_timesteps: bool = True,
        timestep_map: Optional[np.ndarray] = None,
        original_num_steps: Optional[int] = None,
    ):
        betas = np.asarray(betas, np.float64)
        if not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must lie in (0, 1]")
        self.betas = betas
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        self.rescale_timesteps = rescale_timesteps
        self.timestep_map = timestep_map
        self.original_num_steps = original_num_steps
        self.num_timesteps = int(betas.shape[0])

        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        self.alphas_cumprod = ac
        self.alphas_cumprod_prev = ac_prev
        self.sqrt_alphas_cumprod = np.sqrt(ac)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - ac)
        self.one_minus_alphas_cumprod = 1.0 - ac
        self.log_one_minus_alphas_cumprod = np.log(1.0 - ac)
        with np.errstate(divide="ignore"):  # beta_T == 1 in tiny-T schedules
            self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / ac)
            self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / ac - 1)
        pv = betas * (1.0 - ac_prev) / (1.0 - ac)
        self.posterior_variance = pv
        self.posterior_log_variance_clipped = np.log(np.append(pv[1], pv[1:]))
        self.posterior_mean_coef1 = betas * np.sqrt(ac_prev) / (1.0 - ac)
        self.posterior_mean_coef2 = (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)
        self.recip_posterior_mean_coef1 = 1.0 / self.posterior_mean_coef1
        self.posterior_mean_coef_ratio = self.posterior_mean_coef2 / self.posterior_mean_coef1
        self.fixed_large_variance = np.append(pv[1], betas[1:])
        self.fixed_large_log_variance = np.log(self.fixed_large_variance)
        self._device_tables: Dict[Any, Dict[str, torch.Tensor]] = {}

    # ---------------- schedule tables on the device ----------------

    def _table(self, name: str, device) -> torch.Tensor:
        tables = self._device_tables.setdefault(torch.device(device), {})
        if name not in tables:
            arr = np.log(self.betas) if name == "log_betas" else getattr(self, name)
            dtype = torch.int64 if name == "timestep_map" else torch.float32
            tables[name] = torch.as_tensor(np.asarray(arr)).to(device=device, dtype=dtype)
        return tables[name]

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        out = self._table(name, t.device)[t]
        return out.reshape(t.shape[0], *([1] * (ndim - 1)))

    # ---------------- forward process ----------------

    def q_mean_variance(self, x_start, t):
        mean = self._extract("sqrt_alphas_cumprod", t, x_start.dim()) * x_start
        variance = self._extract("one_minus_alphas_cumprod", t, x_start.dim())
        log_variance = self._extract("log_one_minus_alphas_cumprod", t, x_start.dim())
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        """Diffuse x_start for t steps (gaussian_diffusion.py:188-207)."""
        return (self._extract("sqrt_alphas_cumprod", t, x_start.dim()) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.dim()) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (self._extract("posterior_mean_coef1", t, x_t.dim()) * x_start
                + self._extract("posterior_mean_coef2", t, x_t.dim()) * x_t)
        variance = self._extract("posterior_variance", t, x_t.dim())
        log_variance = self._extract("posterior_log_variance_clipped", t, x_t.dim())
        return mean, variance, log_variance

    # ---------------- model wrapping ----------------

    def scale_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Respacing map, then the optional float rescale to [0, 1000)."""
        if self.timestep_map is not None:
            t = self._table("timestep_map", t.device)[t]
        if self.rescale_timesteps:
            n = self.original_num_steps or self.num_timesteps
            return t.float() * (1000.0 / n)
        return t

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (self._extract("sqrt_recip_alphas_cumprod", t, x_t.dim()) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.dim()) * eps)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        return (self._extract("recip_posterior_mean_coef1", t, x_t.dim()) * xprev
                - self._extract("posterior_mean_coef_ratio", t, x_t.dim()) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return ((self._extract("sqrt_recip_alphas_cumprod", t, x_t.dim()) * x_t - pred_xstart)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.dim()))

    def p_mean_variance(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        t: torch.Tensor,
        x_cond=None,
        clip_denoised: bool = True,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Posterior p(x_{t-1} | x_t) from the model output (gaussian_diffusion.py:232-326)."""
        model_kwargs = model_kwargs or {}
        model_output = model_fn(x, self.scale_timesteps(t), x_cond, **model_kwargs)

        if self.model_var_type == ModelVarType.LEARNED:
            model_output, model_log_variance = torch.chunk(model_output, 2, dim=-1)
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.LEARNED_RANGE:
            model_output, var_values = torch.chunk(model_output, 2, dim=-1)
            min_log = self._extract("posterior_log_variance_clipped", t, x.dim())
            max_log = self._extract("log_betas", t, x.dim())
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            if self.model_var_type == ModelVarType.FIXED_LARGE:
                var, logvar = "fixed_large_variance", "fixed_large_log_variance"
            else:
                var, logvar = "posterior_variance", "posterior_log_variance_clipped"
            model_variance = self._extract(var, t, x.dim()) * torch.ones_like(x)
            model_log_variance = self._extract(logvar, t, x.dim()) * torch.ones_like(x)

        def process_xstart(xs):
            return xs.clamp(-1, 1) if clip_denoised else xs

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = process_xstart(model_output)
            else:
                pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)

        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    # ---------------- sampling ----------------

    def p_sample(self, model_fn, x, x_cond, t, noise, clip_denoised=True, model_kwargs=None):
        """One ancestral step with the given standard-normal ``noise``."""
        out = self.p_mean_variance(model_fn, x, t, x_cond, clip_denoised, model_kwargs)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return sample, out["pred_xstart"]

    def ddim_sample(self, model_fn, x, x_cond, t, noise, clip_denoised=True,
                    eta: float = 0.0, model_kwargs=None):
        """One DDIM step (gaussian_diffusion.py:488-529); ``eta`` scales the
        standard-normal ``noise``, and eta = 0 is the deterministic sampler."""
        out = self.p_mean_variance(model_fn, x, t, x_cond, clip_denoised, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._extract("alphas_cumprod", t, x.dim())
        alpha_bar_prev = self._extract("alphas_cumprod_prev", t, x.dim())
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
        return mean_pred + nonzero * sigma * noise, out["pred_xstart"]

    @torch.no_grad()
    def _progressive(self, step, shape, generator, noise, step_noise, device):
        """Yield ``{"sample", "pred_xstart"}`` after each step ``step(x, t, eps)``
        from t = T-1 down to 0. ``noise`` is x_T; ``step_noise[i]`` (or
        ``step_noise(i)``) the noise of the i-th step taken (t = T-1-i). Either
        one missing is drawn from ``generator`` on ``device``."""
        def normal():
            return torch.randn(shape, generator=generator, device=device)

        x = normal() if noise is None else noise.to(device=device, dtype=torch.float32)
        for i in range(self.num_timesteps):
            t = torch.full((shape[0],), self.num_timesteps - 1 - i, dtype=torch.int64,
                           device=device)
            if step_noise is None:
                eps = normal()
            else:
                eps = step_noise(i) if callable(step_noise) else step_noise[i]
                eps = eps.to(device=device, dtype=torch.float32)
            x, pred_xstart = step(x, t, eps)
            yield {"sample": x, "pred_xstart": pred_xstart}

    def p_sample_loop_progressive(
        self,
        model_fn: ModelFn,
        shape,
        generator: Optional[torch.Generator] = None,
        x_cond=None,
        noise: Optional[torch.Tensor] = None,
        step_noise: Optional[StepNoise] = None,
        clip_denoised: bool = True,
        model_kwargs: Optional[Dict[str, Any]] = None,
        device="cuda",
    ):
        """Ancestral sampling that yields ``{"sample", "pred_xstart"}`` after
        every step (gaussian_diffusion.py:445-482); noise as in :meth:`p_sample_loop`."""
        def step(x, t, eps):
            return self.p_sample(model_fn, x, x_cond, t, eps, clip_denoised, model_kwargs)

        return self._progressive(step, shape, generator, noise, step_noise, device)

    def ddim_sample_loop_progressive(
        self,
        model_fn: ModelFn,
        shape,
        generator: Optional[torch.Generator] = None,
        x_cond=None,
        noise: Optional[torch.Tensor] = None,
        step_noise: Optional[StepNoise] = None,
        clip_denoised: bool = True,
        eta: float = 0.0,
        model_kwargs: Optional[Dict[str, Any]] = None,
        device="cuda",
    ):
        """The DDIM twin of :meth:`p_sample_loop_progressive`
        (gaussian_diffusion.py:617-651)."""
        def step(x, t, eps):
            return self.ddim_sample(model_fn, x, x_cond, t, eps, clip_denoised, eta,
                                    model_kwargs)

        return self._progressive(step, shape, generator, noise, step_noise, device)

    def p_sample_loop(self, model_fn: ModelFn, shape, generator=None, x_cond=None,
                      noise=None, step_noise=None, clip_denoised: bool = True,
                      model_kwargs=None, device="cuda") -> torch.Tensor:
        """Ancestral sampling from t = T-1 down to 0 (gaussian_diffusion.py:390-482).

        ``noise`` is x_T; ``step_noise[i]`` (or ``step_noise(i)``) the noise of
        the i-th step taken (t = T-1-i). Either one missing is drawn from
        ``generator`` on ``device``.
        """
        for out in self.p_sample_loop_progressive(model_fn, shape, generator, x_cond, noise,
                                                  step_noise, clip_denoised, model_kwargs,
                                                  device):
            pass
        return out["sample"]

    def ddim_sample_loop(self, model_fn: ModelFn, shape, generator=None, x_cond=None,
                         noise=None, step_noise=None, clip_denoised: bool = True,
                         eta: float = 0.0, model_kwargs=None, device="cuda") -> torch.Tensor:
        """DDIM sampling from t = T-1 down to 0 (gaussian_diffusion.py:569-615);
        noise as in :meth:`p_sample_loop`."""
        for out in self.ddim_sample_loop_progressive(model_fn, shape, generator, x_cond,
                                                     noise, step_noise, clip_denoised, eta,
                                                     model_kwargs, device):
            pass
        return out["sample"]

    # ---------------- losses ----------------

    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, x_cond=None, clip_denoised=True,
                      model_kwargs=None):
        """The variational bound term in bits per dim: KL(q(x_{t-1}|x_t, x_0) ||
        p(x_{t-1}|x_t)), or the decoder NLL at t = 0 (gaussian_diffusion.py:654-686)."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, x_cond, clip_denoised, model_kwargs)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn: ModelFn, x_start, x_cond, t,
                        model_kwargs: Optional[Dict[str, Any]] = None,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Per-example training losses (gaussian_diffusion.py:688-772): ``{"loss"}``,
        plus ``"mse"`` and, for a learned sigma, ``"vb"`` (its mean half detached).
        ``noise`` missing is drawn from ``generator``."""
        model_kwargs = model_kwargs or {}
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)

        terms: Dict[str, torch.Tensor] = {}
        if self.loss_type.is_vb():
            terms["loss"] = self._vb_terms_bpd(model_fn, x_start, x_t, t, x_cond, False,
                                               model_kwargs)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model_fn(x_t, self.scale_timesteps(t), x_cond, **model_kwargs)
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, var_values = torch.chunk(model_output, 2, dim=-1)
            # The vb term trains the variance only: the mean half is frozen.
            frozen = torch.cat([model_output.detach(), var_values], dim=-1)
            terms["vb"] = self._vb_terms_bpd(lambda *a, **k: frozen, x_start, x_t, t, x_cond,
                                             False)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    # ---------------- bits per dim ----------------

    def _prior_bpd(self, x_start: torch.Tensor) -> torch.Tensor:
        """KL(q(x_T | x_0) || N(0, I)) in bits per dim, per example
        (gaussian_diffusion.py:774-790)."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.int64,
                       device=x_start.device)
        mean, _, log_var = self.q_mean_variance(x_start, t)
        kl = normal_kl(mean, log_var, torch.zeros_like(mean), torch.zeros_like(log_var))
        return mean_flat(kl) / math.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn: ModelFn, x_start: torch.Tensor,
                      generator: Optional[torch.Generator] = None, x_cond=None,
                      clip_denoised: bool = True, model_kwargs: Optional[Dict[str, Any]] = None,
                      step_noise: Optional[StepNoise] = None) -> Dict[str, torch.Tensor]:
        """The whole variational bound in bits per dim (gaussian_diffusion.py:792-847):
        ``_vb_terms_bpd`` at every t from T-1 down to 0 on ``q_sample(x_start,
        t, noise)``, plus the prior term.

        Returns ``total_bpd`` and ``prior_bpd`` (B,), and ``vb``,
        ``xstart_mse`` and ``mse`` (the predicted noise's) (B, T), column i
        the i-th t taken (t = T-1-i), as the JAX function returns them.
        ``step_noise[i]`` (or ``step_noise(i)``) is the noise at the i-th t;
        missing, it is drawn from ``generator`` on x_start's device.
        """
        B = x_start.shape[0]
        vb, xstart_mse, eps_mse = [], [], []
        for i in range(self.num_timesteps):
            t = torch.full((B,), self.num_timesteps - 1 - i, dtype=torch.int64,
                           device=x_start.device)
            if step_noise is None:
                noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
            else:
                noise = step_noise(i) if callable(step_noise) else step_noise[i]
                noise = noise.to(device=x_start.device, dtype=torch.float32)
            x_t = self.q_sample(x_start, t, noise)
            out = self._vb_terms_bpd(model_fn, x_start, x_t, t, x_cond, clip_denoised,
                                     model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            eps_mse.append(mean_flat((eps - noise) ** 2))
        vb = torch.stack(vb, dim=1)
        prior_bpd = self._prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd, "vb": vb,
                "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(eps_mse, dim=1)}
