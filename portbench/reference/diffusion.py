"""The sampler and the training step in plain PyTorch, float32, beside
`model.py`: the cosine beta schedule, DDIM (eta 0), DPM-Solver++ with
multistep updates up to order 2 and the denoise-to-zero step, the map
transforms, the MSE loss and Adam after a global-norm clip with optax's
semantics (reference `diffusion_trainer.py`, `models/dpm_solver/
sampler.py`, `util/utils.py:116-123`, `cfgs/diffusion.yml`).

Every coefficient of the samplers is a float64 number worked out on the
host from the float32 tables, so the reverse process is a fixed chain of
denoiser calls and elementwise updates.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cosine_betas(T: int) -> np.ndarray:
    """The reference's cosine schedule, evaluated on linspace(0, T+1, T+1)."""
    steps = T + 1
    x = np.linspace(0, steps, steps)
    ac = np.cos(((x / steps) + 0.008) / 1.008 * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    return np.clip(1.0 - ac[1:] / ac[:-1], 0, 0.999)


class Schedule:
    """The float32 tables of a cosine schedule of T steps."""

    def __init__(self, T: int = 1000):
        self.T = T
        self.betas = cosine_betas(T).astype(np.float32)
        self.alphas_hat = np.cumprod(1.0 - self.betas, axis=0)
        self.sqrt_alphas_hat = np.sqrt(self.alphas_hat)
        self.sqrt_one_minus = np.sqrt(1.0 - self.alphas_hat)
        self.sqrt_recip = np.sqrt(1.0 / self.alphas_hat)
        self.sqrt_recipm1 = np.sqrt(1.0 / self.alphas_hat - 1.0)

    def q_sample(self, x0, t, noise):
        a = torch.from_numpy(self.sqrt_alphas_hat).to(x0.device)[t]
        s = torch.from_numpy(self.sqrt_one_minus).to(x0.device)[t]
        return a * x0 + s * noise


def ddim(schedule: Schedule, denoise, x, steps: int = 1):
    """DDIM with eta 0 on an x0-predicting denoiser; the last step returns
    its x0 estimate."""
    T = schedule.T
    skip = T // steps
    seq = list(range(0, T, skip))
    pairs = list(zip(reversed(seq), reversed([-1] + seq[:-1])))
    ah = schedule.alphas_hat.astype(np.float64)
    for time, time_next in pairs:
        x0 = denoise(x, torch.full((x.shape[0],), float(time), device=x.device))
        if time_next < 0:
            return x0
        eps = (float(schedule.sqrt_recip[time]) * x - x0) / float(schedule.sqrt_recipm1[time])
        x = float(np.sqrt(ah[time_next])) * x0 + float(np.sqrt(1.0 - ah[time_next])) * eps
    return x


class VP:
    """Continuous-time view of the discrete schedule, the tail where
    logSNR < -5.1 dropped (reference sampler.py, schedule='discrete')."""

    def __init__(self, betas: np.ndarray, clip: float = -5.1):
        la = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas, np.float64)))
        N = len(betas)
        ts = np.linspace(0.0, 1.0, N + 1)[1:]
        lam = la - 0.5 * np.log(1.0 - np.exp(2.0 * la))
        keep = int(np.sum(lam > clip))
        self.N, self.ts, self.la = N, ts[:keep], la[:keep]
        self.T, self.t0 = float(self.ts[-1]), 1.0 / N

    def log_alpha(self, t):
        return np.interp(t, self.ts, self.la)

    def alpha(self, t):
        return float(np.exp(self.log_alpha(t)))

    def sigma(self, t):
        return float(np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t))))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))

    def inverse_lam(self, lamb):
        lams = self.lam(self.ts)
        return np.interp(lamb, lams[::-1], self.ts[::-1])


def dpm_solver_pp(schedule: Schedule, denoise, x, nfe: int, order: int = 2):
    """DPM-Solver++ on an x0-predicting denoiser: `nfe - 1` multistep
    updates over logSNR-uniform times (the first of order 1), then the
    denoise-to-zero call: `nfe` denoiser calls in all."""
    vp = VP(schedule.betas)
    steps = max(nfe - 1, 1)
    order = min(order, steps)
    ts = vp.inverse_lam(np.linspace(vp.lam(vp.T), vp.lam(vp.t0), steps + 1))

    def model(x, t):
        return denoise(x, torch.full((x.shape[0],), float((t - 1.0 / vp.N) * 1000.0),
                                     dtype=torch.float32, device=x.device))

    def update(x, t_list, m_list, t, o):
        s0 = t_list[-1]
        a_t, sig_t = vp.alpha(t), vp.sigma(t)
        h = float(vp.lam(t) - vp.lam(s0))
        phi = math.expm1(-h)
        x = (sig_t / vp.sigma(s0)) * x - a_t * phi * m_list[-1]
        if o == 2:
            r0 = float(vp.lam(s0) - vp.lam(t_list[-2])) / h
            x = x - 0.5 * a_t * phi * (1.0 / r0) * (m_list[-1] - m_list[-2])
        return x

    t_list, m_list = [float(ts[0])], [model(x, float(ts[0]))]
    for i in range(1, steps + 1):
        t = float(ts[i])
        x = update(x, t_list, m_list, t, min(i, order))
        t_list.append(t)
        m_list.append(model(x, t) if i < steps else None)
        t_list, m_list = t_list[-order:], m_list[-order:]
    return model(x, vp.t0)


def sample(model, schedule: Schedule, sampler: dict, rgb, audio, noise):
    """The map of one batch: encode once, run the sampler, clamp to [0, 1]."""
    feats = model.encode_visual(rgb)
    audio_feat = model.encode_audio(audio) if audio is not None and model.audio_net else None

    def denoise(x, t):
        return model.denoise(x, t, feats, audio_feat)

    x = noise.float()
    if sampler["kind"] == "ddim":
        x = ddim(schedule, denoise, x, sampler["nfe"])
    elif sampler["kind"] == "dpmsolver++":
        x = dpm_solver_pp(schedule, denoise, x, sampler["nfe"], sampler.get("order", 2))
    else:
        raise ValueError(f"unknown sampler {sampler['kind']!r}")
    return torch.clamp(x, 0.0, 1.0)


def mse_loss(pred, gt):
    """Summed over the pixels, averaged over the batch."""
    return ((pred - gt) ** 2).reshape(pred.shape[0], -1).sum(1).mean()


class Adam:
    """Adam (beta2 0.999) after a global-norm clip, as optax chains them:
    the gradients scaled by clip / norm where norm >= clip, bias
    corrections with the count from 1, eps outside the square root.
    `step` returns the gradients as it got them, before the clip."""

    def __init__(self, params, lr, b1=0.9, eps=1e-8, clip=1.0):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.b1, self.eps, self.clip = lr, b1, eps, clip
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        raw = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in raw)).float()
        grads = raw
        if self.clip and norm >= self.clip:
            grads = [g * (self.clip / norm) for g in raw]
        self.count += 1
        bc1 = 1.0 - float(np.float32(self.b1) ** self.count)
        bc2 = 1.0 - float(np.float32(0.999) ** self.count)
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))
        return raw


def train_step(model, schedule: Schedule, opt: Adam, batch: dict, generator):
    """One step of the reference trainer on `batch` (rgb, salmap[, audio]),
    its random draws from `generator` in the port's order: the
    dequantisation noise, the batch's one timestep, the x_T noise, then
    the dropout and DropPath masks inside the model. Returns (loss, the
    gradients before the clip)."""
    dev = generator.device
    sal = batch["salmap"].float()
    x0 = sal + torch.randn(sal.shape, generator=generator, device=dev) * 0.01
    t = torch.randint(0, schedule.T, (), generator=generator, device=dev).long()
    noise = torch.randn(x0.shape, generator=generator, device=dev)
    x_t = schedule.q_sample(x0, t, noise)
    tvec = t.expand(x0.shape[0]).float()
    model.train()
    pred = model(batch["rgb"], x_t, tvec, batch.get("audio"), train=True, generator=generator)
    loss = mse_loss(pred, x0)
    for p in opt.params:
        p.grad = None
    loss.backward()
    return loss.detach(), opt.step()
