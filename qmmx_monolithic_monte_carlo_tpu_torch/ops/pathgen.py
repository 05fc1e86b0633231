"""Price-path samplers: GBM closes with Brownian-bridge bar extremes.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pathgen.py:47-158``
(``PathBars``, ``VolumeModel``, ``gbm_paths``).  The bootstrap, block-bootstrap
and Heston samplers are not ported yet.

* ``gbm_bars_from_draws`` — the deterministic core: GBM closes from standard
  normals ``z``, per-bar highs/lows from the exact law of the max/min of a
  Brownian bridge between consecutive log-closes,
  ``M = ((a + b) + sqrt((b - a)^2 - 2 sigma^2 dt ln U)) / 2``.  The tests feed
  it the draws JAX itself made, so it is held against JAX ``gbm_paths``.
* ``gbm_paths`` — the same with Philox draws (``utils/prng.py``), one stream
  per consumer as in the JAX package.

All arithmetic is float32 in the JAX package's order; the log-price cumsum is
a serial float32 running sum (``cumsum_f32``), the order the CUDA kernel uses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import prng

F32 = torch.float32


class PathBars(NamedTuple):
    """Generated OHLCV paths: f32[paths, bars] each."""

    open: torch.Tensor
    high: torch.Tensor
    low: torch.Tensor
    close: torch.Tensor
    volume: torch.Tensor


def cumsum_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Serial float32 running sum along ``dim``.  ``torch.cumsum`` on the CPU
    accumulates float32 in float64; this keeps every partial sum in float32,
    as the CUDA kernel's register loop does."""
    x = x.movedim(dim, 0)
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        acc = acc + x[k]
        out[k] = acc
    return out.movedim(0, dim)


def gbm_consts(s0, mu: float, sigma: float, dt: float, device=None):
    """(drift, sig_dt, log_s0) as float32 0-d tensors, computed as
    ``ops/pathgen.gbm_paths`` computes them (float32 throughout)."""
    def f32(x):
        return torch.tensor(x, dtype=F32, device=device)

    sig_dt = f32(sigma) * torch.sqrt(f32(dt))
    drift = f32(mu - 0.5 * sigma * sigma) * f32(dt)
    return drift, sig_dt, torch.log(torch.as_tensor(s0, dtype=F32, device=device))


def bridge_extremes(u_hi, u_lo, log_a, log_b, sig2dt):
    """(log_high, log_low) of a Brownian bridge from ``log_a`` to ``log_b``
    with variance ``sig2dt``, by inverse CDF of the bridge max/min laws."""
    d2 = (log_b - log_a) ** 2
    log_hi = 0.5 * (log_a + log_b + torch.sqrt(d2 - 2.0 * sig2dt * torch.log(u_hi)))
    log_lo = 0.5 * (log_a + log_b - torch.sqrt(d2 - 2.0 * sig2dt * torch.log(u_lo)))
    return log_hi, log_lo


def gbm_bars_from_draws(z, u_hi, u_lo, *, s0, mu: float = 0.0,
                        sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                        volume=None) -> PathBars:
    """GBM bars from given draws, f32[paths, bars] each: ``z`` standard
    normals of the close-to-close shocks, ``u_hi``/``u_lo`` uniforms in (0, 1]
    for the bridge extremes.  ``volume`` defaults to zeros."""
    z = torch.as_tensor(z, dtype=F32)
    drift, sig_dt, log_s0 = gbm_consts(s0, mu, sigma, dt, device=z.device)
    log_close = log_s0 + cumsum_f32(drift + sig_dt * z, dim=-1)
    log_open = torch.cat(
        [log_s0.expand(*z.shape[:-1], 1), log_close[..., :-1]], dim=-1)
    log_hi, log_lo = bridge_extremes(
        torch.as_tensor(u_hi, dtype=F32), torch.as_tensor(u_lo, dtype=F32),
        log_open, log_close, sig_dt * sig_dt)
    return PathBars(
        open=torch.exp(log_open),
        high=torch.exp(log_hi),
        low=torch.exp(log_lo),
        close=torch.exp(log_close),
        volume=torch.zeros_like(z) if volume is None else volume,
    )


class VolumeModel(NamedTuple):
    """Synthetic per-bar volume for generative samplers.

    v_t = base · ushape(m_t) · LogNormal(σ=noise_sigma, mean 1)
               · (1 + ret_coupling · (|z_t| − E|z|)/sd|z|)   (floored at 0.05·base)

    where ``ushape(m) = 1 + u_amp·((2m/(D−1) − 1)² − 1/3)`` over the
    ``day_minutes``-minute session and z_t is the bar's price shock."""

    base: float = 1.0e6
    u_amp: float = 0.6
    noise_sigma: float = 0.35
    ret_coupling: float = 0.5
    day_minutes: int = 390
    open_minute: int = 0     # minute-of-session of bar 0

    def volumes(self, seed: int, block: int, z_ret, *, num_paths: int,
                num_bars: int, symbol: int = 0, device=None) -> torch.Tensor:
        """f32[num_paths, num_bars] volumes from the STREAM_VOLUME draws of
        global block ``block`` (of universe symbol ``symbol``); ``z_ret`` is
        the per-bar price shock, or None for uncoupled volume."""
        zv = prng.normal_rows(seed, prng.STREAM_VOLUME, block=block,
                              n_rows=num_bars, lanes=num_paths, symbol=symbol,
                              device=device).T
        sig = float(self.noise_sigma)
        noise = torch.exp(sig * zv - 0.5 * sig * sig)
        m = (self.open_minute + torch.arange(num_bars, dtype=F32,
                                             device=device)) % self.day_minutes
        x = 2.0 * m / float(max(self.day_minutes - 1, 1)) - 1.0
        shape = 1.0 + self.u_amp * (x * x - 1.0 / 3.0)
        v = self.base * shape[None, :] * noise
        if z_ret is not None and self.ret_coupling != 0.0:
            mean_abs = math.sqrt(2.0 / math.pi)
            sd_abs = math.sqrt(1.0 - 2.0 / math.pi)
            v = v * (1.0 + self.ret_coupling * ((z_ret.abs() - mean_abs) / sd_abs))
        return torch.clamp(v, min=0.05 * self.base)


def gbm_paths(seed: int, block: int, *, num_paths: int, num_bars: int, s0,
              mu: float = 0.0, sigma: float = 0.15,
              dt: float = 1.0 / (390.0 * 252.0), antithetic: bool = False,
              volume_model: VolumeModel | None = None, symbol: int = 0,
              device=None) -> PathBars:
    """GBM 1-minute OHLC paths of global block ``block`` of universe symbol
    ``symbol`` (every stream keyed by it, ``prng.stream_key``).  With ``antithetic``
    the second half of the path axis reuses the first half's normals negated
    (num_paths must be even).  Volumes come from ``volume_model`` (default
    ``VolumeModel()``) on their own stream, so the prices do not depend on it."""
    if volume_model is None:
        volume_model = VolumeModel()
    if antithetic and num_paths % 2 != 0:
        raise ValueError("antithetic requires an even num_paths")
    n_draw = num_paths // 2 if antithetic else num_paths

    z = prng.normal_rows(seed, prng.STREAM_PATH, block=block, n_rows=num_bars,
                         lanes=n_draw, symbol=symbol, device=device).T
    if antithetic:
        z = torch.cat([z, -z], dim=0)

    def uniforms(stream):
        return prng.uniform_rows(seed, stream, block0=block, n_blocks=1,
                                 n_rows=num_bars, lanes=num_paths,
                                 symbol=symbol, device=device)[0].T

    volume = volume_model.volumes(seed, block, z, num_paths=num_paths,
                                  num_bars=num_bars, symbol=symbol, device=device)
    return gbm_bars_from_draws(
        z, uniforms(prng.STREAM_BRIDGE_HI), uniforms(prng.STREAM_BRIDGE_LO),
        s0=s0, mu=mu, sigma=sigma, dt=dt, volume=volume)
