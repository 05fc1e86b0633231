"""Price-path samplers: GBM closes with Brownian-bridge bar extremes,
recorded-bar resampling (iid and in blocks) and Heston stochastic volatility.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pathgen.py:47-340``
(``PathBars``, ``VolumeModel``, ``gbm_paths``, ``bootstrap_tables``,
``bootstrap_paths``, ``block_bootstrap_paths``, ``heston_paths``): the XLA
pipeline's forms.  The fused kernels' forms of the same samplers are in
``ops/samplers.py``.

* ``gbm_bars_from_draws`` — the deterministic core: GBM closes from standard
  normals ``z``, per-bar highs/lows from the exact law of the max/min of a
  Brownian bridge between consecutive log-closes,
  ``M = ((a + b) + sqrt((b - a)^2 - 2 sigma^2 dt ln U)) / 2``.  The tests feed
  it the draws JAX itself made, so it is held against JAX ``gbm_paths``.
* ``gbm_paths`` — the same with Philox draws (``utils/prng.py``), one stream
  per consumer as in the JAX package.
* ``bootstrap_tables`` — a recorded history's per-bar relative geometry (log
  return and log high/low/open offsets against the previous close) and its
  volume, float32 as JAX computes them; ``universe_tables`` the same for a
  universe's [S, H] histories, [S, 5, H].
* ``bootstrap_bars_from_draws`` / ``bootstrap_paths`` /
  ``block_bootstrap_paths`` — recorded bars resampled at given indices (iid,
  or ``block_indices``' contiguous runs) chained onto ``s0``; the Philox forms
  draw the indices on ``prng.STREAM_BOOTSTRAP``.
* ``heston_bars_from_draws`` / ``heston_paths`` — full-truncation Euler
  Heston closes (the ``lax.scan`` chain) with bridge extremes at each bar's
  own variance; the Philox form draws the price and variance normals as the
  two Box-Muller branches of ``STREAM_PATH``'s rows.
* ``joint_resample_idx`` / ``heston_log_closes`` / ``heston_bars_from_shocks``
  — a correlated book's forms (``parallel/portfolio.py:101-167``): the
  recorded-bar indices every symbol shares, drawn on the market stream, and
  a symbol's Heston bars from its mixed price and variance shocks.

All arithmetic is float32 in the JAX package's order; the log-price cumsum is
a serial float32 running sum (``cumsum_f32``), the order the CUDA kernel uses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import prng
from ..utils.floats import fma, sqrt

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


def bootstrap_tables(hist_open, hist_high, hist_low, hist_close, hist_volume=None):
    """(logc, logh, logl, logo, vol), f32[H] each: a recorded history's log
    return and log high/low/open offsets against the previous close (bar 0
    against itself), and its real volume (zeros when none is given), in
    float32 as ``ops/pathgen.bootstrap_tables`` computes them.  (PyTorch's
    float32 ``log`` is not XLA's: a value may differ by an ulp.)"""
    close = torch.as_tensor(hist_close, dtype=F32)
    prev = torch.cat([close[:1], close[:-1]])
    logs = [torch.log(torch.as_tensor(x, dtype=F32) / prev)
            for x in (close, hist_high, hist_low, hist_open)]
    vol = (torch.zeros_like(close) if hist_volume is None
           else torch.as_tensor(hist_volume, dtype=F32))
    return (*logs, vol)


def history_tables(hist_bars):
    """``bootstrap_tables`` of a recorded history, a PathBars of 1-D
    o/h/l/c arrays (its volume, where it has one)."""
    if hist_bars is None:
        raise ValueError("the bootstrap samplers need hist_bars (or its tables)")
    return bootstrap_tables(hist_bars.open, hist_bars.high, hist_bars.low,
                            hist_bars.close, getattr(hist_bars, "volume", None))


def universe_tables(hist_bars) -> torch.Tensor:
    """f32[S, 5, H]: each symbol's ``bootstrap_tables`` of a universe's
    recorded histories, a PathBars of [S, H] o/h/l/c[/v] arrays (one history
    a symbol over a common lookback, zero volumes where none), as
    ``_hist_slab_batched`` computes them (pallas_mc.py:348-366); a history
    that is not [S, H] raises as JAX's does."""
    if hist_bars is None:
        raise ValueError("the bootstrap samplers need hist_bars (or its tables)")
    o = torch.as_tensor(hist_bars.open, dtype=F32)
    if o.dim() != 2:
        raise ValueError("universe bootstrap needs [S, H]-batched hist_bars "
                         "(one recorded history row per symbol)")
    vol = getattr(hist_bars, "volume", None)
    cols = [torch.as_tensor(x, dtype=F32) for x in (hist_bars.high, hist_bars.low,
                                                      hist_bars.close)]
    vol = torch.zeros_like(o) if vol is None else torch.as_tensor(vol, dtype=F32)
    if any(c.shape != o.shape for c in (*cols, vol)):
        raise ValueError("hist_bars' o/h/l/c/v must share one [S, H] shape")
    return torch.stack([torch.stack(bootstrap_tables(o[s], cols[0][s], cols[1][s], cols[2][s],
                                                     vol[s]))
                        for s in range(o.shape[0])])


def _tables(tables=None, hist_bars=None):
    if tables is None:
        return history_tables(hist_bars)
    return tuple(torch.as_tensor(t, dtype=F32) for t in tables)


def bootstrap_bars_from_draws(idx, tables, *, s0) -> PathBars:
    """Recorded bars at indices ``idx`` int[paths, bars] of the history whose
    ``bootstrap_tables`` are ``tables``, chained onto ``s0``: bar t's
    previous log close is log(s0) plus the cumulative recorded returns of
    bars 0 .. t-1 (a serial float32 sum); its open, high, low and close are
    that plus the bar's recorded offsets; its volume the recorded one."""
    idx = torch.as_tensor(idx).to(torch.int64)
    logc, logh, logl, logo, vol = (torch.as_tensor(t, dtype=F32, device=idx.device)
                                   for t in tables)
    r = logc[idx]
    log_s0 = torch.log(torch.as_tensor(s0, dtype=F32, device=idx.device))
    log_prev = log_s0 + torch.cat(
        [torch.zeros_like(r[..., :1]), cumsum_f32(r[..., :-1], dim=-1)], dim=-1)
    return PathBars(open=torch.exp(log_prev + logo[idx]),
                    high=torch.exp(log_prev + logh[idx]),
                    low=torch.exp(log_prev + logl[idx]),
                    close=torch.exp(log_prev + r), volume=vol[idx])


def block_indices(starts, num_bars: int, block_len: int):
    """int[paths, num_bars] indices of contiguous ``block_len``-bar runs from
    the run starts int[paths, ceil(num_bars / block_len)]."""
    starts = torch.as_tensor(starts, dtype=torch.int64)
    offs = torch.arange(block_len, dtype=torch.int64, device=starts.device)
    idx = (starts[:, :, None] + offs[None, None, :]).reshape(starts.shape[0], -1)
    return idx[:, :num_bars]


def _index_uniforms(seed, block, n_rows, num_paths, symbol, device):
    return prng.uniform_rows(seed, prng.STREAM_BOOTSTRAP, block0=block, n_blocks=1,
                             n_rows=n_rows, lanes=num_paths, symbol=symbol,
                             device=device)[0].T


def bootstrap_paths(seed: int, block: int, *, num_paths: int, num_bars: int, s0,
                    hist_bars=None, tables=None, symbol: int = 0,
                    device=None) -> PathBars:
    """Recorded bars resampled with replacement, one index a bar: index
    min(floor(u H), H - 1) of a uniform u on ``prng.STREAM_BOOTSTRAP`` (JAX
    draws ``randint``); real volumes ride along."""
    tables = _tables(tables, hist_bars)
    h = int(tables[0].shape[0])
    u = _index_uniforms(seed, block, num_bars, num_paths, symbol, device)
    idx = torch.clamp((u * h).to(torch.int64), max=h - 1)
    return bootstrap_bars_from_draws(idx, tables, s0=s0)


def block_bootstrap_paths(seed: int, block: int, *, num_paths: int, num_bars: int,
                          s0, block_len: int = 10, hist_bars=None, tables=None,
                          symbol: int = 0, device=None) -> PathBars:
    """Block bootstrap: contiguous ``block_len``-bar runs of the history, a
    run starting at min(floor(u (H - block_len)), H - block_len - 1) of a
    uniform u on ``prng.STREAM_BOOTSTRAP``; needs H > block_len."""
    tables = _tables(tables, hist_bars)
    h = int(tables[0].shape[0])
    if h <= block_len:
        raise ValueError("history shorter than block_len")
    u = _index_uniforms(seed, block, -(-num_bars // block_len), num_paths, symbol, device)
    starts = torch.clamp((u * (h - block_len)).to(torch.int64), max=h - block_len - 1)
    return bootstrap_bars_from_draws(block_indices(starts, num_bars, block_len),
                                     tables, s0=s0)


def joint_resample_idx(seed: int, block: int, *, num_paths: int, num_bars: int, n_hist: int,
                       block_len: int = 0, device=None) -> torch.Tensor:
    """int64 [paths, bars] recorded-bar indices a correlated book's symbols
    share (joint recorded days, ``parallel/portfolio.py:101-112``): one
    uniform a bar, or a block's start a ``block_len``-bar run, on the
    market stream (``prng.STREAM_MARKET`` at symbol 0; JAX draws
    ``randint`` on its market key), as ``bootstrap_paths`` /
    ``block_bootstrap_paths`` turn uniforms into indices."""
    if block_len:
        if n_hist <= block_len:
            raise ValueError("history shorter than block_len")
        u = prng.uniform_rows(seed, prng.STREAM_MARKET, block0=block, n_blocks=1,
                              n_rows=-(-num_bars // block_len), lanes=num_paths,
                              device=device)[0].T
        starts = torch.clamp((u * (n_hist - block_len)).to(torch.int64),
                             max=n_hist - block_len - 1)
        return block_indices(starts, num_bars, block_len)
    u = prng.uniform_rows(seed, prng.STREAM_MARKET, block0=block, n_blocks=1, n_rows=num_bars,
                          lanes=num_paths, device=device)[0].T
    return torch.clamp((u * n_hist).to(torch.int64), max=n_hist - 1)


HESTON_DEFAULTS = dict(v0=0.04, kappa=3.0, theta=0.04, xi=0.6, rho=-0.7)


def heston_vector(heston=None) -> torch.Tensor:
    """f32[5] (v0, kappa, theta, xi, rho), the defaults updated by the dict
    ``heston`` (``parallel/portfolio.py:170-174``)."""
    h = dict(HESTON_DEFAULTS)
    h.update(heston or {})
    return torch.tensor([h[k] for k in ("v0", "kappa", "theta", "xi", "rho")], dtype=F32)


def heston_bars_from_draws(z1, zv, u_hi, u_lo, *, s0, v0: float = 0.04,
                           kappa: float = 3.0, theta: float = 0.04, xi: float = 0.6,
                           rho: float = -0.7, mu: float = 0.0,
                           dt: float = 1.0 / (390.0 * 252.0), volume=None) -> PathBars:
    """Heston bars from given draws f32[paths, bars]: price normals ``z1``,
    variance normals ``zv`` (mixed with ``z1`` by ``rho``), bridge uniforms.
    Full-truncation Euler in float32 in ``heston_paths``' order, the log
    close chained bar by bar with the multiply-adds XLA fuses in the scan's
    body fused; the bridge extremes use each bar's sig_dt^2.
    ``volume`` defaults to zeros."""
    z1 = torch.as_tensor(z1, dtype=F32)
    dev = z1.device

    def c(x):
        return torch.tensor(x, dtype=F32, device=dev)

    rho_f = c(rho)
    z2 = rho_f * z1 + torch.sqrt(1.0 - rho_f * rho_f) * torch.as_tensor(zv, dtype=F32)
    dtf = c(dt)
    log_s0 = torch.log(c(s0))
    logp = log_s0.expand(z1.shape[0]).clone()
    v = c(v0).expand(z1.shape[0]).clone()
    kappa_dt = c(kappa) * dtf     # XLA folds kappa * (theta - v+) * dt so
    closes, sigs = [], []
    for t in range(z1.shape[1]):
        # the scan's body as XLA compiles it: sig_dt z and the shock term fused
        v_pos = torch.clamp(v, min=0.0)
        sig_dt = sqrt(v_pos * dtf)
        logp = fma(sig_dt, z1[:, t], fma(c(mu) - 0.5 * v_pos, dtf, logp))
        v = fma(c(xi) * sig_dt, z2[:, t], fma(c(theta) - v_pos, kappa_dt, v))
        closes.append(logp)
        sigs.append(sig_dt)
    log_close = torch.stack(closes, dim=1)
    sig_dt = torch.stack(sigs, dim=1)
    log_open = torch.cat([log_s0.expand(z1.shape[0], 1), log_close[:, :-1]], dim=1)
    log_hi, log_lo = bridge_extremes(torch.as_tensor(u_hi, dtype=F32),
                                     torch.as_tensor(u_lo, dtype=F32),
                                     log_open, log_close, sig_dt * sig_dt)
    return PathBars(open=torch.exp(log_open), high=torch.exp(log_hi),
                    low=torch.exp(log_lo), close=torch.exp(log_close),
                    volume=torch.zeros_like(z1) if volume is None else volume)


def heston_log_closes(z, zq, *, s0, heston=None, mu: float = 0.0,
                      dt: float = 1.0 / (390.0 * 252.0)):
    """(log closes, sig_bar) f32[paths, bars] of a book symbol's Heston chain
    from its mixed price shocks ``z`` and variance shocks ``zq``
    (``parallel/portfolio.py:131-158``): full-truncation Euler with the
    constants as float32 values (``heston_vector``), fused as XLA fuses the
    JAX book under ``jit`` (``1 - rho^2``, ``rho z`` into the shock, the
    close's and the variance's multiply-adds) and with ``kappa * (theta - v+)
    * dt`` taken as ``(theta - v+) * f32(kappa * dt)``, the loop-invariant
    product XLA hoists out of the scan although the constants are traced
    values there."""
    z = torch.as_tensor(z, dtype=F32)
    dev = z.device
    v0, kappa, theta, xi, rho = heston_vector(heston).to(dev)
    rho_perp = torch.sqrt(torch.clamp(fma(-rho, rho, 1.0), min=0.0))
    z2 = fma(rho, z, rho_perp * torch.as_tensor(zq, dtype=F32, device=dev))
    dtf = torch.tensor(dt, dtype=F32, device=dev)
    logp = torch.log(torch.as_tensor(s0, dtype=F32, device=dev)).expand(z.shape[0]).clone()
    v = v0.expand(z.shape[0]).clone()
    mu_f = torch.tensor(mu, dtype=F32, device=dev)
    kappa_dt = kappa * dtf
    closes, sigs = [], []
    for t in range(z.shape[1]):
        v_pos = torch.clamp(v, min=0.0)
        sig_bar = sqrt(v_pos * dtf)
        logp = fma(sig_bar, z[:, t], fma(mu_f - 0.5 * v_pos, dtf, logp))
        v = fma(xi * sig_bar, z2[:, t], fma(theta - v_pos, kappa_dt, v))
        closes.append(logp)
        sigs.append(sig_bar)
    return torch.stack(closes, dim=1), torch.stack(sigs, dim=1)


def heston_bars_from_shocks(z, zq, u_hi, u_lo, *, s0, heston=None, mu: float = 0.0,
                            dt: float = 1.0 / (390.0 * 252.0), volume=None) -> PathBars:
    """A book symbol's Heston bars f32[paths, bars] from its mixed shocks
    (``heston_log_closes``) and bridge uniforms (``parallel/portfolio.py:
    131-167``); the bridge extremes use sig_bar^2; ``volume`` defaults to
    zeros."""
    log_close, sig_bar = heston_log_closes(z, zq, s0=s0, heston=heston, mu=mu, dt=dt)
    log_s0 = torch.log(torch.as_tensor(s0, dtype=F32, device=log_close.device))
    log_open = torch.cat([log_s0.expand(log_close.shape[0], 1), log_close[:, :-1]], dim=1)
    log_hi, log_lo = bridge_extremes(torch.as_tensor(u_hi, dtype=F32),
                                     torch.as_tensor(u_lo, dtype=F32),
                                     log_open, log_close, sig_bar * sig_bar)
    return PathBars(open=torch.exp(log_open), high=torch.exp(log_hi),
                    low=torch.exp(log_lo), close=torch.exp(log_close),
                    volume=torch.zeros_like(log_close) if volume is None else volume)


def heston_paths(seed: int, block: int, *, num_paths: int, num_bars: int, s0,
                 v0: float = 0.04, kappa: float = 3.0, theta: float = 0.04,
                 xi: float = 0.6, rho: float = -0.7, mu: float = 0.0,
                 dt: float = 1.0 / (390.0 * 252.0), antithetic: bool = False,
                 volume_model: VolumeModel | None = None, symbol: int = 0,
                 device=None) -> PathBars:
    """Heston stochastic-volatility paths of global block ``block``: the
    price and variance normals are the cosine and sine branches of 2 x
    num_bars rows of ``STREAM_PATH`` (JAX draws them on two subkeys of it);
    with ``antithetic`` the second half of the path axis negates the first
    half's.  Volumes come from ``volume_model`` coupled to the price shock."""
    if volume_model is None:
        volume_model = VolumeModel()
    if antithetic and num_paths % 2 != 0:
        raise ValueError("antithetic requires an even num_paths")
    n_draw = num_paths // 2 if antithetic else num_paths
    z = prng.normal_rows(seed, prng.STREAM_PATH, block=block, n_rows=2 * num_bars,
                         lanes=n_draw, symbol=symbol, device=device)
    z1, zv = z[:num_bars].T, z[num_bars:].T
    if antithetic:
        z1, zv = torch.cat([z1, -z1]), torch.cat([zv, -zv])

    def uniforms(stream):
        return prng.uniform_rows(seed, stream, block0=block, n_blocks=1,
                                 n_rows=num_bars, lanes=num_paths,
                                 symbol=symbol, device=device)[0].T

    volume = volume_model.volumes(seed, block, z1, num_paths=num_paths,
                                  num_bars=num_bars, symbol=symbol, device=device)
    return heston_bars_from_draws(
        z1, zv, uniforms(prng.STREAM_BRIDGE_HI), uniforms(prng.STREAM_BRIDGE_LO),
        s0=s0, v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho, mu=mu, dt=dt,
        volume=volume)
