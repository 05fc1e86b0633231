"""The recorded-bar and Heston samplers as the fused kernels compute them.

Counterpart of the sampler branches of the JAX kernels: ``_bootstrap_block``
and ``_heston_block`` of the first-contact kernel
(``qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:178-294``), and the
streamed samplers of the gated and engine loops (``pallas_mc.py:1187-1375``,
``pallas_engine.py:207-519``).  The XLA pipeline's forms of the same samplers
are ``ops/pathgen.py``'s; the two differ in the order of their float32
operations (the kernels take each bar's previous log close as log_close -
log return, and Heston's bridge variance as v+ dt, not sig_dt^2), so each is
held against its own JAX counterpart.

* ``Sampler`` / ``make_sampler`` -- a sampler and what it reads: the history's
  ``bootstrap_tables`` (float32 [5, H]: logc, logh, logl, logo, volume; a
  universe's [S, 5, H], a history a symbol) and the block length, or the
  Heston constants (``HestonConsts``).
* ``iid_index`` / ``block_start`` / ``block_offset`` / ``gather`` -- a
  recorded bar's index from its uniform, in float32 as the kernels compute
  it: min(floor(u H), H - 1), a block's start min(floor(u (H - L)), H - L -
  1) and bar t's offset t - L floor(t / L) in it.
* ``heston_shock`` / ``heston_step`` -- the full-truncation Euler step, with
  the multiply-adds XLA's CPU compiler fuses under ``jit`` fused
  (``utils/floats.fma``; ``fmaf`` in ``ops/csrc/sampler.cuh``).
* ``sampler_steps`` / ``StreamBars`` -- the gated and engine loops' draws
  and streamed bar, bar by bar; a book symbol's with the market's draws
  (``pallas_mc.py:1237-1295``): its recorded bar's index from the market's
  uniform (joint recorded days), or its Heston price and variance normals
  mixed with the market's (``sim/book.mix_shocks``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..sim.book import mix_shocks
from ..utils import prng
from ..utils.floats import fma, sqrt
from .draws import SAMPLERS
from .kernel_args import f32
from .pathgen import HESTON_DEFAULTS, history_tables, universe_tables

HIST_CHANNELS = 5          # logc, logh, logl, logo, volume
MAX_HIST = 1 << 24         # a float32 index is exact below this many bars
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class HestonConsts:
    """The Heston constants as float32 values: ``rho_perp`` = sqrt(1 -
    rho^2) from the host's float64 (``pallas_mc.py:1194``), and ``kappa_dt``
    the float32 product kappa * dt that XLA folds ``kappa * (theta - v+) *
    dt`` into."""

    v0: float
    kappa: float
    theta: float
    xi: float
    rho: float
    rho_perp: float
    mu: float
    dt: float
    kappa_dt: float

    @classmethod
    def make(cls, heston=None, mu: float = 0.0, dt: float = 1.0 / (390.0 * 252.0)):
        h = dict(HESTON_DEFAULTS)
        h.update(heston or {})
        rho = float(h["rho"])
        return cls(v0=f32(h["v0"]), kappa=f32(h["kappa"]), theta=f32(h["theta"]),
                   xi=f32(h["xi"]), rho=f32(rho),
                   rho_perp=f32(math.sqrt(max(0.0, 1.0 - rho * rho))), mu=f32(mu),
                   dt=f32(dt), kappa_dt=f32(f32(h["kappa"]) * f32(dt)))


@dataclasses.dataclass(frozen=True)
class Sampler:
    """A fused kernel's sampler: ``kind`` one of SAMPLERS; the recorded
    history's tables (float32 [5, H], or a universe's [S, 5, H], a history a
    symbol) and ``block_len`` for the bootstrap samplers; the Heston
    constants for "heston"."""

    kind: str = "gbm"
    tables: torch.Tensor | None = None
    block_len: int = 0
    heston: HestonConsts | None = None

    @property
    def resamples(self) -> bool:
        return self.kind in ("bootstrap", "block_bootstrap")

    @property
    def hist_len(self) -> int:
        return 0 if self.tables is None else int(self.tables.shape[-1])

    def on(self, device) -> "Sampler":
        if self.tables is None:
            return self
        return dataclasses.replace(self, tables=self.tables.to(device))

    def row(self, s: int) -> "Sampler":
        """Symbol s's sampler of a universe's (its [5, H] tables); a sampler
        with one history (or none, or [1, 5, H] tables) is every symbol's."""
        if self.tables is None or self.tables.dim() == 2:
            return self
        return dataclasses.replace(self, tables=self.tables[s if len(self.tables) > 1 else 0])

    def table_rows(self, n: int) -> list:
        """The table each of ``n`` symbols reads (``kernel_args.sampler_args``):
        its own of [S, 5, H] tables, else the one history's."""
        if not self.resamples or self.tables.dim() == 2 or len(self.tables) == 1:
            return [0] * n
        return list(range(n))


def make_sampler(sampler: str = "gbm", *, hist_bars=None, tables=None,
                 block_len: int = 10, heston=None, mu: float = 0.0,
                 dt: float = 1.0 / (390.0 * 252.0), symbols: int | None = None,
                 shared: bool = False) -> Sampler:
    """The ``Sampler`` of a fused entry's arguments, with the JAX entries'
    checks (``pallas_mc.py:724-738``, ``:1206-1208``): the bootstrap samplers
    need ``hist_bars`` (a PathBars of 1-D o/h/l/c[/v] arrays) or its
    ``tables`` (float32 [5, H], as ``ops/pathgen.bootstrap_tables`` gives
    them), the block bootstrap a history longer than ``block_len``; ``heston``
    is a dict of v0/kappa/theta/xi/rho (the rest at their defaults).

    A universe of ``symbols`` symbols (``symbols`` given) resamples each
    symbol's own history: ``hist_bars`` of [S, H] arrays (a history that is
    not [S, H] raises, as ``_hist_slab_batched`` does) or [S, 5, H]
    ``tables`` (``ops/pathgen.universe_tables``); a book's symbols
    (``shared``) may also share one history, [1, 5, H] tables.  H < 2^24
    and H > block_len hold for every symbol's table."""
    if sampler not in SAMPLERS:
        raise ValueError(f"samplers: {' | '.join(repr(s) for s in SAMPLERS)}")
    if sampler == "heston":
        return Sampler("heston", heston=HestonConsts.make(heston, mu, dt))
    if sampler == "gbm":
        return Sampler()
    if tables is None:
        if hist_bars is None:
            raise ValueError(f"sampler={sampler!r} requires hist_bars"
                             + ("" if symbols is None else " ([S, H] recorded histories, "
                                "one row per symbol)"))
        tables = history_tables(hist_bars) if symbols is None else universe_tables(hist_bars)
    if torch.is_tensor(tables):
        tab = tables.to(_F32)            # stays where it lies (a universe's on the card)
    else:
        tab = torch.stack([torch.as_tensor(np.asarray(t, np.float32)) if not torch.is_tensor(t)
                           else t.to(_F32).cpu() for t in tables])
    want = 2 if symbols is None else 3
    what = (f"[{HIST_CHANNELS}, H]" if symbols is None
            else f"[{symbols}{' or 1' if shared else ''}, {HIST_CHANNELS}, H]")
    if (tab.dim() != want or tab.shape[-2] != HIST_CHANNELS
            or (symbols is not None and tab.shape[0] not in ((1, symbols) if shared
                                                             else (symbols,)))
            or not 0 < tab.shape[-1] < MAX_HIST):
        raise ValueError(f"bootstrap tables must be float32 {what} with "
                         f"0 < H < 2^24 (float32 indices), got {tuple(tab.shape)}")
    bl = int(block_len) if sampler == "block_bootstrap" else 0
    if bl and (bl < 1 or tab.shape[-1] <= bl):
        raise ValueError(f"block_bootstrap needs history longer than block_len "
                         f"({tab.shape[-1]} <= {bl})")
    return Sampler(sampler, tables=tab.contiguous(), block_len=bl)


def _c(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32, device=like.device)


def iid_index(u: torch.Tensor, h: int) -> torch.Tensor:
    """min(floor(u H), H - 1), float32."""
    hf = _c(float(h), u)
    return torch.minimum(torch.floor(u * hf), hf - 1.0)


def block_start(u: torch.Tensor, h: int, bl: int) -> torch.Tensor:
    """min(floor(u (H - L)), H - L - 1), float32."""
    span = _c(float(h), u) - _c(float(bl), u)
    return torch.minimum(torch.floor(u * span), span - 1.0)


def block_offset(t: int, bl: int) -> float:
    """t - L floor(t / L) in float32 (exact for the kernels' bar counts)."""
    tf, blf = np.float32(t), np.float32(bl)
    return float(tf - blf * np.floor(tf / blf))


def gather(tables: torch.Tensor, ch: int, idx_f: torch.Tensor) -> torch.Tensor:
    """Channel ``ch`` of the recorded bars at float32 indices ``idx_f``."""
    return tables[ch][idx_f.to(torch.int64)]


def heston_shock(z, zq, hc: HestonConsts) -> torch.Tensor:
    """The variance shock rho z + rho_perp zq with one product fused, the
    one XLA fuses under jit: rho z for rho >= 0, rho_perp zq for a negative
    rho (tests/test_torch_samplers.py)."""
    if hc.rho >= 0.0:
        return fma(_c(hc.rho, z), z, _c(hc.rho_perp, z) * zq)
    return fma(_c(hc.rho_perp, z), zq, _c(hc.rho, z) * z)


def heston_step(v, z, shock, hc: HestonConsts):
    """One full-truncation Euler step from variance ``v``: (the drift mu -
    v+/2, sig_bar = sqrt(v+ dt), the bridge variance v+ dt, the next
    variance, its theta term and shock fused as XLA fuses them); the square
    root rounded once, as XLA's and CUDA's are."""
    dt = _c(hc.dt, v)
    v_pos = torch.clamp(v, min=0.0)
    sig2dt = v_pos * dt
    sig_bar = sqrt(sig2dt)
    drift = _c(hc.mu, v) - 0.5 * v_pos
    v_next = fma(_c(hc.xi, v) * sig_bar, shock,
                 fma(_c(hc.theta, v) - v_pos, _c(hc.kappa_dt, v), v))
    return drift, sig_bar, sig2dt, v_next


class StreamBars:
    """The streamed bar of the gated and engine loops' samplers, over
    [nb, 8, lanes] tensors: the path's log close, and its carried block
    start (block bootstrap) or variance (Heston).  ``bar`` returns (log
    open, open, high, low, close, recorded volume or None): a recorded
    bar's open is its recorded gap over the previous close, which the gated
    loop takes as bar 0's previous close (``pallas_mc.py:1353-1357``)."""

    def __init__(self, sampler: Sampler, log_s0: float, shape, device):
        self.s = sampler.on(device)
        self.log_s = torch.full(shape, log_s0, dtype=_F32, device=device)
        init = sampler.heston.v0 if sampler.kind == "heston" else 0.0
        self.carry = torch.full(shape, init, dtype=_F32, device=device)

    def index(self, t: int, u: torch.Tensor) -> torch.Tensor:
        s = self.s
        if s.kind == "block_bootstrap":
            off = block_offset(t, s.block_len)
            if off == 0.0:
                self.carry = block_start(u, s.hist_len, s.block_len)
            return self.carry + off
        return iid_index(u, s.hist_len)

    def bar(self, t: int, x, zq=None, bridge_u=None):
        """Bar ``t`` from its index uniform ``x`` (bootstrap) or its price
        normal ``x``, variance normal ``zq`` and bridge uniforms ``bridge_u``
        = (u3, u4) (Heston)."""
        log_open = self.log_s
        if self.s.resamples:
            idx = self.index(t, x)
            tab = self.s.tables
            log_close = log_open + gather(tab, 0, idx)
            self.log_s = log_close
            return (log_open, torch.exp(log_open + gather(tab, 3, idx)),
                    torch.exp(log_open + gather(tab, 1, idx)),
                    torch.exp(log_open + gather(tab, 2, idx)),
                    torch.exp(log_close), gather(tab, 4, idx))
        hc = self.s.heston
        drift, sig_bar, sig2dt, self.carry = heston_step(
            self.carry, x, heston_shock(x, zq, hc), hc)
        log_close = fma(sig_bar, x, fma(drift, _c(hc.dt, x), log_open))
        self.log_s = log_close
        high, low = bridge(log_open, log_close, sig2dt, *bridge_u)
        return log_open, torch.exp(log_open), high, low, torch.exp(log_close), None


def box_muller(u1, u2):
    """(r cos a, r sin a) of radius draw ``u1`` and angle draw ``u2``."""
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = prng.TWO_PI * u2
    return radius * torch.cos(angle), radius * torch.sin(angle)


def market_draws(um: torch.Tensor, sampler: str) -> list:
    """Per double-bar step, a book's market draws from its market uniforms
    um f32[nb, u_rows, 8, lanes] (``ops/draws.MarketLayout``): the index
    uniforms of its two bars (bootstrap), or the (cos, sin) normals of the
    price pair and of the variance pair (Heston)."""
    if sampler == "heston":
        return [(box_muller(um[:, 4 * t2], um[:, 4 * t2 + 1]),
                 box_muller(um[:, 4 * t2 + 2], um[:, 4 * t2 + 3]))
                for t2 in range(um.shape[1] // 4)]
    return [(um[:, 2 * t2], um[:, 2 * t2 + 1]) for t2 in range(um.shape[1] // 2)]


def sampler_steps(u, layout, market=None):
    """Per bar of a gated or engine layout (``ops/draws.GatedLayout`` /
    ``EngineLayout``) of a bootstrap or Heston sampler, in order: (t, x, zq,
    zv, (u3, u4) or None, tie, noise normals or None), each [nb, 8, lanes]
    of uniforms u f32[nb, u_rows, 8, lanes], as the JAX loops draw them:
    x is the bar's index uniform (bootstrap) or price normal (Heston), zq
    its variance normal and zv its volume normal (the engine's Heston).  A
    book symbol's (``layout.book``) ``market`` = (``market_draws``, beta)
    gives its index uniforms, or mixes the market's normals into its price
    and variance normals.  An odd W (the engine's) ends with a half step:
    its bar takes the first branch (cos) of each pair of one more step of
    rows (``pallas_engine.py:1296-1334``)."""
    heston = layout.sampler == "heston"
    for t2 in range((layout.num_bars + 1) // 2):
        def draw(k):
            return u[:, layout.row(t2, k)]

        none = (None, None)
        if heston:
            xs = box_muller(draw(0), draw(1))
            zqs = box_muller(draw(layout.k_shock), draw(layout.k_shock + 1))
            if market is not None:
                (zm, zqm), beta = market[0][t2], market[1]
                xs = tuple(mix_shocks(beta, zm[h], xs[h]) for h in range(2))
                zqs = tuple(mix_shocks(beta, zqm[h], zqs[h]) for h in range(2))
            kv = layout.k_volume
            zvs = none if kv is None else box_muller(draw(kv), draw(kv + 1))
            kb = layout.k_bridge
            bridges = ((draw(kb), draw(kb + 1)), (draw(kb + 3), draw(kb + 4)))
            ties = (draw(kb + 2), draw(kb + 5))
        else:
            xs = (draw(0), draw(1)) if market is None else market[0][t2]
            zqs, zvs, bridges = none, none, none
            ties = (draw(layout.k_tie), draw(layout.k_tie + 1))
        for half in range(min(2, layout.num_bars - 2 * t2)):
            nz = None
            if layout.noise:
                k = layout.k_noise + 4 * half
                nz = box_muller(draw(k), draw(k + 1)) + box_muller(draw(k + 2), draw(k + 3))
            yield 2 * t2 + half, xs[half], zqs[half], zvs[half], bridges[half], ties[half], nz


def bridge(log_open, log_close, sig2dt, u3, u4):
    """Brownian-bridge (high, low) between the bar's log open and close at
    variance ``sig2dt`` (a tensor), in the kernels' order."""
    two_s2 = 2.0 * sig2dt
    diff = log_close - log_open
    d2 = diff * diff
    mid = log_open + log_close
    high = torch.exp(0.5 * (mid + torch.sqrt(d2 - two_s2 * torch.log(u3))))
    low = torch.exp(0.5 * (mid - torch.sqrt(d2 - two_s2 * torch.log(u4))))
    return high, low
