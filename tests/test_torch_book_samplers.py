"""The correlated books under the recorded-bar and Heston samplers, held
against the JAX package on the same numbers: the book's layouts (the market
stream carries the sampler), the Heston mix and chain of the JAX book's XLA
pipeline bit for bit against jitted copies of its expressions, its bar
builders (``_boot_bars_from_idx``, ``_heston_bars_from_shocks``) on the
port's own indices and shocks and inside ``portfolio_mc`` /
``portfolio_mc_engine``; joint recorded days, a history swap, one shared
table, the argument checks, and the CLI's ``book [--engine] --sampler ...``
on the CPU.  The kernels' plain versions against the JAX kernels in
interpret mode are ``tests/test_torch_book_samplers_{gated,engine}_
interpret.py``; the kernels themselves ``tests/test_torch_book_samplers_
kernel.py``."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
from qmmx_monolithic_monte_carlo_tpu.parallel import portfolio as jP
from qmmx_monolithic_monte_carlo_tpu.utils import prng as jprng
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                             MarketLayout, market_uniforms)
from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import make_sampler
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import portfolio as P
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.book import mix_shocks
from qmmx_monolithic_monte_carlo_tpu_torch.utils import prng

torch.set_num_threads(2)

DT = 1.0 / (390.0 * 252.0)
W = 16
SAMPLERS = ("bootstrap", "block_bootstrap", "heston")
BLOCK_LEN = 5
ROWS3 = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
          {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}],
         [{"color": "blue", "type": "solid", "index": 0, "price": 100.2}],
         [{"color": "green", "type": "solid", "index": 0, "price": 99.7},
          {"color": "orange", "type": "dashed", "index": 0, "price": 100.3}]]
S0 = [100.0, 100.1, 99.9]
SIGMAS = [0.3, 0.25, 0.35]
BETAS = [0.8, 0.6, 0.3]
WEIGHTS = [0.5, 0.3, 0.2]
HESTON = dict(v0=0.05, kappa=2.0, theta=0.03, xi=0.7, rho=-0.6)


def histories(seed: int, n_sym: int, h: int):
    """[S, H] float32 o/h/l/c/v histories on a cent grid, symbol s from its
    own spot (opening gaps, wicks, positive volumes)."""
    rng = np.random.default_rng(seed)
    c = np.round(np.asarray(S0[:n_sym])[:, None]
                 + np.cumsum(rng.normal(0, 0.06, (n_sym, h)), axis=1), 2)
    prev = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    o = np.round(prev + rng.normal(0, 0.02, (n_sym, h)) * (rng.uniform(size=(n_sym, h)) < 0.1),
                 2)
    hi = np.round(np.maximum(o, c) + np.abs(rng.normal(0, 0.04, (n_sym, h))), 2)
    lo = np.round(np.minimum(o, c) - np.abs(rng.normal(0, 0.04, (n_sym, h))), 2)
    v = np.round(rng.lognormal(9.0, 0.5, (n_sym, h)))
    return [np.ascontiguousarray(x, np.float32) for x in (o, hi, lo, c, v)]


HIST = histories(3, 3, 300)
THIST = PG.PathBars(*(torch.from_numpy(x) for x in HIST))
TABLES = PG.universe_tables(THIST)


def _levels():
    return U.stack_levels(ROWS3, max_levels=4)


def _skw(sampler):
    return dict(sampler=sampler, block_len=BLOCK_LEN,
                heston=HESTON if sampler == "heston" else None)


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------

def test_book_layouts_carry_the_sampler_on_the_market_stream():
    assert MarketLayout(16).u_rows == MarketLayout(16, "bootstrap").u_rows == 16
    hes = MarketLayout(16, "heston")
    assert hes.u_rows == 32 and [hes.row(3, k) for k in range(4)] == [12, 13, 14, 15]
    um = market_uniforms(9, hes, block0=2, n_blocks=3, lanes=32)
    want = prng.uniform_rows(9, prng.STREAM_MARKET, block0=2, n_blocks=3, n_rows=32,
                             lanes=8 * 32).view(3, 32, 8, 32)
    assert torch.equal(um, want)
    for lay in (GatedLayout, EngineLayout):
        for s in ("bootstrap", "block_bootstrap"):
            single, book = lay(16, True, s), lay(16, True, s, book=True)
            assert single.u_rows == book.u_rows and (single.k_tie, book.k_tie) == (2, 0)
        assert lay(16, False, "heston", book=True).u_rows == lay(16, False, "heston").u_rows
    with pytest.raises(ValueError, match="samplers"):
        MarketLayout(16, "garch")


# ---------------------------------------------------------------------------
# the XLA pipeline's forms against the JAX book's
# ---------------------------------------------------------------------------

@jax.jit
def _jax_mix(beta, zm, zqm, eps, zqe):
    """The JAX book's two mixes (parallel/portfolio.py:290-300) inside a
    jitted scan over symbols, as ``_portfolio_mc_impl`` runs them."""
    def per_symbol(carry, xs):
        bts, e, qe = xs
        perp = jnp.sqrt(jnp.maximum(0.0, 1.0 - bts * bts))
        return carry, (bts * zm + perp * e, bts * zqm + perp * qe)

    return jax.lax.scan(per_symbol, 0, (beta, eps, zqe))[1]


def test_variance_mix_fuses_as_the_jitted_jax_book_bit_for_bit():
    """XLA fuses ``beta * zq_m`` into the variance shock's mix as it does
    into the price shock's: ``sim/book.mix_shocks`` serves both."""
    rng = np.random.default_rng(4)
    betas = np.float32([0.8, 0.6, 0.3, 0.0, 1.0, -0.45, 0.123456, 0.999])
    zm, zqm = (rng.normal(size=(W, 256)).astype(np.float32) for _ in range(2))
    eps, zqe = (rng.normal(size=(len(betas), W, 256)).astype(np.float32) for _ in range(2))
    z, zq = (np.asarray(x) for x in _jax_mix(betas, zm, zqm, eps, zqe))
    for s, b in enumerate(betas):
        for got, m, e in ((z[s], zm, eps[s]), (zq[s], zqm, zqe[s])):
            np.testing.assert_array_equal(
                mix_shocks(float(b), torch.from_numpy(m), torch.from_numpy(e)).numpy(), got,
                err_msg=str(b))


@jax.jit
def _jax_heston_chain(z, zq, s0s, heston_vec):
    """A jitted copy of ``_heston_bars_from_shocks``' chain (parallel/
    portfolio.py:138-158; the constants traced, as in the book): its log
    closes and sig_bar."""
    v0, kappa, theta, xi, rho = (heston_vec[i] for i in range(5))
    rho_perp = jnp.sqrt(jnp.maximum(0.0, 1.0 - rho * rho))
    z2 = rho * z + rho_perp * zq
    dtf = jnp.float32(DT)

    def step(carry, zs):
        logp, v = carry
        z_s, z_v = zs
        v_pos = jnp.maximum(v, 0.0)
        sig_bar = jnp.sqrt(v_pos * dtf)
        logp_new = logp + (jnp.float32(0.0) - 0.5 * v_pos) * dtf + sig_bar * z_s
        v_new = v + kappa * (theta - v_pos) * dtf + xi * sig_bar * z_v
        return (logp_new, v_new), (logp_new, sig_bar)

    init = (jnp.full((z.shape[0],), jnp.log(s0s)), jnp.full((z.shape[0],), v0))
    _, (lc, sb) = jax.lax.scan(step, init, (z.T, z2.T))
    return lc.T, sb.T


@pytest.mark.parametrize("heston", [{}, dict(v0=0.09, kappa=1.5, theta=0.02, xi=0.9, rho=0.3),
                                    dict(rho=0.0), dict(rho=-0.95, xi=1.2)])
def test_heston_chain_is_the_jax_books_bit_for_bit(heston):
    """``heston_log_closes`` against the jitted copy: log closes and sig_bar
    bit for bit (XLA fuses the close's and the variance's multiply-adds and
    ``rho z`` into the shock; with the constants traced nothing is folded)."""
    rng = np.random.default_rng(6)
    z, zq = (rng.normal(size=(1024, 40)).astype(np.float32) for _ in range(2))
    s0 = np.float32(100.0)
    lc, sb = (np.asarray(x) for x in _jax_heston_chain(z, zq, s0, jP._heston_vec(heston)))
    assert float(torch.log(torch.tensor(s0))) == float(jnp.log(s0))   # no log ulp at s0
    got_lc, got_sb = PG.heston_log_closes(torch.from_numpy(z), torch.from_numpy(zq),
                                          s0=float(s0), heston=heston, dt=DT)
    np.testing.assert_array_equal(got_lc.numpy(), lc)
    np.testing.assert_array_equal(got_sb.numpy(), sb)


def _ulps(a, b) -> int:
    return int(np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                      - np.asarray(b, np.float32).view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("heston", [{}, dict(v0=0.09, kappa=1.5, theta=0.02, xi=0.9, rho=0.3)])
def test_heston_bars_match_the_jax_books_on_the_same_shocks(heston):
    """``heston_bars_from_shocks`` against JAX's ``_heston_bars_from_shocks``
    (jitted) on the same mixed shocks and JAX's own bridge uniforms: every
    price within 1 ulp (PyTorch's exp against XLA's; the chain is bit for
    bit, above)."""
    rng = np.random.default_rng(8)
    n = 512
    z, zq = (rng.normal(size=(n, 40)).astype(np.float32) for _ in range(2))
    ks = jax.random.key(7)
    f = jax.jit(lambda ks, z, zq, s0, hv: jP._heston_bars_from_shocks(
        ks, z, zq, s0, hv, mu=0.0, dt=DT, num_paths=n))
    want = f(ks, z, zq, jnp.float32(101.5), jP._heston_vec(heston))

    def bridge(stream):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            jprng.key_for(ks, stream), (n, 40), jnp.float32, 1e-12, 1.0)))

    got = PG.heston_bars_from_shocks(torch.from_numpy(z), torch.from_numpy(zq),
                                     bridge(jprng.STREAM_BRIDGE_HI),
                                     bridge(jprng.STREAM_BRIDGE_LO), s0=101.5, heston=heston,
                                     dt=DT)
    for f_ in ("open", "high", "low", "close", "volume"):
        assert _ulps(getattr(got, f_).numpy(), np.asarray(getattr(want, f_))) <= 1, f_


@pytest.mark.parametrize("block_len", [0, BLOCK_LEN])
def test_joint_bootstrap_bars_match_the_jax_books_on_the_same_indices(block_len):
    """``joint_resample_idx`` (the market stream's indices, block starts
    shared by a block's bars) and ``bootstrap_bars_from_draws`` against JAX's
    ``_boot_bars_from_idx`` (jitted) on those indices and JAX's own tables:
    prices within 1e-6, volumes exact."""
    n, h = 256, HIST[0].shape[1]
    idx = PG.joint_resample_idx(5, 3, num_paths=n, num_bars=W, n_hist=h, block_len=block_len)
    assert idx.shape == (n, W) and int(idx.min()) >= 0 and int(idx.max()) < h
    if block_len:
        full = W // block_len
        runs = idx[:, :full * block_len].reshape(n, full, block_len)
        assert bool((runs[..., 1:] - runs[..., :-1] == 1).all())
    u = prng.uniform_rows(5, prng.STREAM_MARKET, block0=3, n_blocks=1,
                          n_rows=-(-W // block_len) if block_len else W, lanes=n)[0].T
    assert bool((u[:, 0] < 1.0).all())          # the market stream at symbol 0 drew them
    f = jax.jit(lambda i, t, s0: jP._boot_bars_from_idx(i, t, s0, num_paths=n))
    for s in range(3):
        tab = [np.asarray(t) for t in jPG.bootstrap_tables(*(x[s] for x in HIST))]
        want = f(jnp.asarray(idx.numpy()), tuple(tab), jnp.float32(S0[s]))
        got = PG.bootstrap_bars_from_draws(idx, tab, s0=S0[s])
        for fld in ("open", "high", "low", "close"):
            np.testing.assert_allclose(getattr(got, fld).numpy(), np.asarray(getattr(want, fld)),
                                       rtol=1e-6, err_msg=fld)
        np.testing.assert_array_equal(got.volume.numpy(), np.asarray(want.volume))


def _spy(monkeypatch, engine: bool):
    """(the bars each symbol's replay gets, in order; ``portfolio_mc`` or
    ``portfolio_mc_engine``) with the replay spied on."""
    seen = []
    owner, name = (P.enginepath, "engine_path_replay") if engine else (P, "gated_path_replay")
    real = getattr(owner, name)

    def spy(bars, *a, **k):
        seen.append(bars)
        return real(bars, *a, **k)

    monkeypatch.setattr(owner, name, spy)
    return seen, P.portfolio_mc_engine if engine else P.portfolio_mc


def _captured(monkeypatch, engine: bool, sampler: str):
    """The bars each symbol's replay got inside the book, one block of 512
    paths."""
    seen, fn = _spy(monkeypatch, engine)
    fn(2, _levels(), EngineParams.default(), S0, SIGMAS, BETAS, WEIGHTS, num_paths=512,
       num_bars=W, block_paths=512, hist_bars=THIST, device="cpu", **_skw(sampler))
    return seen


@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_pipeline_bars_are_the_jax_books_on_its_own_draws(monkeypatch, engine, sampler):
    """Inside ``portfolio_mc`` / ``portfolio_mc_engine``: under the bootstrap
    samplers every symbol's bars are JAX's ``_boot_bars_from_idx`` of the
    block's joint indices (one set for the book, on the market stream) over
    its own tables, rebased on its own s0 (prices within 1e-6, recorded
    volumes exact); under Heston its log closes are JAX's chain on the mixed
    market and own shocks (bit for bit where PyTorch's log of its spot is
    XLA's, else within 2 ulps), its bars the port's form on its
    bridge draws bit for bit, and the engine's volumes the volume model on
    its mixed price shock bit for bit."""
    seen = _captured(monkeypatch, engine, sampler)
    assert len(seen) == 3
    n = 512
    if sampler != "heston":
        idx = PG.joint_resample_idx(2, 0, num_paths=n, num_bars=W, n_hist=HIST[0].shape[1],
                                    block_len=BLOCK_LEN if sampler == "block_bootstrap" else 0)
        f = jax.jit(lambda i, t, s0: jP._boot_bars_from_idx(i, t, s0, num_paths=n))
        for s, bars in enumerate(seen):
            tab = [np.asarray(t) for t in jPG.bootstrap_tables(*(x[s] for x in HIST))]
            want = f(jnp.asarray(idx.numpy()), tuple(tab), jnp.float32(S0[s]))
            for fld in ("open", "high", "low", "close"):
                np.testing.assert_allclose(getattr(bars, fld).numpy(),
                                           np.asarray(getattr(want, fld)), rtol=1e-6)
            np.testing.assert_array_equal(bars.volume.numpy(), np.asarray(want.volume))
        return
    kw = dict(num_paths=n, num_bars=2 * W, antithetic=False, device="cpu")
    zm = P._normals(2, prng.STREAM_MARKET, 0, symbol=0, **kw)
    for s, bars in enumerate(seen):
        eps = P._normals(2, prng.STREAM_PATH, 0, symbol=s, **kw)
        z = mix_shocks(BETAS[s], zm[:, :W], eps[:, :W])
        zq = mix_shocks(BETAS[s], zm[:, W:], eps[:, W:])
        lc = np.asarray(_jax_heston_chain(z.numpy(), zq.numpy(), np.float32(S0[s]),
                                          jP._heston_vec(HESTON))[0])
        got_lc = PG.heston_log_closes(z, zq, s0=S0[s], heston=HESTON, dt=DT)[0].numpy()
        if float(torch.log(torch.tensor(S0[s]))) == float(jnp.log(np.float32(S0[s]))):
            np.testing.assert_array_equal(got_lc, lc)
        else:                                   # log(s0) an ulp apart: the chain carries it
            assert _ulps(got_lc, lc) <= 2

        def uniforms(stream, s=s):
            return prng.uniform_rows(2, stream, block0=0, n_blocks=1, n_rows=W, lanes=n,
                                     symbol=s)[0].T

        vol = PG.VolumeModel().volumes(2, 0, z, num_paths=n, num_bars=W, symbol=s)
        want = PG.heston_bars_from_shocks(z, zq, uniforms(prng.STREAM_BRIDGE_HI),
                                          uniforms(prng.STREAM_BRIDGE_LO), s0=S0[s],
                                          heston=HESTON, dt=DT, volume=vol if engine else None)
        for fld in want._fields:
            assert torch.equal(getattr(bars, fld), getattr(want, fld)), fld


@pytest.mark.parametrize("engine", [False, True])
def test_joint_days_equal_bars_for_equal_symbols(monkeypatch, engine):
    """Under bootstrap two symbols with equal histories and spots replay the
    same bars on every path (the indices are the market's), whatever their
    loadings; under Heston at beta 1 their closes are the market's."""
    twin = PG.PathBars(*(torch.from_numpy(np.stack([x[0], x[0], x[2]])) for x in HIST))
    seen, fn = _spy(monkeypatch, engine)
    kw = dict(num_paths=256, num_bars=W, block_paths=256, device="cpu")
    fn(4, _levels(), EngineParams.default(), [100.0, 100.0, 99.9], SIGMAS, [0.9, -0.2, 0.5],
       WEIGHTS, sampler="bootstrap", hist_bars=twin, **kw)
    for f in seen[0]._fields:
        assert torch.equal(getattr(seen[0], f), getattr(seen[1], f)), f
    assert not torch.equal(seen[0].close, seen[2].close)
    seen.clear()
    fn(4, _levels(), EngineParams.default(), [100.0, 100.0, 99.9], SIGMAS, [1.0, 1.0, 0.5],
       WEIGHTS, sampler="heston", **kw)
    assert torch.equal(seen[0].close, seen[1].close)
    assert not torch.equal(seen[0].high, seen[1].high)      # the bridges stay their own


def test_plain_book_joint_days_differ_only_in_ties():
    """The kernels' plain form: two book symbols on equal tables and spots,
    with their own injected uniforms, get equal bars on every path (the
    market's index uniforms pick the recorded bar); their tie coins (rows 0,
    1 of their own layout) differ."""
    lanes = 64
    lay = GatedLayout(W, False, "block_bootstrap", book=True)
    rng = np.random.default_rng(12)
    u = torch.from_numpy(rng.uniform(1e-6, 1.0, (2, 1, lay.u_rows, 8, lanes)).astype(np.float32))
    um = torch.from_numpy(rng.uniform(1e-6, 1.0, (1, MarketLayout(W, "bootstrap").u_rows, 8,
                                                   lanes)).astype(np.float32))
    samp = make_sampler("block_bootstrap", tables=TABLES[:1], block_len=BLOCK_LEN, symbols=2,
                        shared=True)
    out = [cuda_gated.gated_bars_from_uniforms(u[s], lay, s0=100.0, market_uniforms=um,
                                               beta=b, sampler=samp.row(s))
           for s, b in ((0, 0.9), (1, -0.3))]
    for f in out[0][0]._fields:
        assert torch.equal(getattr(out[0][0], f), getattr(out[1][0], f)), f
    assert not torch.equal(out[0][1], out[1][1])
    for t2 in range(W // 2):                     # bar 2 t2's tie on row 0, 2 t2 + 1's on row 1
        for half in range(2):
            assert torch.equal(out[1][1][:, 2 * t2 + half], u[1, 0, lay.row(t2, half)].reshape(-1))


def _twin_book(mod, lanes, sampler, tables):
    """A 3-symbol book whose symbols 0 and 1 are alike but for their
    histories (the same levels, spot, knobs and injected uniforms), through
    the plain version: its per-path rows."""
    lay = (EngineLayout if mod is cuda_engine else GatedLayout)(W, False, sampler, book=True)
    rng = np.random.default_rng(21)
    u = torch.from_numpy(rng.uniform(1e-6, 1.0, (1, 1, lay.u_rows, 8, lanes)).astype(
        np.float32)).expand(3, -1, -1, -1, -1).contiguous()
    um = torch.from_numpy(rng.uniform(1e-6, 1.0, (1, MarketLayout(W, sampler).u_rows, 8,
                                                   lanes)).astype(np.float32))
    args = (0, U.stack_levels([ROWS3[0]] * 3, max_levels=4), EngineParams.default(),
            [100.0] * 3, [0.3] * 3, BETAS, WEIGHTS)
    kw = dict(paths_per_symbol=8 * lanes, num_bars=W, lanes=lanes, external_uniforms=u,
              market_uniforms=um, tables=tables, per_path=True, **_skw(sampler))
    ref = (cuda_engine.engine_corr_totals_reference if mod is cuda_engine
           else cuda_gated.gated_corr_totals_reference)
    return ref(*args, **kw)[2]


@pytest.mark.parametrize("mod,lanes", [(cuda_gated, 128), (cuda_engine, 64)])
@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap"])
def test_swapping_two_histories_swaps_their_rows(mod, lanes, sampler):
    """Symbol s reads its own table: swapping two symbols' histories swaps
    their per-path rows bit for bit (a version reading symbol 0's table for
    every symbol would give them equal rows)."""
    a = _twin_book(mod, lanes, sampler, TABLES)
    b = _twin_book(mod, lanes, sampler, TABLES[[1, 0, 2]])
    assert torch.equal(a[0], b[1]) and torch.equal(a[1], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("mod,lanes", [(cuda_gated, 128), (cuda_engine, 64)])
def test_one_shared_table_is_every_symbols(mod, lanes):
    """[1, 5, H] tables (the CLI's one history) give what their [S, 5, H]
    copies give, and under bootstrap the loadings do not matter."""
    one = _twin_book(mod, lanes, "bootstrap", TABLES[:1])
    copies = _twin_book(mod, lanes, "bootstrap", TABLES[:1].expand(3, -1, -1).contiguous())
    assert torch.equal(one, copies)
    assert torch.equal(one[0], one[1]) and torch.equal(one[1], one[2])


def test_book_sampler_arguments_are_checked():
    lv, p = _levels(), EngineParams.default()
    base = (0, lv, p, S0, SIGMAS, BETAS, WEIGHTS)
    fused = dict(paths_per_symbol=8 * 64, num_bars=8, lanes=64, device="cpu")
    pipe = dict(num_paths=256, num_bars=8, block_paths=256, device="cpu")
    entries = ((cuda_gated.mc_paths_gated_corr_fused, fused),
               (cuda_engine.mc_paths_engine_corr_fused, fused),
               (P.portfolio_mc, pipe), (P.portfolio_mc_engine, pipe))
    for fn, kw in entries:
        with pytest.raises(ValueError, match="antithetic"):
            fn(*base, sampler="heston", antithetic=True, **kw)
        with pytest.raises(ValueError, match="requires hist_bars"):
            fn(*base, sampler="block_bootstrap", **kw)
        with pytest.raises(ValueError, match=r"\[S, H\]"):
            fn(*base, sampler="bootstrap", hist_bars=PG.PathBars(*(x[0] for x in THIST)), **kw)
        with pytest.raises(ValueError, match="samplers"):
            fn(*base, sampler="garch", **kw)
    with pytest.raises(ValueError, match="block_len"):
        cuda_gated.mc_paths_gated_corr_fused(*base, sampler="block_bootstrap",
                                             tables=TABLES[:, :, :4], **fused)
    with pytest.raises(ValueError, match=r"\[3 or 1, 5, H\]"):
        cuda_engine.mc_paths_engine_corr_fused(*base, sampler="bootstrap", tables=TABLES[:2],
                                               **fused)
    um = torch.rand(1, 8, 8, 64)           # gbm's market rows, not Heston's 16
    u = torch.rand(3, 1, GatedLayout(8, False, "heston", True).u_rows, 8, 64)
    with pytest.raises(ValueError, match="external_uniforms must have shape"):
        cuda_gated.mc_paths_gated_corr_fused(*base, sampler="heston", external_uniforms=u,
                                             market_uniforms=um, **fused)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gated.gated_corr_rows(*base, sampler="heston", paths_per_symbol=512, num_bars=8,
                                   lanes=64, device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(tmp_path, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--db", str(tmp_path / "t.db"), "book", "--device", "cpu", "--backend",
                       "torch", "--num-symbols", "3", "--num-paths", "512", "--num-bars", "16",
                       "--betas", "0.2,0.5,0.8", *argv])
    assert rc == 0
    return [json.loads(x) for x in buf.getvalue().strip().splitlines()]


def _csv(tmp_path, n: int = 500) -> str:
    o, h, lo, c, v = histories(17, 1, n)
    path = tmp_path / "bars.csv"
    path.write_text("t,o,h,l,c,v\n" + "".join(
        f"{60_000 * i},{o[0, i]:.2f},{h[0, i]:.2f},{lo[0, i]:.2f},{c[0, i]:.2f},{v[0, i]:.0f}\n"
        for i in range(n)))
    return str(path)


@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cli_book_samplers_run_on_the_cpu(tmp_path, engine, sampler):
    """``book [--engine] --sampler S`` on the CPU: a row a symbol and the
    book's, in the JAX CLI's form, other than the gbm book's; the bootstrap
    samplers on the default 390-bar fixture and on a ``--bars-csv``
    history (which changes the rows)."""
    flags = ["--engine"] if engine else []
    gbm = _cli(tmp_path, *flags)
    rows = _cli(tmp_path, *flags, "--sampler", sampler)
    assert len(rows) == 4 and rows[3]["portfolio"] is True
    assert [list(r) for r in rows] == [list(r) for r in gbm]
    assert rows != gbm
    for r in rows[:3]:
        assert 0.0 < r["hit_rate"] < 1.0 and r["mean_trades"] >= 1.0
    if sampler == "heston":
        assert _cli(tmp_path, *flags, "--sampler", "heston", "--heston-xi", "1.2") != rows
    else:
        assert _cli(tmp_path, *flags, "--sampler", sampler, "--bars-csv", _csv(tmp_path)) != rows
        if sampler == "block_bootstrap":
            assert _cli(tmp_path, *flags, "--sampler", sampler, "--block-len", "3") != rows


def test_cli_book_shares_one_history_as_the_jax_cli_does(tmp_path):
    """The CLI broadcasts its one history to every symbol ([S, H] rows, as
    the JAX CLI does) and runs ``portfolio_mc`` on it."""
    csv = _csv(tmp_path)
    rows = _cli(tmp_path, "--sampler", "bootstrap", "--bars-csv", csv)
    cols = cli._load_bars(type("A", (), {"bars_csv": csv})())
    one = PG.PathBars(*(torch.as_tensor(cols[k], dtype=torch.float32) for k in "ohlcv"))
    lv = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
                          {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}]] * 3,
                        max_levels=4)
    params = EngineParams.from_settings(lambda k, d=None: d)
    sym, port = P.portfolio_mc(
        0, lv, params, [100.0] * 3, [0.3] * 3, [0.2, 0.5, 0.8], [1 / 3] * 3,
        num_paths=512, num_bars=16, block_paths=512, sampler="bootstrap",
        hist_bars=PG.PathBars(*(x.expand(3, -1) for x in one)), device="cpu")
    assert [r["hit_rate"] for r in rows[:3]] == [float(x) for x in sym.hit_rate]
    assert rows[3]["mean_r"] == float(port.mean_r)
