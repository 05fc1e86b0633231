"""The port's recorded-bar and Heston samplers held against the JAX package on
the same inputs: the bootstrap tables to an ulp, the XLA pipeline's bar
builders on JAX's own draws, the Heston step's fused multiply-adds bit for
bit against jitted copies of the JAX kernels' expressions, the CSV loader,
and the port CLI's ``paths [--gated | --engine] --sampler ...`` on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.host import cli as jcli
from qmmx_monolithic_monte_carlo_tpu.io import native as jnative
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
from qmmx_monolithic_monte_carlo_tpu.utils import prng as jprng
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.io import native
from qmmx_monolithic_monte_carlo_tpu_torch.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu_torch.ops import samplers as SM
from qmmx_monolithic_monte_carlo_tpu_torch.sim import pathsim as PS

torch.set_num_threads(2)

HESTON = dict(v0=0.04, kappa=3.0, theta=0.04, xi=0.6, rho=-0.7)


def _history(seed: int, h: int):
    """A recorded o/h/l/c/v history with cents-rounded prices, opening gaps,
    wicks and positive volumes, float32."""
    rng = np.random.default_rng(seed)
    c = np.round(100.0 + np.cumsum(rng.normal(0, 0.08, h)), 2)
    prev = np.concatenate([[c[0]], c[:-1]])
    o = np.round(prev + rng.normal(0, 0.02, h) * (rng.uniform(size=h) < 0.1), 2)
    hi = np.round(np.maximum(o, c) + np.abs(rng.normal(0, 0.05, h)), 2)
    lo = np.round(np.minimum(o, c) - np.abs(rng.normal(0, 0.05, h)), 2)
    v = np.round(rng.lognormal(9.0, 0.5, h))
    return [x.astype(np.float32) for x in (o, hi, lo, c, v)]


def _ulps(a, b) -> int:
    return int(np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                      - np.asarray(b, np.float32).view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("h", [390, 98_280])
def test_bootstrap_tables_within_an_ulp_of_jax(h):
    """PyTorch's float32 log is not XLA's: every channel within 1 ulp, the
    volumes exact."""
    hist = _history(h, h)
    want = jPG.bootstrap_tables(*hist)
    got = PG.bootstrap_tables(*(torch.from_numpy(x) for x in hist))
    for ch in range(4):
        assert _ulps(got[ch].numpy(), np.asarray(want[ch])) <= 1, ch
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def _jax_hist(hist):
    return jPG.PathBars(*(jnp.asarray(x) for x in hist))


@pytest.mark.parametrize("h,w,s0", [(390, 40, 100.0), (5000, 24, 412.37)])
def test_bootstrap_bars_from_jax_draws_match_jax(h, w, s0):
    """``bootstrap_bars_from_draws`` on JAX's own indices and JAX's tables
    against ``bootstrap_paths``: prices within 1e-6, volumes exact."""
    hist = _history(7 + h, h)
    key = jax.random.key(11)
    n = 512
    want = jPG.bootstrap_paths(key, **dict(zip(("hist_open", "hist_high", "hist_low",
                                                "hist_close", "hist_volume"), hist)),
                               num_paths=n, num_bars=w, s0=s0)
    idx = jax.random.randint(jprng.key_for(key, jprng.STREAM_BOOTSTRAP), (n, w), 0, h)
    tables = [np.asarray(t) for t in jPG.bootstrap_tables(*hist)]
    got = PG.bootstrap_bars_from_draws(torch.from_numpy(np.asarray(idx)), tables, s0=s0)
    for f in ("open", "high", "low", "close"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.volume.numpy(), np.asarray(want.volume))


@pytest.mark.parametrize("block_len,w", [(10, 40), (7, 30)])
def test_block_bootstrap_bars_from_jax_draws_match_jax(block_len, w):
    hist = _history(3, 300)
    key = jax.random.key(5)
    n = 256
    want = jPG.block_bootstrap_paths(
        key, **dict(zip(("hist_open", "hist_high", "hist_low", "hist_close",
                         "hist_volume"), hist)),
        num_paths=n, num_bars=w, s0=100.0, block_len=block_len)
    starts = jax.random.randint(jprng.key_for(key, jprng.STREAM_BOOTSTRAP),
                                (n, -(-w // block_len)), 0, 300 - block_len)
    idx = PG.block_indices(torch.from_numpy(np.asarray(starts)), w, block_len)
    got = PG.bootstrap_bars_from_draws(idx, [np.asarray(t) for t in jPG.bootstrap_tables(*hist)],
                                       s0=100.0)
    for f in ("open", "high", "low", "close"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.volume.numpy(), np.asarray(want.volume))
    with pytest.raises(ValueError, match="shorter than block_len"):
        PG.block_bootstrap_paths(0, 0, num_paths=8, num_bars=4, s0=100.0, block_len=300,
                                 hist_bars=PG.PathBars(*(torch.from_numpy(x) for x in hist)))


@pytest.mark.parametrize("params", [HESTON, dict(v0=0.09, kappa=1.5, theta=0.02, xi=0.9,
                                                 rho=0.3)])
def test_heston_bars_from_jax_draws_match_jax(params):
    """``heston_bars_from_draws`` on JAX's own normals and bridge uniforms
    against ``heston_paths`` (its ``lax.scan`` chain): within 1e-6."""
    key = jax.random.key(9)
    n, w = 512, 40
    want = jPG.heston_paths(key, num_paths=n, num_bars=w, s0=100.0, **params)

    def normal(k):
        return np.asarray(jax.random.normal(jprng.key_for(key, jprng.STREAM_PATH, k),
                                            (n, w), jnp.float32))

    def uniform(stream):
        return np.asarray(jax.random.uniform(jprng.key_for(key, stream, 1), (n, w),
                                             jnp.float32, 1e-12, 1.0))

    got = PG.heston_bars_from_draws(
        torch.from_numpy(normal(1)), torch.from_numpy(normal(2)),
        torch.from_numpy(uniform(jprng.STREAM_BRIDGE_HI)),
        torch.from_numpy(uniform(jprng.STREAM_BRIDGE_LO)), s0=100.0, **params)
    for f in ("open", "high", "low", "close"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)


def test_philox_samplers_shapes_and_streams():
    hist = PG.PathBars(*(torch.from_numpy(x) for x in _history(1, 390)))
    kw = dict(num_paths=64, num_bars=12, s0=100.0)
    for bars in (PG.bootstrap_paths(3, 1, hist_bars=hist, **kw),
                 PG.block_bootstrap_paths(3, 1, block_len=5, hist_bars=hist, **kw),
                 PG.heston_paths(3, 1, antithetic=True, **kw)):
        for f in bars:
            assert f.shape == (64, 12) and bool(torch.isfinite(f).all())
        assert bool((bars.high >= bars.low).all())
    a = PG.bootstrap_paths(3, 1, hist_bars=hist, **kw)
    b = PG.bootstrap_paths(3, 2, hist_bars=hist, **kw)
    assert torch.equal(a.close, PG.bootstrap_paths(3, 1, hist_bars=hist, **kw).close)
    assert not torch.equal(a.close, b.close)
    # within a block the indices are consecutive bars of the history
    starts = torch.tensor([[3, 40], [0, 17]])
    np.testing.assert_array_equal(PG.block_indices(starts, 8, 5).numpy(),
                                  [[3, 4, 5, 6, 7, 40, 41, 42], [0, 1, 2, 3, 4, 17, 18, 19]])


def _jax_heston_stream(h):
    """Jitted copies of the JAX kernels' Heston expressions: the streamed
    close and variance of ``_gated_lifecycle_loop`` / ``_engine_lifecycle_loop``
    (pallas_mc.py:1361-1375, pallas_engine.py:502-518) and the block
    increment of ``_heston_block`` (pallas_mc.py:206-215)."""
    v0, kap, th, xi, rho, mu, dt = (h[k] for k in ("v0", "kappa", "theta", "xi", "rho",
                                                   "mu", "dt"))
    rho_perp = float(np.sqrt(max(0.0, 1.0 - rho * rho)))

    @jax.jit
    def stream(log_s, v, z, zq):
        dtf = jnp.float32(dt)
        v_pos = jnp.maximum(v, 0.0)
        sig_bar = jnp.sqrt(v_pos * dtf)
        log_close = log_s + (jnp.float32(mu) - 0.5 * v_pos) * dtf + sig_bar * z
        v_new = (v + jnp.float32(kap) * (jnp.float32(th) - v_pos) * dtf
                 + jnp.float32(xi) * sig_bar * (jnp.float32(rho) * z
                                               + jnp.float32(rho_perp) * zq))
        return log_close, v_new

    @jax.jit
    def block(v, z, zq):
        z2 = jnp.float32(rho) * z + jnp.float32(rho_perp) * zq
        dtf = jnp.float32(dt)
        v_pos = jnp.maximum(v, 0.0)
        sig_bar = jnp.sqrt(v_pos * dtf)
        incr = (jnp.float32(mu) - 0.5 * v_pos) * dtf + sig_bar * z
        v_new = (v + jnp.float32(kap) * (jnp.float32(th) - v_pos) * dtf
                 + jnp.float32(xi) * sig_bar * z2)
        return incr, v_new

    return stream, block


@pytest.mark.parametrize("h", [dict(HESTON, mu=0.0, dt=1.0 / (390.0 * 252.0)),
                               dict(v0=0.09, kappa=1.5, theta=0.02, xi=0.9, rho=0.3,
                                    mu=0.05, dt=1.0 / 98280.0)])
def test_heston_step_fuses_as_xla_does_bit_for_bit(h):
    """Under jit XLA's CPU compiler fuses rho_perp zq into the shock, the
    shock and the theta term into the variance (kappa * dt folded), and
    sig_bar z into the close: ``samplers.heston_step`` / ``heston_shock``
    (and ``fmaf`` in sampler.cuh) do the same, bit for bit."""
    rng = np.random.default_rng(2)
    n = 100_000
    z, zq = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    v = rng.uniform(-0.01, 0.2, n).astype(np.float32)
    log_s = rng.uniform(-1e-4, 4.7, n).astype(np.float32)
    stream, block = _jax_heston_stream(h)
    want_close, want_v = (np.asarray(x) for x in stream(log_s, v, z, zq))
    want_incr, want_vb = (np.asarray(x) for x in block(v, z, zq))
    hc = SM.HestonConsts.make({k: h[k] for k in HESTON}, mu=h["mu"], dt=h["dt"])
    tz, tzq, tv, tls = (torch.from_numpy(x) for x in (z, zq, v, log_s))
    drift, sig_bar, _, v_next = SM.heston_step(tv, tz, SM.heston_shock(tz, tzq, hc), hc)
    from qmmx_monolithic_monte_carlo_tpu_torch.utils.floats import fma

    close = fma(sig_bar, tz, fma(drift, torch.tensor(hc.dt), tls))
    incr = fma(sig_bar, tz, drift * hc.dt)
    np.testing.assert_array_equal(v_next.numpy(), want_v)
    np.testing.assert_array_equal(v_next.numpy(), want_vb)
    np.testing.assert_array_equal(close.numpy(), want_close)
    np.testing.assert_array_equal(incr.numpy(), want_incr)


def test_make_sampler_checks():
    hist = PG.PathBars(*(torch.from_numpy(x) for x in _history(1, 50)))
    with pytest.raises(ValueError, match="requires hist_bars"):
        SM.make_sampler("bootstrap")
    with pytest.raises(ValueError, match="longer than block_len"):
        SM.make_sampler("block_bootstrap", hist_bars=hist, block_len=50)
    with pytest.raises(ValueError, match="samplers"):
        SM.make_sampler("garch")
    s = SM.make_sampler("block_bootstrap", hist_bars=hist, block_len=10)
    assert s.hist_len == 50 and s.block_len == 10 and tuple(s.tables.shape) == (5, 50)
    assert SM.make_sampler("bootstrap", hist_bars=hist, block_len=10).block_len == 0
    hc = SM.make_sampler("heston", heston=dict(rho=-0.7)).heston
    assert hc.rho_perp == float(np.float32(np.sqrt(1.0 - 0.49)))
    assert hc.kappa_dt == float(np.float32(3.0) * np.float32(1.0 / (390.0 * 252.0)))


def test_index_arithmetic_matches_the_jax_kernels():
    """min(floor(u H), H - 1) and the block start in float32, as the JAX
    kernels compute them (pallas_mc.py:250, :257), on uniforms near 1."""
    u = np.concatenate([np.random.default_rng(0).uniform(0, 1, 10_000),
                        1.0 - np.float32(2.0 ** -24) * np.arange(8)]).astype(np.float32)
    for h, bl in ((390, 10), (98_280, 10), (4_194_303, 7)):
        hf, blf = np.float32(h), np.float32(bl)
        want_i = np.minimum(np.floor(u * hf), hf - np.float32(1.0))
        want_s = np.minimum(np.floor(u * (hf - blf)), hf - blf - np.float32(1.0))
        tu = torch.from_numpy(u)
        np.testing.assert_array_equal(SM.iid_index(tu, h).numpy(), want_i)
        np.testing.assert_array_equal(SM.block_start(tu, h, bl).numpy(), want_s)
        assert float(SM.iid_index(tu, h).max()) <= h - 1
    assert [SM.block_offset(t, 10) for t in (0, 9, 10, 39)] == [0.0, 9.0, 0.0, 9.0]


def _write_csv(path, rows, header="t,o,h,l,c,v"):
    with open(path, "w") as f:
        f.write(header + "\n" + "\n".join(rows) + "\n")


def test_parse_bars_csv_matches_jax(tmp_path):
    """The port's loader against JAX's pure-Python parser: any column order,
    a missing or empty volume reads 0, a bad header raises; the row cap."""
    hist = _history(4, 200)
    t = 1_700_000_000_000 + 60_000 * np.arange(200)
    rows = [f"{t[i]},{hist[0][i]:.2f},{hist[1][i]:.2f},{hist[2][i]:.2f},{hist[3][i]:.2f},"
            f"{'' if i % 17 == 0 else int(hist[4][i])}" for i in range(200)]
    p = tmp_path / "bars.csv"
    _write_csv(p, rows)
    q = tmp_path / "cols.csv"
    _write_csv(q, [f"{hist[3][i]:.2f},{t[i]},{hist[0][i]:.2f},{hist[2][i]:.2f},"
                   f"{hist[1][i]:.2f}" for i in range(200)], header="c,t,o,l,h")
    for path in (p, q):
        got, want = native.parse_bars_csv(str(path)), jnative._parse_bars_csv_py(str(path))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    bad = tmp_path / "bad.csv"
    _write_csv(bad, ["1,2,3"], header="t,o,h")
    with pytest.raises(ValueError, match="header must contain"):
        native.parse_bars_csv(str(bad))
    with pytest.raises(ValueError, match="more than 100 bars"):
        native.parse_bars_csv(str(p), max_rows=100)


def test_pipelines_run_every_sampler():
    """``sim.pathsim.sample_block`` and the three pipelines under each
    sampler: finite, the bootstrap bars' volumes the recorded ones."""
    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath, gatedpath
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

    hist = PG.PathBars(*(torch.from_numpy(x) for x in _history(2, 390)))
    bars = PS.sample_block(1, 0, block_paths=64, num_bars=16, s0=100.0, mu=0.0, sigma=0.3,
                           dt=1e-5, sampler="bootstrap", hist_bars=hist)
    assert bool(torch.isin(bars.volume, hist.volume).all())
    levels = Levels.from_rows([{"color": "blue", "type": "solid", "index": 0,
                                "price": 100.0}], max_levels=8)
    kw = dict(num_paths=1024, num_bars=16, sigma=0.3, block_paths=512, device="cpu",
              hist_bars=hist, block_len=5)
    for s in ("bootstrap", "block_bootstrap", "heston"):
        a = PS.mc_paths(0, levels, EngineParams.default(), sampler=s, **kw)
        g = gatedpath.mc_paths_gated(0, levels, EngineParams.default(), sampler=s, **kw)
        e, skips, _ = enginepath.mc_paths_engine(0, levels, EngineParams.default(),
                                                 sampler=s, **kw)
        for stats in (a, g, e):
            assert float(stats.n) == 1024 and float(stats.n_entered) > 0
            assert np.isfinite(float(stats.mean_r))
        assert int(skips.sum()) > 0


_JAX_KEYS = {}


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_keys(family, tmp_path, capsys):
    """The JAX CLI's output keys of ``paths`` in ``family`` under a sampler
    (xla backend, a small run), once a family."""
    if family not in _JAX_KEYS:
        flags = {"first contact": [], "gated": ["--gated"], "engine": ["--engine"]}[family]
        _JAX_KEYS[family] = set(_run(jcli.main, [
            "--db", str(tmp_path / "j.db"), "paths", *flags, "--num-paths", "2048",
            "--num-bars", "16", "--sampler", "heston", "--backend", "xla"], capsys))
    return _JAX_KEYS[family]


@pytest.mark.parametrize("family", ["first contact", "gated", "engine"])
@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap", "heston"])
def test_cli_paths_samplers_on_the_cpu(tmp_path, capsys, family, sampler):
    """``paths [--gated | --engine] --device cpu --sampler ...`` runs at a
    small size with the JAX CLI's keys (the bootstrap samplers on a
    ``--bars-csv`` history), and refuses ``--antithetic``."""
    flags = {"first contact": [], "gated": ["--gated"], "engine": ["--engine"]}[family]
    argv = ["--db", str(tmp_path / "t.db"), "paths", *flags, "--num-paths", "4096",
            "--num-bars", "16", "--device", "cpu", "--sampler", sampler]
    if sampler != "heston":
        hist = _history(6, 400)
        t = 60_000 * np.arange(400)
        _write_csv(tmp_path / "b.csv", [f"{t[i]},{hist[0][i]:.2f},{hist[1][i]:.2f},"
                                        f"{hist[2][i]:.2f},{hist[3][i]:.2f},{int(hist[4][i])}"
                                        for i in range(400)])
        argv += ["--bars-csv", str(tmp_path / "b.csv"), "--block-len", "5"]
    out = _run(cli.main, argv, capsys)
    assert set(out) == _jax_keys(family, tmp_path, capsys)
    assert out["paths"] == 4096.0 and 0.0 < out["entered"] <= 4096.0
    assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))
    with pytest.raises(SystemExit, match="gbm normals only"):
        cli.main(argv + ["--antithetic"])


def test_cli_default_history_is_the_jax_fixture(tmp_path):
    """Without ``--bars-csv`` the bootstrap samplers resample the JAX CLI's
    synthetic fixture at max(390, --num-bars) bars, bar for bar."""
    import argparse

    for n in (40, 500):
        args = argparse.Namespace(seed=3, num_bars=n, s0=100.0, bars_csv=None)
        got = cli._hist_paths_bars(args)
        want = jcli._hist_paths_bars(args)
        for f in ("open", "high", "low", "close", "volume"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        assert got.close.shape[0] == max(390, n)


@pytest.mark.parametrize("family,num_bars,fits", [
    ("first contact", 25, True), ("gated", 25, False), ("engine", 25, True),
    ("first contact", 40, True)])
def test_fits_takes_an_odd_bar_count_for_first_contact_bootstrap(family, num_bars, fits):
    """One index uniform a bar: the first-contact bootstrap kernel takes an
    odd horizon; the gated loop walks double bars; the engine's kernels end
    an odd horizon with a half step, under every sampler."""
    import argparse

    args = argparse.Namespace(cmd="paths", num_bars=num_bars, num_paths=1 << 16,
                              gated=family == "gated", engine=family == "engine",
                              sampler="bootstrap")
    assert (cli._fits(args, [{}]) is None) == fits
    args.sampler = "heston"
    assert (cli._fits(args, [{}]) is None) == (num_bars % 2 == 0 or family == "engine")


@pytest.mark.parametrize("sampler", ["gbm", "bootstrap", "block_bootstrap", "heston"])
@pytest.mark.parametrize("noise", [False, True])
def test_layouts_take_the_jax_kernels_strides(sampler, noise):
    """``ops/draws``' layouts against the JAX kernels' own: ``_gated_stride``
    (pallas_mc.py:1052), ``_draw_stride`` (pallas_engine.py:135) and the
    first-contact rows (pallas_mc.py:606-622, :744-754)."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_engine import _draw_stride
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import _gated_stride
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                                 GbmLayout)

    w = 16
    assert GatedLayout(w, noise, sampler).stride == _gated_stride(sampler, noise)
    assert EngineLayout(w, noise, sampler).stride == _draw_stride(sampler, noise)
    rows = {"gbm": 3 * w + 1, "heston": 4 * w + 1}.get(sampler, w + 1) + 4 * noise
    assert GbmLayout(w, noise, sampler).n_rows == rows
    if sampler in ("bootstrap", "block_bootstrap"):
        assert GbmLayout(w + 1, noise, sampler).n_rows == rows + 1   # any horizon
    else:
        with pytest.raises(ValueError, match="even"):
            GbmLayout(w + 1, noise, sampler)
