"""The correlated books' kernels, plain versions and pipeline, the port alone:
the market layout; the one-factor mix and the book's curve fold; the plain
books' identities (beta = 0 is the universe bit for bit, a one-symbol book
of weight 1 is its symbol, beta = 1 moves every symbol with the market,
antithetic books mirror the market and the idiosyncratic normals alike,
co-movement raises the book's variance); the entries' checks, device rules,
launch counts and int64 folds; the CLI's ``book``; the fits' devices; and,
where a CUDA device is present, each book kernel against its plain version
path by path and against the universe kernels at beta = 0.

The plain versions are held against JAX in ``test_torch_book.py``.  Nothing
here imports JAX, so the CUDA tests also run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_book_kernel.py -m cuda``."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.models import logistic as L
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                             MarketLayout, market_uniforms)
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import portfolio as P
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath as E
from qmmx_monolithic_monte_carlo_tpu_torch.sim import gatedpath as G
from qmmx_monolithic_monte_carlo_tpu_torch.sim.book import BookCurve, mix_shocks, perp_of
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.utils import prng

torch.set_num_threads(2)

DT = 1.0 / (390.0 * 252.0)
SYM_ROWS = [
    [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
     {"color": "teal", "type": "solid", "index": 0, "price": 99.6}],
    [{"color": "red", "type": "dashed", "index": 0, "price": 100.3}],
    [{"color": "green", "type": "solid", "index": 0, "price": 99.7},
     {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}],
]
S0 = np.array([100.0, 100.1, 99.9], np.float32)
SIGMAS = np.array([0.3, 0.2, 0.35], np.float32)
BETAS = np.array([0.8, 0.6, 0.3], np.float32)
WEIGHTS = np.array([0.5, 0.3, 0.2], np.float32)
KNOBS = dict(stop_padding=torch.tensor([0.35, 0.20, 0.45]),
             tp_padding=torch.tensor([0.25, 0.40, 0.15]),
             q_min_prob=torch.tensor([0.60, 0.40, 0.55]))
STATS = ("n", "n_tp", "n_stop", "n_open", "n_entered", "sum_trades", "sum_r", "sum_r2",
         "min_r", "max_r", "sum_dd", "max_dd", "hist")


def _levels(rows=SYM_ROWS):
    return U.stack_levels(rows, max_levels=8)


def _params(engine: bool = True):
    """[S] knobs; the gated lifecycle shares its gate (q_min) across symbols."""
    return EngineParams.default().replace(
        **{k: v for k, v in KNOBS.items() if engine or k != "q_min_prob"})


def _noise():
    return McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                   entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                   stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                   target_slip_std=torch.tensor([0.015, 0.0, 0.0]))


def _uniforms(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(1e-6, 1.0, shape).astype(np.float32))


def _same_stats(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in STATS)


# ---------------------------------------------------------------------------
# the market layout, the mix and the book's fold
# ---------------------------------------------------------------------------

def test_market_layout_is_two_rows_a_step_on_the_market_stream_at_symbol_0():
    lay = MarketLayout(16)
    assert lay.u_rows == 16 and [lay.row(3, k) for k in (0, 1)] == [6, 7]
    with pytest.raises(ValueError):
        MarketLayout(15)
    um = market_uniforms(9, lay, block0=2, n_blocks=3, lanes=32)
    assert um.shape == (3, 16, 8, 32)
    want = prng.uniform_rows(9, prng.STREAM_MARKET, block0=2, n_blocks=3, n_rows=16,
                             lanes=8 * 32).view(3, 16, 8, 32)
    assert torch.equal(um, want)
    # blocks are drawn independently of how many a call takes
    assert torch.equal(um[1:], market_uniforms(9, lay, block0=3, n_blocks=2, lanes=32))
    # the market key is symbol 0's key of its own stream, no other stream's
    other = prng.uniform_rows(9, prng.STREAM_GATED, block0=2, n_blocks=1, n_rows=16, lanes=256)
    assert not torch.equal(um[0].reshape(16, -1), other[0])


def test_mix_shocks_fuses_as_the_jax_book_does():
    rng = np.random.default_rng(3)
    zm, eps = (torch.from_numpy(rng.normal(size=4096).astype(np.float32)) for _ in range(2))
    assert torch.equal(mix_shocks(0.0, zm, eps), eps)
    assert torch.equal(mix_shocks(1.0, zm, eps), zm)
    assert torch.equal(mix_shocks(-1.0, zm, eps), -zm)
    for b in (0.8, 0.6, 0.3, -0.45):
        bf = np.float32(b)
        perp = np.float32(np.sqrt(np.float32(1.0 - np.float64(bf) * np.float64(bf))))
        assert float(perp_of(b)) == float(perp)
        pe = (perp * eps.numpy()).astype(np.float32)
        want = (np.float64(bf) * zm.numpy().astype(np.float64) + pe).astype(np.float32)
        np.testing.assert_array_equal(mix_shocks(b, zm, eps).numpy(), want)
    assert float(perp_of(1.5)) == 0.0      # |beta| > 1: no idiosyncratic part


def test_book_curve_folds_final_r_and_drawdown_from_a_zero_peak():
    c1 = torch.tensor([[-0.5, 1.0, 0.0], [-1.0, 3.0, 2.0], [-0.25, 3.0, 2.0],
                       [-1.5, 1.0, 0.5]])
    c2 = torch.tensor([[0.0, 0.0, 0.0], [0.0, -2.0, 0.0], [0.0, -2.0, 1.0],
                       [0.0, -2.0, 1.0]])
    book = BookCurve(3, 4)
    book.add_curve(1.0, c1)
    book.add_curve(0.5, c2)
    out = book.outcome()
    assert torch.equal(out.equity, (c1 + 0.5 * c2)[-1])
    # path 0 never rises above 0: the peak starting at 0 makes its drawdown
    # its deepest fall (1.5), not the fall from its first bar (1.0)
    assert out.max_dd.tolist() == [1.5, 2.0, 1.5]


# ---------------------------------------------------------------------------
# the plain books' identities
# ---------------------------------------------------------------------------

GATED_KW = dict(num_bars=16, lanes=256, dt=DT)
ENGINE_KW = dict(num_bars=16, lanes=256, dt=DT)


@pytest.mark.parametrize("engine", [False, True])
def test_plain_book_at_beta_0_is_the_universe_bit_for_bit(engine):
    """Philox and injected uniforms: each symbol's totals and per-path rows
    equal the universe's, whatever the market draws."""
    mod = cuda_engine if engine else cuda_gated
    lv, p, n = _levels(), _params(engine), 2 * 8 * 256
    layout = (EngineLayout if engine else GatedLayout)(16, True)
    kw = dict(ENGINE_KW if engine else GATED_KW, paths_per_symbol=n, noise=_noise(),
              per_path=True, device="cpu")
    book = (cuda_engine.engine_corr_totals_reference if engine
            else cuda_gated.gated_corr_totals_reference)
    uni = (cuda_engine.engine_universe_totals_reference if engine
           else cuda_gated.gated_universe_totals_reference)
    a = book(4, lv, p, S0, SIGMAS, 0.0, WEIGHTS, **kw)
    b = uni(4, lv, p, S0, SIGMAS, **kw)
    assert all(torch.equal(x[:3], y) for x, y in zip(a, b))
    u = _uniforms(21, (3, 2, layout.u_rows, 8, 256))
    um = _uniforms(22, (2, 16, 8, 256))
    a = book(4, lv, p, S0, SIGMAS, [0.0, 0.0, 0.0], WEIGHTS, external_uniforms=u,
             market_uniforms=um, **kw)
    b = uni(4, lv, p, S0, SIGMAS, external_uniforms=u, **kw)
    assert all(torch.equal(x[:3], y) for x, y in zip(a, b))
    assert a[0].shape == (4, mod.ROW_COUNTS) and a[2].shape == (4, n, mod.PATH_COLS)
    assert int(a[0][3, 5]) == int(a[0][:3, 5].sum())          # the book's trades


@pytest.mark.parametrize("engine", [False, True])
def test_plain_one_symbol_book_of_weight_1_is_its_symbol(engine):
    lv, p = _levels(SYM_ROWS[:1]), EngineParams.default()
    kw = dict(ENGINE_KW if engine else GATED_KW, paths_per_symbol=4 * 8 * 256,
              per_path=True, device="cpu", antithetic=True)
    book = (cuda_engine.engine_corr_totals_reference if engine
            else cuda_gated.gated_corr_totals_reference)
    c, f, rows = book(6, lv, p, [100.0], [0.3], [0.7], [1.0], **kw)
    life = [0, 1, 2, 3, 4, 5]                                # the lifecycle columns
    assert torch.equal(rows[1][:, :6], rows[0][:, :6])
    assert torch.equal(f[1], f[0])
    assert torch.equal(c[1][life], c[0][life])
    assert torch.equal(c[1][-128:], c[0][-128:])             # the histogram
    assert int(c[0][5]) > int(c[0][1]) > 0                  # multi-trade paths


def test_plain_book_at_beta_1_moves_every_symbol_with_the_market():
    um = _uniforms(31, (1, 16, 8, 256))
    closes = []
    for seed in (32, 33):
        u = _uniforms(seed, (1, GatedLayout(16).u_rows, 8, 256))
        bars, _, _ = cuda_gated.gated_bars_from_uniforms(
            u, GatedLayout(16), s0=100.0, sigma=0.3, market_uniforms=um, beta=1.0)
        closes.append(bars.close)
        eng, _, _ = cuda_engine.engine_bars_from_uniforms(
            _uniforms(seed, (1, EngineLayout(16).u_rows, 8, 256)), EngineLayout(16), s0=100.0,
            sigma=0.3, market_uniforms=um, beta=1.0)
        assert torch.equal(eng.close, bars.close)
    assert torch.equal(closes[0], closes[1])
    # and in the pipeline: mixed shocks at beta 1 are the market's, so two
    # symbols' closes agree whatever their own draws
    zm = P._normals(5, prng.STREAM_MARKET, 0, num_paths=64, num_bars=16, antithetic=False,
                    symbol=0, device="cpu")
    c = [P.bars_from_shocks(mix_shocks(1.0, zm, P._normals(
        5, prng.STREAM_PATH, 0, num_paths=64, num_bars=16, antithetic=False, symbol=s,
        device="cpu")), *(torch.rand(64, 16, generator=torch.Generator().manual_seed(s))
                          for _ in range(2)), s0=100.0, sigma=0.3).close for s in (1, 2)]
    assert torch.equal(c[0], c[1])


def test_antithetic_books_mirror_the_market_and_the_idiosyncratic_normals():
    layout = GatedLayout(16)
    u = _uniforms(41, (1, layout.u_rows, 8, 256))
    um = _uniforms(42, (1, 16, 8, 256))
    market = (cuda_gated.market_normals(um, True), 0.6)
    for _, _, z, _, _ in cuda_gated._steps(u, layout, True, market):
        assert torch.equal(z[..., 128:], -z[..., :128])
    plain = (cuda_gated.market_normals(um, False), 0.6)
    z_plain = [z for _, _, z, _, _ in cuda_gated._steps(u, layout, False, plain)]
    z_anti = [z for _, _, z, _, _ in cuda_gated._steps(u, layout, True, market)]
    assert all(torch.equal(a[..., :128], b[..., :128]) for a, b in zip(z_anti, z_plain))
    kw = dict(num_paths=64, num_bars=16, antithetic=True, device="cpu")
    zm = P._normals(5, prng.STREAM_MARKET, 0, symbol=0, **kw)
    z = mix_shocks(0.6, zm, P._normals(5, prng.STREAM_PATH, 0, symbol=2, **kw))
    assert torch.equal(z[32:], -z[:32]) and torch.equal(zm[32:], -zm[:32])


@pytest.mark.parametrize("engine", [False, True])
def test_pipeline_book_at_beta_0_is_the_universe_pipeline(engine):
    lv, p = _levels(SYM_ROWS[:2]), EngineParams.default()
    kw = dict(num_paths=1024, num_bars=16, block_paths=512, device="cpu")
    if engine:
        sym, book, skips, escal = P.portfolio_mc_engine(7, lv, p, S0[:2], SIGMAS[:2], 0.0,
                                                        [0.5, 0.5], **kw)
        for s in range(2):
            st, sk, es = E.mc_paths_engine(7, grid_row(lv, s), p, s0=float(S0[s]),
                                           sigma=float(SIGMAS[s]), symbol=s, **kw)
            assert _same_stats(sym.row(s), st) and torch.equal(skips[s], sk)
            assert int(escal[s]) == int(es)
    else:
        sym, book = P.portfolio_mc(7, lv, p, S0[:2], SIGMAS[:2], 0.0, [0.5, 0.5], **kw)
        uni = U.universe_mc(7, lv, p, S0[:2], SIGMAS[:2], paths_per_symbol=1024, num_bars=16,
                            block_paths=512, gate=G.GateConfig.from_params(p), device="cpu")
        assert _same_stats(sym, uni)
    assert float(book.n) == 1024 and float(book.sum_trades) == float(sym.sum_trades.sum())
    assert float(book.n_entered) >= float(sym.n_entered.max())


@pytest.mark.parametrize("engine", [False, True])
def test_pipeline_book_weighted_sums_and_subadditive_drawdown(engine):
    """tests/test_portfolio.py:39-61 and :88-120 on the port's pipeline."""
    rows2 = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0}],
             [{"color": "orange", "type": "dashed", "index": 0, "price": 50.2}]]
    lv, p = U.stack_levels(rows2, max_levels=4), EngineParams.default()
    s0, sg = np.array([100.0, 50.0], np.float32), np.array([0.3, 0.4], np.float32)
    w, beta = np.array([0.6, 0.4], np.float32), np.array([0.7, 0.7], np.float32)
    kw = dict(num_paths=1 << 11, num_bars=16, block_paths=1 << 10, device="cpu")
    out = (P.portfolio_mc_engine if engine else P.portfolio_mc)(0, lv, p, s0, sg, beta, w, **kw)
    sym, port = out[:2]
    assert float(port.n) == 1 << 11
    wsum = sum(float(w[s]) * float(sym.sum_r[s]) for s in range(2))
    assert float(port.sum_r) == pytest.approx(wsum, rel=1e-4, abs=1e-3)
    dd_bound = sum(float(w[s]) * float(sym.max_dd[s]) for s in range(2))
    assert 0.0 <= float(port.max_dd) <= dd_bound + 1e-5
    assert float(port.sum_trades) == float(sym.sum_trades.sum())
    assert float(port.n_tp) == float(sym.n_tp.sum())
    assert float(port.hist.sum()) == float(port.n_entered)
    if engine:
        skips, escal = out[2:]
        assert skips.shape == (2, len(E.SKIP_REASONS)) and skips.dtype == torch.int64
        assert bool((skips.sum(dim=1) <= (1 << 11) * 16).all()) and escal.dtype == torch.int64


@pytest.mark.parametrize("engine", [False, True])
def test_book_variance_rises_with_beta(engine):
    """tests/test_portfolio.py:64-85 (and :123-146 for the engine): four
    identical symbols co-move at beta = 1, diversify at beta = 0."""
    lv = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": 100.0}]] * 4,
                        max_levels=4)
    run = P.portfolio_mc_engine if engine else P.portfolio_mc

    def var_at(beta):
        port = run(0, lv, EngineParams.default(), np.full(4, 100.0), np.full(4, 0.3),
                   np.full(4, beta), np.full(4, 0.25), num_paths=1 << 12, num_bars=16,
                   block_paths=1 << 11, device="cpu")[1]
        m = float(port.sum_r) / float(port.n_entered)
        return float(port.sum_r2) / float(port.n_entered) - m * m

    assert var_at(1.0) > (1.5 if engine else 2.0) * var_at(0.0)


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def _book_entries():
    lv, p = _levels(), _params(False)
    life = dict(paths_per_symbol=8 * 256, num_bars=8, lanes=256)
    return {
        "mc_paths_gated_corr_fused": lambda **k: cuda_gated.mc_paths_gated_corr_fused(
            0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, **{**life, **k}),
        "gated_corr_totals_reference": lambda **k: cuda_gated.gated_corr_totals_reference(
            0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, **{**life, **k}),
        "mc_paths_engine_corr_fused": lambda **k: cuda_engine.mc_paths_engine_corr_fused(
            0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, **{**life, **k}),
        "engine_corr_totals_reference": lambda **k: cuda_engine.engine_corr_totals_reference(
            0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, **{**life, **k}),
        "parallel.portfolio_mc": lambda **k: P.portfolio_mc(
            0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, num_paths=256, num_bars=8,
            block_paths=256, **k),
        "parallel.portfolio_mc_engine": lambda **k: P.portfolio_mc_engine(
            0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, num_paths=256, num_bars=8,
            block_paths=256, **k),
    }


@pytest.mark.parametrize("name", list(_book_entries()))
def test_book_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _book_entries()[name]()


def test_book_wrappers_take_the_plain_version_for_cpu():
    mods = (cuda_gated, cuda_engine)
    before = [dict(m.LAUNCHES) for m in mods]
    for name in ("mc_paths_gated_corr_fused", "mc_paths_engine_corr_fused"):
        out = _book_entries()[name](device="cpu")
        assert out[0].n.shape == (3,) and out[1].n.dim() == 0
        assert float(out[1].sum_trades) == float(out[0].sum_trades.sum())
    assert [dict(m.LAUNCHES) for m in mods] == before
    _, _, skips, escal = _book_entries()["mc_paths_engine_corr_fused"](device="cpu")
    assert skips.dtype == torch.int64 and skips.shape == (3, 16) and escal.shape == (3,)


@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("bad", ["s0", "sigma", "beta", "weights", "paths", "odd_bars",
                                 "levels", "market", "external"])
def test_book_entries_reject_bad_inputs(engine, bad):
    lv, p = _levels(), _params(engine)
    n_many = 65 if engine else 9      # past the engine kernels' 64 slots, the gated's 8
    many = U.stack_levels([[{"color": "blue", "type": "solid", "index": i,
                             "price": 100.0 + i} for i in range(9)]] * 3, max_levels=n_many)
    lanes, w = 256, 8
    layout = (EngineLayout if engine else GatedLayout)(w)
    args = dict(levels=lv, s0=S0, sigma=SIGMAS, beta=BETAS, weights=WEIGHTS)
    kw = dict(paths_per_symbol=8 * lanes, num_bars=w, lanes=lanes, device="cpu")
    if bad in ("s0", "sigma", "beta", "weights"):
        args[bad] = args[bad][:2]
    elif bad == "paths":
        kw["paths_per_symbol"] = 8 * lanes + 256
    elif bad == "odd_bars":
        kw["num_bars"] = 9
    elif bad == "levels":
        args["levels"] = many
    elif bad == "market":      # external uniforms without the market's
        kw["external_uniforms"] = torch.zeros((3, 1, layout.u_rows, 8, lanes))
    else:                      # the market's without external uniforms
        kw["market_uniforms"] = torch.zeros((1, w, 8, lanes))
    entry = (cuda_engine.mc_paths_engine_corr_fused if engine
             else cuda_gated.mc_paths_gated_corr_fused)
    with pytest.raises(ValueError):
        entry(0, args["levels"], p, args["s0"], args["sigma"], args["beta"], args["weights"],
              **kw)


def test_book_entries_refuse_what_is_not_ported_yet():
    """The harvest and the exact tail are not ported yet; the samplers are
    (``tests/test_torch_book_samplers.py``): a Heston book runs."""
    lv, p = _levels(), _params(False)
    base = (0, lv, p, S0, SIGMAS, BETAS, WEIGHTS)
    kw = dict(paths_per_symbol=8 * 256, num_bars=8, lanes=256, device="cpu")
    pipe = dict(num_paths=256, num_bars=8, block_paths=256, device="cpu")
    for call in (lambda: cuda_engine.mc_paths_engine_corr_fused(*base, harvest=True, **kw),
                 lambda: P.portfolio_mc_engine(*base, harvest=True, **pipe),
                 lambda: P.exact_tail_book(*base, num_paths=256)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            call()
    sym, book = cuda_gated.mc_paths_gated_corr_fused(*base, sampler="heston", **kw)
    assert float(book.n) == 8 * 256 and bool((sym.n == 8 * 256).all())


def test_book_launchers_refuse_the_cpu():
    lv, p = _levels(), _params(False)
    kw = dict(paths_per_symbol=8 * 256, num_bars=8, lanes=256, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gated.gated_corr_rows(0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_engine.engine_corr_rows(0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, **kw)


@pytest.mark.parametrize("mod", [cuda_gated, cuda_engine])
def test_book_folds_stay_exact_int64_past_2_24(mod):
    """S + 1 segments (the symbols, then the book) of int64 partial rows."""
    big = torch.zeros((4, 8, mod.ROW_COUNTS), dtype=torch.int64)
    big[..., :6] = (1 << 26) + 5
    big[3] *= 3                                           # the book's trades
    c, f = mod.reduce_rows(big, torch.zeros((4, 8, mod.ROW_FLOATS)))
    assert c.shape == (4, mod.ROW_COUNTS) and c.dtype == torch.int64
    assert int(c[3, 5]) == 24 * ((1 << 26) + 5) > 1 << 24
    assert float(np.float32(int(c[3, 5]))) != int(c[3, 5])


def test_book_argument_arrays_equal_the_per_symbol_structs():
    """Every symbol's argument struct, packed at once on [S] columns, is byte
    for byte what the same packer gives for that symbol's row alone (levels,
    knobs, noise stds, derived constants, keys, offsets); the book's loading
    and weight go beside them as float32 pairs."""
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import (book_pairs,
                                                                       symbol_columns,
                                                                       symbol_rows)

    lv = _levels(SYM_ROWS[:2] + [[]])                     # a symbol without levels
    p = _params().replace(contact_prox=torch.tensor([0.05, 0.08, 0.03]),
                          w_rules=torch.tensor([0.5, 0.0, 0.3]),
                          w_ml=torch.tensor([0.5, 0.0, 0.6]),
                          cooldown_s=torch.tensor([0.0, 61.3, 120.0]),
                          veto_prox=torch.tensor([0.001, 0.02, 0.05]))
    cols = symbol_columns(lv, S0, SIGMAS, p, _noise(), beta=BETAS, weights=WEIGHTS)
    rows = symbol_rows(lv, S0, SIGMAS, p, _noise(), beta=BETAS, weights=WEIGHTS)
    lay_g, lay_e = GatedLayout(16, True), EngineLayout(16, True)
    gate = G.GateConfig.from_params(_params(False))
    kw = E.engine_knobs()
    one = dict(num_paths=2048, mu=0.0, dt=DT, lanes=256, antithetic=True)
    offsets = np.arange(3) * 2048
    arr_g = cuda_gated._gated_args(7, lv, p, gate, _noise(), lay_g, n=3, s0=cols["s0"],
                                   sigma=cols["sigma"], symbols=range(3),
                                   ext_offset=offsets * lay_g.u_rows, **one)
    arr_e = cuda_engine._pack_args(7, lv, p, kw, lay_e, n=3, s0=cols["s0"],
                                   sigma=cols["sigma"], noise=_noise(), volume_model=None,
                                   symbols=range(3), ext_offset=offsets * lay_e.u_rows, **one)
    assert torch.equal(book_pairs(cols, torch.device("cpu")),
                       torch.from_numpy(np.stack([BETAS, WEIGHTS], axis=1)))
    for s, (lv_s, s0_s, sg_s, p_s, nz, _, _) in enumerate(rows):
        mine = dict(n=1, s0=s0_s, sigma=sg_s, symbols=[s], **one)
        a = cuda_gated._gated_args(7, lv_s, p_s, gate, nz, lay_g,
                                   ext_offset=offsets[s] * lay_g.u_rows, **mine)
        e = cuda_engine._pack_args(7, lv_s, p_s, kw, lay_e, noise=nz, volume_model=None,
                                   ext_offset=offsets[s] * lay_e.u_rows, **mine)
        assert a.tobytes() == arr_g[s:s + 1].tobytes(), s
        assert e.tobytes() == arr_e[s:s + 1].tobytes(), s


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

BOOK_KEYS = ["symbol", "beta", "weight", "hit_rate", "mean_r", "mean_trades", "max_dd"]
PORT_KEYS = ["portfolio", "mean_r", "std_r", "var_05", "cvar_05", "max_dd", "mean_dd"]


def _cli(tmp_path, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--db", str(tmp_path / "t.db"), "book", *argv])
    return rc, [json.loads(x) for x in buf.getvalue().strip().splitlines()]


@pytest.mark.parametrize("engine", [False, True])
def test_cli_book_rows_have_the_jax_keys(tmp_path, engine):
    rc, rows = _cli(tmp_path, *(["--engine"] if engine else []), "--device", "cpu",
                    "--backend", "torch", "--num-symbols", "3", "--num-paths", "1024",
                    "--num-bars", "16", "--betas", "0.2,0.5,0.8", "--weights", "0.5,0.3,0.2")
    assert rc == 0 and len(rows) == 4
    for s, row in enumerate(rows[:3]):
        assert list(row) == BOOK_KEYS + (["escalations"] if engine else [])
        assert row["symbol"] == s and 0.0 < row["hit_rate"] < 1.0
    assert [r["beta"] for r in rows[:3]] == [0.2, 0.5, 0.8]
    assert list(rows[3]) == PORT_KEYS and rows[3]["portfolio"] is True
    assert rows[3]["var_05"] <= rows[3]["mean_r"] and rows[3]["max_dd"] >= rows[3]["mean_dd"]


@pytest.mark.parametrize("flag", [["--harvest"], ["--exact-tail"], ["--sampler", "heston"],
                                  ["--bars-csv", "x.csv"], ["--block-len", "5"],
                                  ["--heston-xi", "0.5"]])
def test_cli_book_unported_flags_exit(tmp_path, flag):
    """``--harvest`` and ``--exact-tail`` exit ("not ported yet"); the
    sampler options run since the books took the samplers: ``--sampler
    heston`` changes the rows, and ``--bars-csv``, ``--block-len`` and the
    ``--heston-*`` values alone leave the gbm book as it is (as in the JAX
    CLI, the gbm sampler reads none of them; no file is opened)."""
    small = ["--device", "cpu", "--backend", "torch", "--num-symbols", "2", "--num-paths",
             "512", "--num-bars", "8"]
    if flag[0] in ("--harvest", "--exact-tail"):
        with pytest.raises(SystemExit, match="not ported yet"):
            _cli(tmp_path, *small, *flag)
        return
    rc, gbm = _cli(tmp_path, *small)
    rc2, rows = _cli(tmp_path, *small, *flag)
    assert rc == rc2 == 0 and [list(r) for r in rows] == [list(r) for r in gbm]
    assert (rows != gbm) == (flag[0] == "--sampler")


def test_cli_book_backend_rules(tmp_path):
    with pytest.raises(SystemExit, match="--device cuda"):
        _cli(tmp_path, "--device", "cpu", "--backend", "cuda")
    with pytest.raises(SystemExit, match="expected 3"):
        _cli(tmp_path, "--device", "cpu", "--num-symbols", "3", "--betas", "0.1,0.2")
    # auto on the CPU takes the pipeline, never the card
    rc, rows = _cli(tmp_path, "--device", "cpu", "--num-symbols", "2", "--num-paths", "512",
                    "--num-bars", "8")
    assert rc == 0 and len(rows) == 3


# ---------------------------------------------------------------------------
# the fits' devices
# ---------------------------------------------------------------------------

def _fits():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16, 3))
    y = (rng.uniform(size=16) < 0.5).astype(np.int32)
    return {"fit": lambda **k: L.fit(x, y, **k),
            "fit_batched": lambda **k: L.fit_batched(x[None], y[None], **k),
            "fit_sgd": lambda **k: L.fit_sgd(x.astype(np.float32), y, epochs=1, **k)}


@pytest.mark.parametrize("name", list(_fits()))
def test_fits_put_every_field_on_the_asked_device(name):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _fits()[name]()
    model = _fits()[name](device="cpu")
    assert {v.device.type for v in model} == {"cpu"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _differ(got, want) -> tuple[int, int]:
    """(paths whose trades differ, engine paths that differ in their
    first-fail reasons alone), as ``chip_smoke.py`` counts them."""
    ints = [1, 2, 3, 4] + ([6] if got.shape[1] > 6 else [])
    err = (got[:, [0, 5]] - want[:, [0, 5]]).abs().amax(dim=1)
    trades = ((got[:, ints] != want[:, ints]).any(dim=1)
              | (err > 1e-3 * torch.clamp(want[:, 1], min=1.0)))
    reasons = (got[:, 7:] != want[:, 7:]).any(dim=1) & ~trades
    return int(trades.sum()), int(reasons.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [False, True])
def test_cuda_books_match_their_plain_versions(engine):
    """Injected uniforms, [S] knobs and noise stds, antithetic: each symbol
    and the book within the flip budget path by path; Philox: the plain
    version on the card agrees with the kernel on every path, the book's
    rows included (counts exact, float sums to float32 partial sums), and
    the gated book's on a horizon whose curves take a device-memory buffer."""
    _need_cuda()
    dev = torch.device("cuda")
    lv, p, w = _levels(), _params(engine), 40
    lanes = 256 if engine else 1024
    layout = (EngineLayout if engine else GatedLayout)(w, True)
    n = 4 * 8 * lanes
    rows = cuda_engine.engine_corr_rows if engine else cuda_gated.gated_corr_rows
    ref = (cuda_engine.engine_corr_totals_reference if engine
           else cuda_gated.gated_corr_totals_reference)
    kw = dict(paths_per_symbol=n, num_bars=w, dt=DT, lanes=lanes, noise=_noise(),
              antithetic=True, per_path=True)
    u = _uniforms(51, (3, 4, layout.u_rows, 8, lanes))
    um = _uniforms(52, (4, w, 8, lanes))
    want = ref(0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, external_uniforms=u, market_uniforms=um,
               **kw)
    got = rows(0, lv, p, S0, SIGMAS, BETAS, WEIGHTS, external_uniforms=u.to(dev),
               market_uniforms=um.to(dev), device=dev, **kw)
    for s in range(4):
        trades, reasons = _differ(got[2][s].cpu(), want[2][s])
        assert trades <= 2 + n // 1024 and reasons <= 2 + n // 1024, (s, trades, reasons)
    kw.update(paths_per_symbol=1 << 16, antithetic=False)
    want = ref(3, lv, p, S0, SIGMAS, BETAS, WEIGHTS, device=dev, chunk_blocks=64, **kw)
    got = rows(3, lv, p, S0, SIGMAS, BETAS, WEIGHTS, device=dev, **kw)
    for s in range(4):
        assert _differ(got[2][s].cpu(), want[2][s].cpu()) == (0, 0), s
    mod = cuda_engine if engine else cuda_gated
    c, f = mod.reduce_rows(got[0], got[1])
    assert torch.equal(c, want[0])
    np.testing.assert_allclose(f.cpu().numpy(), want[1].cpu().numpy(), rtol=1e-5, atol=1e-3)
    if not engine:   # a horizon whose curves pass the shared budget: a device buffer
        kw.update(paths_per_symbol=1 << 13,
                  num_bars=cuda_gated.MAX_CURVE_SHARED_BYTES // (256 * 4) + 2)
        want = ref(4, lv, p, S0, SIGMAS, BETAS, WEIGHTS, device=dev, **kw)
        got = rows(4, lv, p, S0, SIGMAS, BETAS, WEIGHTS, device=dev, **kw)
        for s in range(4):
            assert _differ(got[2][s].cpu(), want[2][s].cpu()) == (0, 0), s


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [False, True])
def test_cuda_books_at_beta_0_are_the_universe_kernels(engine):
    _need_cuda()
    dev = torch.device("cuda")
    lv, p = _levels(), _params(engine)
    kw = dict(paths_per_symbol=1 << 16, num_bars=40, dt=DT, noise=_noise(), per_path=True,
              external_uniforms=None, device=dev, lanes=256 if engine else 1024)
    if engine:
        a = cuda_engine.engine_corr_rows(5, lv, p, S0, SIGMAS, 0.0, WEIGHTS, **kw)
        b = cuda_engine.engine_universe_rows(5, lv, p, S0, SIGMAS, **kw)
    else:
        a = cuda_gated.gated_corr_rows(5, lv, p, S0, SIGMAS, 0.0, WEIGHTS, **kw)
        b = cuda_gated.gated_universe_rows(5, lv, p, S0, SIGMAS, **kw)
    assert all(torch.equal(x[:3], y) for x, y in zip(a, b))
    one = (cuda_engine.mc_paths_engine_corr_fused if engine
           else cuda_gated.mc_paths_gated_corr_fused)(
        5, _levels(SYM_ROWS[:1]), EngineParams.default(), [100.0], [0.3], [0.5], [1.0],
        paths_per_symbol=1 << 16, num_bars=40, device=dev)
    assert _same_stats(one[0].row(0), one[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_fits()))
def test_cuda_fits_put_every_field_on_the_card(name):
    _need_cuda()
    model = _fits()[name]()
    assert {v.device.type for v in model} == {"cuda"}
