"""First contact past 128 bars (kernels #1, #2, #3 and their samplers at any
even W, as the JAX kernels take it, ``pallas_mc.py:724-738``).

On the CPU: the plain versions (single, sweep, universe; gbm with noise and
antithetic lanes, bootstrap, Heston) against the JAX kernels in interpret
mode on the same injected uniforms at W = 130 and 200 (Heston's, whose
interpret-mode build takes ~40 s, in ``test_torch_first_contact_long_heston.py``,
so that the test workers share them); the CLI's
``--backend auto`` choosing the kernel at ``paths --num-bars 390`` on a
(reported) CUDA device; the wrappers' checks taking W > 128.  Marked
``cuda`` (skipped without a card): the gbm kernels past 128 bars
(``mc_universe_kernel`` keeps up to 24 sine halves a thread and the sweep
64, and they draw the pairs past them again, counted with ``_long``) against their plain
versions at W = 390, and, forced to keep no sine half (``_FORCE_LONG``:
``cap = 0``) where every one fits (W = 40, 128), equal to the launches
keeping them bit for bit.  JAX is imported inside the interpret-mode tests
only.

Tolerance: the JAX kernels take the log-price cumsum as a triangular matmul
and the port a serial float32 sum, which flips O(1) outcomes per 1024 paths
a 40 bars (``tests/test_pallas_mc.py:133-146``): counts within F = 2 +
paths / 1024 x ceil(W / 40), the histogram within 2F."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GbmLayout
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_sampler_kernels import HIST, TABLES

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}]
SYM_ROWS = [ROWS, [{"color": "green", "type": "solid", "index": 0, "price": 100.2},
                   {"color": "teal", "type": "solid", "index": 0, "price": 99.8}]]
LANES = 1024
SIGMA = 0.3
BLOCK_LEN = 5
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
STOPS, TPS = [0.25, 0.45], [0.35, 0.15]


def _uniforms(seed, shape):
    return np.random.default_rng(seed).uniform(1e-9, 1.0, shape).astype(np.float32)


def _flips(n, w):
    return 2 + n // 1024 * math.ceil(w / 40)


def _assert_close(t, j, n, w):
    """One row: n exact, the counts within F, the histogram within 2F."""
    f = _flips(n, w)
    assert float(t.n) == float(np.asarray(j.n)) == n
    for fld in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(t, fld)) - float(np.asarray(getattr(j, fld)))) <= f, fld
    assert float(np.abs(t.hist.cpu().numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    assert float(t.n_entered) > 0


def _skw(sampler):
    return {} if sampler == "gbm" else dict(sampler=sampler, block_len=BLOCK_LEN)


# (sampler, W, noise, antithetic)
SINGLE = {"gbm-130-noise-anti": ("gbm", 130, True, True),
          "gbm-200": ("gbm", 200, False, False),
          "bootstrap-130-noise": ("bootstrap", 130, True, False)}


def jax_single(sampler, w, noisy, anti, lanes, seed):
    """(the JAX single kernel in interpret mode, the port's plain version) on
    the same injected uniforms; ``HIST``'s tables for the bootstrap."""
    from jax.experimental.pallas import tpu as pltpu

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
    from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels

    u = _uniforms(seed, (1, GbmLayout(w, noisy, sampler).n_rows, lanes))
    hist = {} if sampler != "bootstrap" else dict(hist_bars=jPG.PathBars(*HIST))
    j = mc_paths_pallas(
        0, JLevels.from_rows(ROWS, max_levels=8), JParams.default(), num_paths=lanes,
        num_bars=w, sigma=SIGMA, lanes=lanes, noise=JMcNoise.make(**STDS) if noisy else None,
        antithetic=anti, interpret=pltpu.InterpretParams(), external_uniforms=u,
        **hist, **_skw(sampler))
    t = cuda_mc.mc_paths_fused(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), num_paths=lanes,
        num_bars=w, sigma=SIGMA, lanes=lanes, noise=McNoise.make(**STDS) if noisy else None,
        antithetic=anti, external_uniforms=torch.from_numpy(u),
        **({} if sampler != "bootstrap" else dict(tables=TABLES)), **_skw(sampler))
    return j, t


@pytest.mark.parametrize("case", list(SINGLE))
def test_plain_first_contact_matches_the_jax_kernel_interpret_past_128_bars(case):
    """#1 (Heston: ``test_torch_first_contact_long_heston.py``)."""
    sampler, w, noisy, anti = SINGLE[case]
    j, t = jax_single(sampler, w, noisy, anti, LANES, w + len(case))
    _assert_close(t, j, LANES, w)


def test_plain_first_contact_sweep_matches_the_jax_kernel_interpret_past_128_bars():
    """#3 at W = 130: the JAX sweep kernel draws its own uniforms and its row
    g equals the JAX single kernel at (stop_g, tp_g) (pallas_mc.py:2008-2012),
    so each row of the plain sweep is held against that kernel."""
    from jax.experimental.pallas import tpu as pltpu

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas
    from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels

    w = 130
    u = _uniforms(11, (1, GbmLayout(w).n_rows, LANES))
    t = cuda_mc.mc_paths_sweep_fused(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), STOPS, TPS,
        num_paths=LANES, num_bars=w, sigma=SIGMA, lanes=LANES,
        external_uniforms=torch.from_numpy(u))
    for g, (sp, tp) in enumerate(zip(STOPS, TPS)):
        j = mc_paths_pallas(
            0, JLevels.from_rows(ROWS, max_levels=8),
            JParams.default().replace(stop_padding=sp, tp_padding=tp), num_paths=LANES,
            num_bars=w, sigma=SIGMA, lanes=LANES, interpret=pltpu.InterpretParams(),
            external_uniforms=u)
        _assert_close(t.row(g), j, LANES, w)


def test_plain_first_contact_universe_matches_the_jax_kernel_interpret_past_128_bars():
    """#2 at W = 200: two symbols, each on its own levels, s0 and sigma."""
    import jax

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops import pallas_mc as jPM
    from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU

    w, lanes = 200, jPM.LANES
    s0, sigma = [100.0, 100.2], [0.3, 0.25]
    u = _uniforms(12, (2, 1, GbmLayout(w).n_rows, lanes))
    j = jPM.mc_paths_pallas_universe(
        0, jU.stack_levels(SYM_ROWS, max_levels=8), JParams.default(), np.float32(s0),
        np.float32(sigma), paths_per_symbol=lanes, num_bars=w, interpret=True,
        external_uniforms=u)
    t = cuda_mc.mc_paths_universe_fused(
        0, U.stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), s0, sigma,
        paths_per_symbol=lanes, num_bars=w, lanes=lanes, external_uniforms=torch.from_numpy(u))
    for i in range(2):
        _assert_close(t.row(i), jax.tree_util.tree_map(lambda x: x[i], j), lanes, w)


def test_auto_backend_takes_the_kernel_at_390_bars(monkeypatch):
    """`paths --num-bars 390` (the desk's day) on a CUDA device: ``_fits``
    has no need and ``--backend auto`` takes the kernel, for the samplers
    too; the sweep likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    rows = [{"price": 100.0}] * 3
    for argv in (["paths", "--num-bars", "390"],
                 ["paths", "--num-bars", "390", "--sampler", "heston"],
                 ["paths", "--num-bars", "391", "--sampler", "bootstrap"],
                 ["sweep", "--num-bars", "390"]):
        args = cli.build_parser().parse_args(argv + ["--num-paths", "16384"])
        assert cli._fits(args, rows) is None, argv
        assert cli._backend(args, rows) == "cuda", argv


def _define(source: str, name: str) -> int:
    """An integer ``#define`` of a kernel source."""
    text = (Path(cuda_mc.__file__).parent / "csrc" / source).read_text()
    return int(re.search(rf"^#define {name} (\d+)\b", text, re.M).group(1))


class _PlanLibs:
    """Stand-in kernel libraries whose launch plans keep the sine halves of
    their sources' caps (``qmmx_mc_universe_plan``: FC_MAX_CAP,
    ``qmmx_fc_sweep_plan``: FC_SWEEP_MAX_CAP), none when ``keep`` is 0."""

    caps = {"qmmx_mc_universe_plan": _define("mc_first_contact.cu", "FC_MAX_CAP"),
            "qmmx_fc_sweep_plan": _define("mc_first_contact_sweep.cu", "FC_SWEEP_MAX_CAP")}

    def __getattr__(self, name):
        def plan(w, keep, out):
            out._obj[0] = min(w // 2, self.caps[name]) if keep else 0
            return 0
        return plan


@pytest.mark.parametrize("w,want", [(40, False), (128, False), (130, True), (390, True)])
def test_wrapper_checks_take_any_even_w(w, want, monkeypatch):
    """The launch arguments pack at any W (no horizon cap); by the launches'
    plans (``sweep_plan``, ``universe_plan``, on stand-in libraries with the
    sources' caps) the gbm sweep draws pairs again for their sine halves
    past 128 bars (``want``), the single run and the universe past 48, and
    all of them under the checks' hook (their launches counted with
    ``_long`` there)."""
    layout = GbmLayout(w)
    ok = cuda_mc._check(0, Levels.from_rows(ROWS, max_levels=8), num_paths=LANES,
                        num_bars=w, lanes=LANES, noise=None, antithetic=False,
                        external_uniforms=None)
    assert ok.n_rows == layout.n_rows
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        cuda_mc._launch_args(0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(),
                             layout, num_paths=LANES, num_bars=w, s0=100.0, mu=0.0,
                             sigma=SIGMA, dt=1.0 / (390.0 * 252.0), lanes=LANES, noise=None,
                             antithetic=False, external_uniforms=None,
                             device=torch.device("cpu"), what="test")
    libs = _PlanLibs()
    monkeypatch.setattr(cuda_mc, "_library", lambda: libs)
    monkeypatch.setattr(cuda_mc, "_sweep_library", lambda: libs)
    assert (2 * cuda_mc.sweep_plan(w)[0] != w) == want
    assert (2 * cuda_mc.universe_plan(w)[0] != w) == (w > 48)
    monkeypatch.setattr(cuda_mc, "_FORCE_LONG", True)
    assert cuda_mc.sweep_plan(w)[0] == cuda_mc.universe_plan(w)[0] == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["gbm", "bootstrap", "heston"])
def test_cuda_long_first_contact_matches_plain_at_390_bars(sampler):
    """W = 390, injected uniforms: the single, sweep and universe launches
    against their plain versions on CPU copies within F; gbm with noise and
    antithetic lanes; the launches counted under their ``_long`` names
    (gbm) or the sampler kernels'."""
    dev = _cuda()
    w, lanes, nb = 390, 8192, 2
    levels = Levels.from_rows(ROWS, max_levels=8)
    gbm = sampler == "gbm"
    skw = {} if gbm else dict(sampler=sampler, block_len=BLOCK_LEN, tables=TABLES)
    u = torch.from_numpy(_uniforms(390, (nb, GbmLayout(w, gbm, sampler).n_rows, lanes)))
    kw = dict(num_paths=nb * lanes, num_bars=w, sigma=SIGMA, lanes=lanes,
              noise=McNoise.make(**STDS) if gbm else None, antithetic=gbm, **skw)
    before = dict(cuda_mc.LAUNCHES)
    want = cuda_mc.mc_paths_fused(0, levels, EngineParams.default(), external_uniforms=u, **kw)
    got = cuda_mc.mc_paths_fused(0, levels, EngineParams.default(),
                                 external_uniforms=u.to(dev), **kw)
    torch.cuda.synchronize()
    name = "mc_first_contact_long" if gbm else "mc_first_contact_sampler"
    assert cuda_mc.LAUNCHES[name] == before[name] + 1
    _assert_close(got, want, nb * lanes, w)
    us = torch.from_numpy(_uniforms(392, (1, GbmLayout(w, False, sampler).n_rows, lanes)))
    kw1 = dict(num_paths=lanes, num_bars=w, sigma=SIGMA, lanes=lanes, **skw)
    want = cuda_mc.mc_paths_sweep_fused(0, levels, EngineParams.default(), STOPS, TPS,
                                        external_uniforms=us, **kw1)
    got = cuda_mc.mc_paths_sweep_fused(0, levels, EngineParams.default(), STOPS, TPS,
                                       external_uniforms=us.to(dev), **kw1)
    for g in range(2):
        _assert_close(got.row(g), want.row(g), lanes, w)
    if gbm:
        s0, sigma = [100.0, 100.2], [0.3, 0.25]
        uu = torch.from_numpy(_uniforms(391, (2, 1, GbmLayout(w).n_rows, lanes)))
        ukw = dict(paths_per_symbol=lanes, num_bars=w, lanes=lanes)
        lv = U.stack_levels(SYM_ROWS, max_levels=8)
        want = cuda_mc.mc_paths_universe_fused(0, lv, EngineParams.default(), s0, sigma,
                                               external_uniforms=uu, **ukw)
        got = cuda_mc.mc_paths_universe_fused(0, lv, EngineParams.default(), s0, sigma,
                                              external_uniforms=uu.to(dev), **ukw)
        assert cuda_mc.LAUNCHES["mc_universe_long"] == before["mc_universe_long"] + 1
        for i in range(2):
            _assert_close(got.row(i), want.row(i), lanes, w)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [40, 128])
def test_cuda_long_first_contact_equals_the_register_kernels_where_both_fit(w, monkeypatch):
    """Forced (``_FORCE_LONG``), the gbm kernels keep no sine half (``cap =
    0``) and give the partial rows of the launches keeping every one bit for
    bit: the single run with noise and antithetic lanes (Philox), the sweep
    and the universe, counted with ``_long``."""
    dev = _cuda()
    levels = Levels.from_rows(ROWS, max_levels=8)
    p = EngineParams.default()
    kw = dict(num_paths=1 << 18, num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA,
              dt=1.0 / (390.0 * 252.0), lanes=8192, external_uniforms=None, device=dev)
    lv = U.stack_levels(SYM_ROWS, max_levels=8)

    def launches():
        return (cuda_mc.first_contact_rows(3, levels, p, noise=McNoise.make(**STDS),
                                           antithetic=True, **kw),
                cuda_mc.sweep_rows(3, levels, p, STOPS, TPS, **kw),
                cuda_mc.universe_rows(3, lv, p, [100.0, 100.2], [0.3, 0.25],
                                      paths_per_symbol=1 << 18, num_bars=w,
                                      dt=1.0 / (390.0 * 252.0), lanes=8192,
                                      external_uniforms=None, device=dev))

    reg = launches()
    before = dict(cuda_mc.LAUNCHES)
    monkeypatch.setattr(cuda_mc, "_FORCE_LONG", True)
    long_ = launches()
    for name in ("mc_first_contact_long", "mc_sweep_long", "mc_universe_long"):
        assert cuda_mc.LAUNCHES[name] == before[name] + 1, name
    for a, b in zip(reg, long_):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
