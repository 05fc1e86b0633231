"""The two kernels redesigned on the gbm sweep's pattern: first contact's
``mc_universe_kernel`` (``ops/csrc/mc_first_contact.cu``: kernel #1 at one
symbol, #2) and the gated sweep's gbm launch, the gbm kind of
``mc_gated_sampler_sweep_kernel`` (``ops/csrc/mc_gated_sampler_sweep.cu``, #6).

On the CPU: the first-contact kernel's shared memory (its arguments and
``cap`` sine halves a thread) fits an SM at its ``__launch_bounds__`` at
every even W up to 4096, and the gated kernel's shared memory, bar store and
float-sum scratch at W = 40 and 390, each from the constants of the kernel's
source; the launch wrappers send the checks' hook (``_FORCE_LONG``) to the
kernel's ``cap = 0`` and count each launch under its name, and the gated
sweep's gbm launch to the bar-store kernel, with stand-in libraries; the
plain single and universe versions against the JAX kernels in interpret
mode at W = 40 and 130 on the same injected uniforms (tolerance: the JAX
kernels take the log-price cumsum as a triangular matmul and the port a
serial float32 sum, which flips O(1) outcomes per 1024 paths a 40 bars,
``tests/test_pallas_mc.py:133-146``: counts within F = 2 + paths / 1024 x
ceil(W / 40), the histogram within 2F).

Marked ``cuda`` (skipped without a card): the first-contact kernel's
partial rows at W = 2, 40, 128, 130 and 390 (one symbol with noise and
antithetic lanes, and 3 symbols; injected uniforms and Philox;
``chip_smoke.fc_rows_cases``), keeping every sine half it can and none,
bit for bit the digests of the kernel it replaced (the single configuration
as a universe's symbol, the sine halves in an unrolled register array up to
W = 128 and each pair drawn again past it), recorded on an H100 with
``chip_smoke.py --fc-rows-digests``; each of 18 gbm gated sweep rows with
[G] noise stds equal to its one-row ``mc_gated_sweep_kernel`` launch bit for
bit, partial rows and per-path rows, at W = 40 and 390, one and two passes
of rows; the launches' own plans against the models here.  JAX is imported
inside the interpret-mode tests only."""

import ctypes
import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout, GbmLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import BLOCK, grid_row, grid_size
from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import make_sampler
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}]
SYM_ROWS = [ROWS, [{"color": "green", "type": "solid", "index": 0, "price": 100.2},
                   {"color": "teal", "type": "solid", "index": 0, "price": 99.8}]]
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
SM_SHARED = 228 * 1024          # an H100 SM's shared memory
CTA_SHARED = 227 * 1024         # a CTA's, at most
CTA_RESERVED = 1024             # the runtime's reserve a CTA
DEFAULT_SHARED = 48 * 1024      # a CTA's without the dynamic shared memory opt-in
H100_SMS = 132
CSRC = Path(cuda_mc.__file__).parent / "csrc"


def _defines(source: str) -> dict:
    """The integer ``#define``s of a kernel source."""
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


FC = _defines("mc_first_contact.cu")
# mc_universe_kernel's static shared memory: the McArgs, the row's counts and
# warp sums, and 16 bytes for their alignment (at most what the compiler lays out)
FC_STATIC = (ctypes.sizeof(cuda_mc._McArgs)
             + 4 * (cuda_mc.ROW_COUNTS + cuda_mc.ROW_FLOATS * BLOCK // 32) + 16)


def _fc_plan(w: int, keep: bool = True) -> tuple:
    """The single / universe launch's plan at W, as the source's constants
    give it: (sine halves kept, CTAs an SM, static bytes at most, dynamic
    bytes)."""
    cap = min(w // 2, FC["FC_MAX_CAP"]) if keep else 0
    return cap, FC["FC_MIN_BLOCKS"], FC_STATIC, 4 * cap * BLOCK


def test_first_contact_shared_memory_fits_at_every_even_w():
    """Every even W up to 4096, the sine halves kept or not: a CTA's static
    and dynamic shared memory within the 48 KB it gets without opting in,
    and its ``__launch_bounds__`` CTAs an SM within 228 KB (1 KB reserved a
    CTA), with room to spare for L1; the halves all kept up to W = 48 (the
    launches counted under the kernel's name), FC_MAX_CAP past it (counted
    with ``_long``, as the launch reads its plan)."""
    assert FC["FC_MAX_CAP"] * 2 == 48
    for w in range(2, 4097, 2):
        for keep in (True, False):
            cap, blocks, static, dyn = _fc_plan(w, keep)
            assert static + dyn <= DEFAULT_SHARED, (w, keep)
            assert blocks * (static + dyn + CTA_RESERVED) <= SM_SHARED // 2, (w, keep)
        assert (2 * _fc_plan(w)[0] == w) == (w <= 48), w
    # the shapes timed: W 40 (20 KB of halves) and 390 (24 KB)
    assert [_fc_plan(w)[:2] for w in (40, 390)] == [(20, 4), (24, 4)]


GATED = _defines("mc_gated_sampler_sweep.cu")
GBM_PLANES = GATED["BAR_PLANES"]         # close, high, low: the samplers' store
# the gbm kind's static shared memory: two GatedArgs (the bars' and the
# replayed row's), a pass's rows' 64-bit counts and histograms and the warp
# sums (GbmPass), and 16 bytes for their alignment
GBM_STATIC = (2 * ctypes.sizeof(cuda_gated._GatedArgs)
              + GATED["GATED_GBM_ROWS"] * (8 * cuda_gated.N_COUNTS + 4 * cuda_gated.HIST_BINS)
              + 4 * cuda_gated.ROW_FLOATS * BLOCK // 32 + 16)


def _gbm_plan(w: int, n_rows: int, vgrid: int, sms: int = H100_SMS) -> tuple:
    """The gbm gated sweep's plan, as the source's constants give it on a
    card of ``sms`` SMs at its ``__launch_bounds__`` CTAs an SM: (CTAs, store
    floats, scratch floats, rows a pass, planes)."""
    rows = min(n_rows, GATED["GATED_GBM_ROWS"])
    store, scratch = GBM_PLANES * w * BLOCK, rows * GATED["GATED_GBM_ACC"] * BLOCK
    budget = (GATED["GATED_GBM_STORE_MIB"] << 20) // (4 * (store + scratch))
    ctas = min(GATED["GATED_SWEEP_MIN_BLOCKS"] * sms, vgrid, budget)
    return ctas, ctas * store, ctas * scratch, rows, GBM_PLANES


@pytest.mark.parametrize("num_bars", [40, 390])
def test_gated_gbm_sweep_shared_memory_store_and_scratch_fit(num_bars):
    """No dynamic shared memory: the static (two GatedArgs, 32 rows' counts
    and histograms, the warp sums) fits the kernel's CTAs an SM within the
    48 KB a CTA gets without opting in; at the CLI's 18 rows and 2^26 paths
    (4096 virtual CTAs) the resident CTAs' store and float-sum scratch stay
    within the library's budget, so every resident CTA runs: at W = 40 the
    store is 31 MiB (three planes: close, high, low) and the scratch 28 MiB,
    at W = 390 the store 302 MiB; the budget binds only past W = 10,000."""
    assert GBM_STATIC <= DEFAULT_SHARED
    assert GATED["GATED_SWEEP_MIN_BLOCKS"] * (GBM_STATIC + CTA_RESERVED) <= SM_SHARED
    ctas, store, scratch, rows, planes = _gbm_plan(num_bars, 18, grid_size(1 << 26))
    assert ctas == GATED["GATED_SWEEP_MIN_BLOCKS"] * H100_SMS and rows == 18
    assert 4 * store == ctas * planes * num_bars * BLOCK * 4
    assert 4 * scratch == ctas * 18 * 6 * BLOCK * 4
    assert 4 * (store + scratch) <= GATED["GATED_GBM_STORE_MIB"] << 20
    assert planes == cuda_gated.BAR_PLANES == 3
    assert (4 * store) / 2 ** 20 <= (31.0 if num_bars == 40 else 302.0)
    assert (4 * scratch) / 2 ** 20 <= 28.0
    assert _gbm_plan(10_000, 18, 4096)[0] == ctas
    assert _gbm_plan(20_000, 18, 4096)[0] < ctas


class _FakeLib:
    """A stand-in for a kernel library: records each call by name and
    returns 0 (CUDA success); ``plans`` fills the plans' out arrays."""

    def __init__(self, **plans):
        self.calls, self.plans = [], plans

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name in self.plans:
                out = args[-1]._obj
                for i, v in enumerate(self.plans[name]):
                    out[i] = v
            return 0
        return call


@pytest.mark.parametrize("what", ["mc_first_contact", "mc_universe"])
@pytest.mark.parametrize("w,forced", [(40, False), (40, True), (128, False), (390, False),
                                      (390, True)])
def test_long_and_force_long_route_to_the_kernels_cap(w, forced, what, monkeypatch):
    """Every gbm single and universe launch goes to ``qmmx_mc_universe``:
    keeping the sine halves it can (``keep`` 1) unless the checks' hook
    ``_FORCE_LONG`` asks for ``cap = 0`` (``keep`` 0); counted under the
    kernel's name where its plan (``qmmx_mc_universe_plan``, stand-in: the
    model above) keeps every half, with ``_long`` past 48 bars or under the
    hook."""
    lib = _FakeLib(qmmx_mc_universe_plan=_fc_plan(w, not forced))
    monkeypatch.setattr(cuda_mc, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: SimpleNamespace(
        cuda_stream=0))
    monkeypatch.setattr(cuda_mc, "_FORCE_LONG", forced)
    before = dict(cuda_mc.LAUNCHES)
    n = 3 if what == "mc_universe" else 1
    pc, pf = cuda_mc._launch((cuda_mc._McArgs * n)(), w, num_paths=1 << 12, ext_ptr=None,
                             device=torch.device("cpu"), what=what)
    assert [c[0] for c in lib.calls] == ["qmmx_mc_universe_plan", "qmmx_mc_universe"]
    assert lib.calls[0][1][:2] == (w, 0 if forced else 1)
    args = lib.calls[1][1]
    assert (args[1], args[2], args[3]) == (n, w, 0 if forced else 1)
    assert tuple(pc.shape) == (n, grid_size(1 << 12), cuda_mc.ROW_COUNTS)
    name = what + ("_long" if forced or w > 2 * FC["FC_MAX_CAP"] else "")
    assert cuda_mc.LAUNCHES[name] == before[name] + 1
    assert sum(cuda_mc.LAUNCHES.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("per_path", [False, True])
def test_gated_gbm_sweep_goes_to_the_bar_store_kernel(per_path, monkeypatch):
    """The gated sweep's gbm launch: the library's plan sizes the store and
    the scratch, one ``qmmx_mc_gated_gbm_sweep`` call takes every row,
    counted as ``mc_gated_sweep``; rows that do not share the bars are
    refused."""
    n, w, paths = 18, 40, 1 << 16
    plan = (264, 264 * 3 * w * BLOCK, 264 * n * 6 * BLOCK, n, 3)
    lib = _FakeLib(qmmx_gated_gbm_sweep_plan=plan)
    monkeypatch.setattr(cuda_gated, "_sampler_sweep_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: SimpleNamespace(
        cuda_stream=0))
    params = EngineParams.default()
    layout = GatedLayout(w, False)
    args = cuda_gated._gated_args(
        0, Levels.from_rows(ROWS, max_levels=8), params, GateConfig.from_params(params), None,
        layout, n=n, num_paths=paths, s0=100.0, sigma=SIGMA, mu=0.0, dt=DT, lanes=1024,
        antithetic=False, symbols=[0] * n)
    before = dict(cuda_gated.LAUNCHES)
    out = cuda_gated._bar_sweep_launch(args, make_sampler("gbm"), 8, num_paths=paths,
                                       ext_ptr=None, device=torch.device("cpu"),
                                       per_path=per_path, what="mc_gated_sweep")
    assert [c[0] for c in lib.calls] == ["qmmx_gated_gbm_sweep_plan", "qmmx_mc_gated_gbm_sweep"]
    assert lib.calls[0][1][:3] == (w, n, grid_size(paths))
    call = lib.calls[1][1]
    assert (call[1], call[6], call[7]) == (n, 264, grid_size(paths))
    assert len(out) == (3 if per_path else 2)
    assert tuple(out[0].shape) == (n, grid_size(paths), cuda_gated.ROW_COUNTS)
    assert cuda_gated.LAUNCHES["mc_gated_sweep"] == before["mc_gated_sweep"] + 1
    args["log_s0"][3] += 1.0
    with pytest.raises(ValueError, match="share the bars"):
        cuda_gated._bar_sweep_launch(args, make_sampler("gbm"), 8, num_paths=paths,
                                     ext_ptr=None, device=torch.device("cpu"),
                                     per_path=per_path, what="mc_gated_sweep")


def test_sass_diff_matches_a_kernel_given_a_parameter():
    """``utils/sass_diff`` compares a kernel whose parameters changed (the
    sampler sweep kernels took ``scratch``) with its parent's by name and
    template arguments, and keeps kinds and non-template functions apart."""
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import sass_diff

    old = "_Z29mc_gated_sampler_sweep_kernelILi8ELi1EEvPK9GatedArgsiPK11SamplerArgsPKfPfiPxS8_S8_"
    new = "_Z29mc_gated_sampler_sweep_kernelILi8ELi1EEvPK9GatedArgsiPK11SamplerArgsPKfPfiPxS8_S8_S6_"
    assert sass_diff.key(old) == sass_diff.key(new) == "mc_gated_sampler_sweep_kernelILi8ELi1EE"
    assert sass_diff.key(old.replace("ELi1EE", "ELi3EE")) != sass_diff.key(old)
    assert sass_diff.key("_Z18mc_universe_kernelPK6McArgsiPKfPxPfi") == "mc_universe_kernel"
    assert sass_diff.key("qmmx_fold") == "qmmx_fold"


# ---- the plain versions against the JAX kernels in interpret mode

def _uniforms(seed, shape):
    return np.random.default_rng(seed).uniform(1e-9, 1.0, shape).astype(np.float32)


def _assert_close(t, j, n, w):
    """One row: n exact, the counts within F, the histogram within 2F."""
    f = 2 + n // 1024 * math.ceil(w / 40)
    assert float(t.n) == float(np.asarray(j.n)) == n
    for fld in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(t, fld)) - float(np.asarray(getattr(j, fld)))) <= f, fld
    assert float(np.abs(t.hist.cpu().numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    assert float(t.n_entered) > 0


@pytest.mark.parametrize("w", [40, 130])
def test_plain_first_contact_single_matches_the_jax_kernel_interpret(w):
    """#1 with noise and antithetic lanes, 1024 paths."""
    from jax.experimental.pallas import tpu as pltpu

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
    from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels

    lanes = 1024
    u = _uniforms(160 + w, (1, GbmLayout(w, True).n_rows, lanes))
    j = mc_paths_pallas(
        0, JLevels.from_rows(ROWS, max_levels=8), JParams.default(), num_paths=lanes,
        num_bars=w, sigma=SIGMA, lanes=lanes, noise=JMcNoise.make(**STDS), antithetic=True,
        interpret=pltpu.InterpretParams(), external_uniforms=u)
    t = cuda_mc.mc_paths_fused(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), num_paths=lanes,
        num_bars=w, sigma=SIGMA, lanes=lanes, noise=McNoise.make(**STDS), antithetic=True,
        external_uniforms=torch.from_numpy(u))
    _assert_close(t, j, lanes, w)


@pytest.mark.parametrize("w", [40, 130])
def test_plain_first_contact_universe_matches_the_jax_kernel_interpret(w):
    """#2: two symbols, each on its own levels, s0 and sigma."""
    import jax

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops import pallas_mc as jPM
    from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU

    lanes = jPM.LANES
    s0, sigma = [100.0, 100.2], [0.3, 0.25]
    u = _uniforms(260 + w, (2, 1, GbmLayout(w).n_rows, lanes))
    j = jPM.mc_paths_pallas_universe(
        0, jU.stack_levels(SYM_ROWS, max_levels=8), JParams.default(), np.float32(s0),
        np.float32(sigma), paths_per_symbol=lanes, num_bars=w, interpret=True,
        external_uniforms=u)
    t = cuda_mc.mc_paths_universe_fused(
        0, U.stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), s0, sigma,
        paths_per_symbol=lanes, num_bars=w, lanes=lanes, external_uniforms=torch.from_numpy(u))
    for i in range(2):
        _assert_close(t.row(i), jax.tree_util.tree_map(lambda x: x[i], j), lanes, w)


# ---- on the card

# ``chip_smoke.py --fc-rows-digests`` of the kernel mc_universe_kernel
# replaced (the tree before it), on an NVIDIA H100 80GB HBM3: the digest of
# each case's int64 and float32 partial rows
PARENT_FC_DIGESTS = {
    "single inject W2": "477cf152f260ba6b",
    "single philox W2": "1c9fb9809c54c4e1",
    "universe inject W2": "74841098bf5eaeb2",
    "universe philox W2": "bcbcec43fc1d347f",
    "single inject W40": "5ee1f41c5dfc6643",
    "single philox W40": "c491398d92f792c3",
    "universe inject W40": "fac15f684c43cb24",
    "universe philox W40": "ebc15252b3b29322",
    "single inject W128": "67446c125cd9da98",
    "single philox W128": "b60d6a96f00ca6f2",
    "universe inject W128": "174569ffcb31b798",
    "universe philox W128": "7f9101cde70cba67",
    "single inject W130": "06e873186c691b98",
    "single philox W130": "6b7449134a036b35",
    "universe inject W130": "eadaec34e0c4f8a6",
    "universe philox W130": "221dfb183a4afc30",
    "single inject W390": "f841f9dddd73d035",
    "single philox W390": "725ea038b69859f5",
    "universe inject W390": "7bfe1c4b672192b6",
    "universe philox W390": "99361a4118b63e0e",
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w", chip_smoke.FC_ROWS_BARS)
def test_cuda_first_contact_partial_rows_equal_the_replaced_kernel(w, monkeypatch):
    """At W: the single run (noise, antithetic) and a 3-symbol universe, on
    injected uniforms and on Philox, keeping every sine half it can and
    none (``_FORCE_LONG``): the partial rows' digests are those of the
    kernel this one replaced, bit for bit."""
    dev = _cuda()
    cases = {k: run for k, run in chip_smoke.fc_rows_cases(cuda_mc, dev).items()
             if k.endswith(f" W{w}")}
    assert len(cases) == 4
    for forced in (False, True):
        monkeypatch.setattr(cuda_mc, "_FORCE_LONG", forced)
        for name, run in cases.items():
            got = chip_smoke.count_digest(*run())
            assert got == PARENT_FC_DIGESTS[name], (name, forced)


@pytest.mark.cuda
def test_cuda_first_contact_plan_against_the_model():
    """The launch's own plan (``cuda_mc.universe_plan``) at every even W up
    to 4096, the sine halves kept and not, equals the model above; its
    runtime static shared memory at most the count here."""
    _cuda()
    for keep in (True, False):
        for w in range(2, 4097, 2):
            prev, cuda_mc._FORCE_LONG = cuda_mc._FORCE_LONG, not keep
            try:
                cap, blocks, static, dyn = cuda_mc.universe_plan(w)
            finally:
                cuda_mc._FORCE_LONG = prev
            want = _fc_plan(w, keep)
            assert (cap, blocks, dyn) == (want[0], want[1], want[3]), (w, keep)
            assert 0 < static <= FC_STATIC, (w, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("w,paths", [(40, 1 << 21), (390, 1 << 18)])
def test_cuda_gated_gbm_sweep_rows_equal_their_one_row_launches(w, paths):
    """18 rows of touch limits, cooldowns, paddings and [G] noise stds (every
    row's noise drawn from the same uniforms): each row's partial rows and
    per-path rows equal its one-row launch of ``mc_gated_sweep_kernel``
    (``gated_rows``) bit for bit; at 2^21 paths each thread takes two chunks
    of paths (its float sums carried across them); at W = 40 also 40 rows,
    two passes of the store's rows."""
    dev = _cuda()
    params = EngineParams.default()
    levels = Levels.from_rows(chip_smoke.CLI_ROWS, max_levels=8)
    n = 18
    stops = [0.15 + 0.1 * (i % 6) for i in range(n)]
    tps = [0.15 + 0.1 * (i // 6) for i in range(n)]
    gate = GateConfig.from_params(params).replace(
        touch_limit=[2 + i % 3 for i in range(n)], cooldown_bars=[(i % 4) for i in range(n)])
    noise = McNoise(level_jitter_std=torch.tensor([0.02 * (i % 3) for i in range(n)]),
                    entry_slip_std=torch.tensor([0.01 * (i % 2) for i in range(n)]),
                    stop_slip_std=torch.full((n,), 0.015),
                    target_slip_std=torch.tensor([0.015 * (i % 2) for i in range(n)]))
    kw = dict(num_paths=paths, num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, lanes=1024,
              external_uniforms=None, device=dev)
    before = cuda_gated.LAUNCHES["mc_gated_sweep"]
    rows = cuda_gated.gated_sweep_rows(0, levels, params, stops, tps, gate, noise=noise,
                                       per_path=True, **kw)
    assert cuda_gated.LAUNCHES["mc_gated_sweep"] == before + 1
    for g in range(n):
        one = cuda_gated.gated_rows(
            0, levels, params.replace(stop_padding=stops[g], tp_padding=tps[g]),
            grid_row(gate, g), noise=grid_row(noise, g), antithetic=False, per_path=True, **kw)
        for a, b in zip(one, rows):
            assert torch.equal(a, b[g]), g
        assert float(one[0][:, 1].sum()) > 0
    if w == 40:
        m = 40
        stops40 = [0.15 + 0.02 * i for i in range(m)]
        tps40 = [0.35 - 0.005 * i for i in range(m)]
        rows = cuda_gated.gated_sweep_rows(0, levels, params, stops40, tps40, noise=None,
                                           **dict(kw, num_paths=1 << 18))
        for g in (0, 31, 32, 39):
            one = cuda_gated.gated_rows(
                0, levels, params.replace(stop_padding=stops40[g], tp_padding=tps40[g]),
                noise=None, antithetic=False, **dict(kw, num_paths=1 << 18))
            for a, b in zip(one, rows):
                assert torch.equal(a, b[g]), g


@pytest.mark.cuda
def test_cuda_gated_gbm_sweep_plan_against_the_model():
    """The library's plan at W = 40 and 390 for 18 and 40 rows equals the
    model above on this card's SMs; its static shared memory at most the
    count here."""
    _cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for w in (40, 390):
        for n in (18, 40):
            got = cuda_gated.gbm_sweep_plan(w, n, 4096)
            assert got == _gbm_plan(w, n, 4096, sms), (w, n)
    got = cuda_gated._sampler_sweep_library().qmmx_gated_sampler_sweep_size(4)
    assert 0 < got <= GBM_STATIC
