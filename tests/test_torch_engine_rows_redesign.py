"""The redesigned single-run engine kernel (kernels #8, #8' and the universes
they serve, #10, #10', #11, #11'; ``ops/csrc/mc_engine_rows.cu``): two
producer warpgroups make the bars and their bar-only gates into a ring of
stages in shared memory, two consumer warpgroups run the lifecycle on them,
a path a thread on each side.

On the CPU: the kernel's constants the host and the launch rely on (whole
warpgroups, the register split of setmaxnreg within what
``__launch_bounds__`` gives a CTA, the shared memory at its CTAs an SM, the
byte counters' range); and the routing, with the library calls stubbed:
``engine_rows``, ``engine_universe_rows`` and ``engine_universe_sweep_rows``
under gbm and each sampler at 1 / 3 / 8 levels and W 2 / 40 / 60 count their
launch under the rows kernel's ``LAUNCHES`` key, while odd W, more than 8
levels, W > 61, ``harvest=True`` and the checks' envelope hook still go to
the envelope and the parents' hook (``_FORCE_PARENT``) to the parents.
Marked ``cuda`` (skipped without a card): the rows kernel's partial rows and
per-path rows equal the parents' (``mc_engine_sweep_kernel``,
``mc_engine_sampler_kernel``) bit for bit under injected uniforms and
Philox at W 2, 40 and 60 and 1, 3 and 8 levels, gbm with noise and
antithetic lanes and each sampler with noise, several paths a thread and a
ragged last chunk, and gbm, block bootstrap and Heston with the ML, policy
and blended gates armed (the policy gate is the producers' work); each
universe row equals its one-row launch, and the
sweep of universes' cells the universe's rows.  No JAX here: the plain
version against JAX at this kernel's shapes is
``tests/test_torch_engine.py``'s."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import BLOCK, grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import universe_tables
from qmmx_monolithic_monte_carlo_tpu_torch.parallel.universe import stack_levels
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_engine_kernel import BLEND, _armed_gates, _passing_gates
from .test_torch_sampler_rows_kernel import histories

torch.set_num_threads(2)

SAMPLERS = ("gbm", "bootstrap", "block_bootstrap", "heston")
LEVEL_COUNTS = (1, 3, 8)
HORIZONS = (2, 40, 60)
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
LANES = CE.ENGINE_LANES
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
S0 = np.array([100.0, 100.1, 100.2], np.float32)
SIGMAS = np.array([0.3, 0.25, 0.35], np.float32)
TABLES = universe_tables(histories(5, 3, 500))
CSRC = Path(CE.__file__).parent / "csrc"
SM_SHARED = 228 * 1024          # an H100 SM's shared memory
CTA_SHARED = 227 * 1024         # a CTA's, at most
CTA_RESERVED = 1024             # the runtime's reserve a CTA
SM_REGISTERS = 65536


def _defines(source: str) -> dict:
    """The integer ``#define``s of a kernel source."""
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


ROWS = {**_defines("mc_engine_rows.cuh"), **_defines("mc_engine_rows.cu")}
ENGINE = _defines("mc_engine.cuh")


def _smem(tile: int, stages: int) -> int:
    """A CTA's dynamic shared memory (RowsSmem): the bar ring (5 words a
    path-bar: the bar and its gates' flags), the producers' volume ring, the
    consumers' volume and close rings, each (level, side)'s touch count | bar
    and price, then the contact and skip counts a byte each."""
    lv = ENGINE["MAX_LEVELS"]
    words = (stages * tile * ROWS["ROWS_PLANES"] + ROWS["GATE_RING"] + ENGINE["VOL_RING"]
             + ENGINE["CLOSE_RING"] + 4 * lv) * BLOCK
    return 4 * words + (lv + ENGINE["N_SKIPS"]) * BLOCK


def test_rows_kernel_constants_fit_the_card():
    """A CTA is two producer and two consumer warpgroups (a path a thread
    on each side, the parents' 256 a CTA); setmaxnreg's registers (a
    multiple of 8 in [24, 256]) within what ``__launch_bounds__`` leaves a
    CTA at ``ROWS_MIN_BLOCKS`` an SM (65536 / (512 x CTAs), in steps of 8);
    the dynamic shared memory with the static (the arguments, the reductions)
    within a CTA's 227 KB and the CTAs' within an SM's 228 KB; a tile of
    whole double bars; the flags plane's fields disjoint; the byte counters
    above the longest horizon the kernel takes (61 bars)."""
    threads = 2 * BLOCK
    assert BLOCK % 128 == 0
    assert BLOCK == 256 == ENGINE["BLOCK"]
    assert ROWS["ROWS_STAGES"] >= 2
    p, c, ctas = (ROWS["ROWS_PRODUCER_REGS"], ROWS["ROWS_CONSUMER_REGS"],
                  ROWS["ROWS_MIN_BLOCKS"])
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in (p, c))
    at_launch = SM_REGISTERS // (threads * ctas) // 8 * 8
    assert BLOCK * (p + c) <= threads * at_launch
    assert p < at_launch < c
    assert ROWS["ROWS_TILE"] % 2 == 0 and ROWS["ROWS_PLANES"] == 5
    # the flags: the nearest slot (0-7), its presence, direction + 1, the
    # veto's two bits, the policy's, disjoint; the veto reads 6 past volumes
    fields = [ENGINE["MAX_LEVELS"] - 1, ROWS["ROWS_F_NEAREST"], 3 << ROWS["ROWS_F_DIR_SHIFT"],
              ROWS["ROWS_F_VETO"], ROWS["ROWS_F_VETO_LONG"], ROWS["ROWS_F_POLICY"]]
    assert sum(fields) == int(np.bitwise_or.reduce(fields)) < 1 << 24
    assert ROWS["GATE_RING"] >= 6 and ROWS["GATE_RING"] & (ROWS["GATE_RING"] - 1) == 0
    static = 2048                # EngineArgs, SamplerArgs, the mbarriers, the reductions' arrays
    smem = _smem(ROWS["ROWS_TILE"], ROWS["ROWS_STAGES"])
    assert smem + static <= CTA_SHARED
    assert ctas * (smem + static + CTA_RESERVED) <= SM_SHARED
    assert 61 < 256 and ENGINE["MAX_LEVELS"] == CE.MAX_LEVELS == 8


# ---------------------------------------------------------------- the routing

class _Lib:
    """A stub library: every C entry records its name and returns 0."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.fixture
def stubbed(monkeypatch):
    """The engine's libraries stubbed (each call recorded) and the launch's
    card-only steps (the device check, the stream, the envelope's scratch)
    taken off, so the wrappers' routing runs on the CPU."""
    calls = []
    lib = _Lib(calls)
    for name in ("_library", "_sampler_library", "_rows_library"):
        monkeypatch.setattr(CE, name, lambda: lib)
    monkeypatch.setattr(CE, "_wide_library", lambda suffix: lib)
    monkeypatch.setattr(CE, "launch_pointer", lambda *a: None)
    monkeypatch.setattr(CE, "env_tail", lambda *a: ((0, 1, 0), ()))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=0))
    return calls


def _ladder(n: int, s0: float = 100.0) -> list:
    return [{"color": ("blue", "orange", "black", "teal")[i % 4],
             "type": "solid" if (i // 4) % 2 == 0 else "dashed", "index": i // 8,
             "price": round(s0 + (i - n // 2) * 0.12, 2)} for i in range(n)]


def _skw(sampler: str, universe: bool = False) -> dict:
    if sampler == "gbm":
        return {}
    if sampler == "heston":
        return dict(sampler=sampler)
    return dict(sampler=sampler, tables=TABLES if universe else TABLES[0], block_len=5)


def _launch(entry: str, sampler: str, n_levels: int, num_bars: int, **extra):
    """One launch of ``entry`` on the CPU with the libraries stubbed; returns
    the ``LAUNCHES`` keys it moved."""
    before = dict(CE.LAUNCHES)
    cpu = torch.device("cpu")
    p = EngineParams.default()
    if entry == "engine_rows":
        CE.engine_rows(0, Levels.from_rows(_ladder(n_levels), max_levels=n_levels), p,
                       num_paths=8 * LANES, num_bars=num_bars, sigma=SIGMA, lanes=LANES,
                       device=cpu, **_skw(sampler), **extra)
    else:
        lv = stack_levels([_ladder(n_levels, float(s)) for s in S0], max_levels=n_levels)
        kw = dict(paths_per_symbol=8 * LANES, num_bars=num_bars, dt=DT, lanes=LANES,
                  device=cpu, **_skw(sampler, True), **extra)
        if entry == "engine_universe_rows":
            CE.engine_universe_rows(0, lv, p, S0, SIGMAS, **kw)
        else:
            grid = p.replace(stop_padding=[0.25, 0.35], tp_padding=[0.15, 0.25])
            CE.engine_universe_sweep_rows(0, lv, grid, S0, SIGMAS, **kw)
    return {k for k, v in CE.LAUNCHES.items() if v != before[k]}


PARENT_KEYS = {"engine_rows": "mc_engine", "engine_universe_rows": "mc_engine_universe",
               "engine_universe_sweep_rows": "mc_engine_universe_sweep"}


@pytest.mark.parametrize("entry", list(PARENT_KEYS))
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_parents_launches_go_to_the_rows_kernel(stubbed, entry, sampler):
    """At 1, 3 and 8 levels and W 2, 40 and 60 (the parents' shapes) one
    launch of ``qmmx_mc_engine_rows``, counted under the rows kernel's key
    (``mc_engine_rows``, ``mc_engine_rows_sampler``,
    ``mc_engine_rows_universe[_sampler]``,
    ``mc_engine_rows_universe_sweep[_sampler]``), never the parents'."""
    parent = PARENT_KEYS[entry] + ("" if sampler == "gbm" else "_sampler")
    rows = "mc_engine_rows" + parent[len("mc_engine"):]
    assert rows in CE.LAUNCHES and CE._rows(parent) == rows
    for n_levels in LEVEL_COUNTS:
        for w in HORIZONS:
            del stubbed[:]
            assert _launch(entry, sampler, n_levels, w) == {rows}, (n_levels, w)
            assert stubbed == ["qmmx_mc_engine_rows"], (n_levels, w)


@pytest.mark.parametrize("entry", list(PARENT_KEYS))
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_envelope_shapes_and_hooks_keep_their_kernels(stubbed, monkeypatch, entry, sampler):
    """Odd W, more than 8 levels and W > 61 go to the envelope kernel
    (``_wide``), the harvest (the single run, the universe) to its harvest
    build, and the checks' hooks keep their meaning: ``_FORCE_ENVELOPE``
    sends a parent's shape to the envelope, ``_FORCE_PARENT`` to the parent
    the rows kernel replaced."""
    parent = PARENT_KEYS[entry] + ("" if sampler == "gbm" else "_sampler")
    wide = CE._wide(parent)
    for n_levels, w in ((3, 41), (9, 40), (30, 40), (3, 62), (8, 390)):
        assert _launch(entry, sampler, n_levels, w) == {wide}, (n_levels, w)
    if entry != "engine_universe_sweep_rows":
        assert _launch(entry, sampler, 3, 40, harvest=True) == {wide + "_harvest"}
    monkeypatch.setattr(CE, "_FORCE_ENVELOPE", True)
    assert _launch(entry, sampler, 3, 40) == {wide}
    monkeypatch.setattr(CE, "_FORCE_ENVELOPE", False)
    monkeypatch.setattr(CE, "_FORCE_PARENT", True)
    del stubbed[:]
    assert _launch(entry, sampler, 3, 40) == {parent}
    assert stubbed == ["qmmx_mc_engine_sweep" if sampler == "gbm" else "qmmx_mc_engine_sampler"]
    assert _launch(entry, sampler, 3, 41) == {wide}


# ---------------------------------------------------------------- the card

_BUILT = []


def _cuda():
    """The card, with the rows kernel's and the parents' libraries built at
    once (one nvcc a source, in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if not _BUILT:
        from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

        build.build_all(["mc_engine", "mc_engine_samplers", CE.ROWS_SOURCE])
        _BUILT.append(True)
    return torch.device("cuda")


def _equal_to_parent(monkeypatch, counter: str, launch):
    """``launch()`` on the rows kernel (one launch under ``counter``) and on
    the parent (``_FORCE_PARENT``): every output tensor equal bit for bit."""
    before = CE.LAUNCHES[counter]
    got = launch()
    torch.cuda.synchronize()
    assert CE.LAUNCHES[counter] == before + 1
    monkeypatch.setattr(CE, "_FORCE_PARENT", True)
    want = launch()
    monkeypatch.setattr(CE, "_FORCE_PARENT", False)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for name, a, b in zip(("partial counts", "partial floats", "per-path rows"), got, want):
        assert torch.equal(a, b), name
    return got


# the ML model and the policy armed: the policy failing, passing from bar
# ~12 on, and under the blended gate (the policy gate is the rows kernel's
# producers' work, the rest of the ladder its consumers')
GATES = {"": (dict, {}), "ml+policy": (_armed_gates, {}),
         "policy-passing": (_passing_gates, {}), "blend": (_passing_gates, BLEND)}
CASES = ([(s, n, w, "") for s in SAMPLERS for n in LEVEL_COUNTS for w in HORIZONS]
         + [(s, 3, 40, g) for s in ("gbm", "block_bootstrap", "heston") for g in list(GATES)[1:]])


@pytest.mark.cuda
@pytest.mark.parametrize("sampler, n_levels, num_bars, gates", CASES)
def test_cuda_rows_kernel_equals_the_parent(monkeypatch, sampler, n_levels, num_bars, gates):
    """``engine_rows`` on the rows kernel against the parent, bit for bit:
    on injected uniforms (2 blocks; gbm with noise and antithetic lanes, the
    samplers with noise) and on Philox at 2^20 + 2^13 paths (the 4096-CTA
    grid: two chunks a thread, the last ragged); at every shape with the
    gates off, and at 3 levels x 40 bars with them armed (``GATES``)."""
    dev = _cuda()
    gbm = sampler == "gbm"
    armed, params_kw = GATES[gates]
    levels = Levels.from_rows(_ladder(n_levels), max_levels=n_levels)
    p = EngineParams.default(**params_kw)
    lay = EngineLayout(num_bars, True, sampler)
    u = torch.from_numpy(np.random.default_rng(n_levels * 100 + num_bars).uniform(
        1e-6, 1.0, (2, lay.u_rows, 8, LANES)).astype(np.float32)).to(dev)
    kw = dict(num_bars=num_bars, sigma=SIGMA, dt=DT, lanes=LANES, device=dev, per_path=True,
              noise=McNoise.make(**STDS), **armed(), **_skw(sampler))
    counter = "mc_engine_rows" + ("" if gbm else "_sampler")
    _equal_to_parent(monkeypatch, counter, lambda: CE.engine_rows(
        0, levels, p, num_paths=2 * 8 * LANES, antithetic=gbm, external_uniforms=u, **kw))
    _equal_to_parent(monkeypatch, counter, lambda: CE.engine_rows(
        5, levels, p, num_paths=(1 << 20) + (1 << 13), **dict(kw, noise=None)))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_universe_rows_equal_one_row_launches(monkeypatch, sampler):
    """The engine universe (3 symbols, each its own levels, spot,
    volatility, key and history) on the rows kernel: equal to the parent's
    launch, and each symbol's row to its one-row launch (``engine_rows`` at
    its inputs and ``symbol=s``); the sweep of universes' cells (2 grid
    rows) to the universe at each grid row."""
    dev = _cuda()
    gbm = sampler == "gbm"
    n, w = (1 << 16) + (1 << 13), 40
    lv = stack_levels([_ladder(3, float(s)) for s in S0], max_levels=3)
    p = EngineParams.default()
    kw = dict(paths_per_symbol=n, num_bars=w, dt=DT, lanes=LANES, device=dev, per_path=True,
              noise=McNoise.make(**STDS), **_skw(sampler, True))
    tail = "" if gbm else "_sampler"
    got = _equal_to_parent(monkeypatch, "mc_engine_rows_universe" + tail,
                           lambda: CE.engine_universe_rows(3, lv, p, S0, SIGMAS, **kw))
    for s in range(3):
        skw = _skw(sampler)
        if "tables" in skw:
            skw["tables"] = TABLES[s]
        one = CE.engine_rows(3, grid_row(lv, s), p, num_paths=n, num_bars=w, s0=float(S0[s]), mu=0.0,
                             sigma=float(SIGMAS[s]), dt=DT, lanes=LANES, device=dev,
                             per_path=True, noise=McNoise.make(**STDS), symbol=s, **skw)
        for a, b in zip(one, got):
            assert torch.equal(a, b[s]), s
    grid = p.replace(stop_padding=[0.25, 0.35], tp_padding=[0.15, 0.25])
    cells = _equal_to_parent(monkeypatch, "mc_engine_rows_universe_sweep" + tail,
                             lambda: CE.engine_universe_sweep_rows(3, lv, grid, S0, SIGMAS,
                                                                   **kw))
    for g in range(2):
        one = CE.engine_universe_rows(3, lv, grid_row(grid, g), S0, SIGMAS, **kw)
        for a, b in zip(one, cells):
            assert torch.equal(a, b[:, g]), g
