"""The redesigned engine book kernel (kernels #12 and #12';
``ops/csrc/mc_engine_book_rows.cu``): the rows kernel's producer and consumer
warpgroups (``ops/csrc/mc_engine_rows.cuh``) through every symbol of a chunk
-- the producers make each symbol's bars with the market's draws mixed in,
the consumers run its lifecycle and keep the book's curve -- with the
symbols' arguments in a ring of slots in shared memory and a persistent
grid over the parents' CTAs.

On the CPU: the kernel's constants the launch relies on (whole warpgroups,
the register split within ``__launch_bounds__``, the shared memory at its
CTAs an SM, the ring of argument slots, the scratch within the L2); and the
routing, with the library calls stubbed: ``engine_corr_rows`` under gbm and
each sampler at 1 / 3 / 8 levels and W 2 / 40 / 60 counts its launch under
``mc_engine_rows_corr[_sampler]``, while more than 8 levels, W > 61,
``harvest=True`` and the checks' envelope hook go to the envelope books,
the parents' hook (``_FORCE_PARENT``) to the parents, and an odd W is
refused.  Marked ``cuda`` (skipped without a card): the partial rows and
per-path rows equal the parents' (``mc_engine_corr_kernel``,
``mc_engine_corr_sampler_kernel``) bit for bit under injected uniforms and
Philox at W 2, 40 and 60 and 1, 3 and 8 levels, gbm with noise and
antithetic lanes and each sampler with noise, betas 0 and mixed, one symbol
and several (nine, past the ring of slots), a ragged last chunk; at beta 0
each symbol equals ``engine_universe_rows``' row (gbm, Heston).  No JAX
here: the plain book against the JAX book is ``tests/test_torch_book.py``'s."""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, MarketLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import BLOCK, SamplerArgs
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import universe_tables
from qmmx_monolithic_monte_carlo_tpu_torch.parallel.universe import stack_levels
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

from .test_torch_sampler_rows_kernel import histories

torch.set_num_threads(2)

SAMPLERS = ("gbm", "bootstrap", "block_bootstrap", "heston")
LEVEL_COUNTS = (1, 3, 8)
HORIZONS = (2, 40, 60)
DT = 1.0 / (390.0 * 252.0)
LANES = CE.ENGINE_LANES
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
S0 = [100.0, 100.1, 100.2]
SIGMAS = [0.3, 0.25, 0.35]
BETAS = [0.8, 0.0, 0.45]           # mixed, one symbol at beta 0
WEIGHTS = [0.5, 0.3, 0.2]
TABLES = torch.cat([universe_tables(histories(5 + i, 3, 500)) for i in range(3)])  # 9 symbols
CSRC = Path(CE.__file__).parent / "csrc"
SM_SHARED = 228 * 1024          # an H100 SM's shared memory
CTA_SHARED = 227 * 1024         # a CTA's, at most
CTA_RESERVED = 1024             # the runtime's reserve a CTA
SM_REGISTERS = 65536
H100_SMS, H100_L2 = 132, 50e6


def _defines(source: str) -> dict:
    """The integer ``#define``s of a kernel source."""
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


ROWS = _defines("mc_engine_rows.cuh")
BOOK = _defines("mc_engine_book_rows.cu")
ENGINE = _defines("mc_engine.cuh")


FORMS = ("GBM", "RESAMPLE", "HESTON")     # each sampler's BookForm


def _smem(tile: int) -> int:
    """A CTA's dynamic shared memory at ``tile`` bars a stage (BookSmem): the
    rows kernel's bar ring (5 words a path-bar), the producers' volume ring,
    the consumers' volume and close rings, each (level, side)'s touch count |
    bar and price, then the contact and skip counts a byte each."""
    lv = ENGINE["MAX_LEVELS"]
    words = (BOOK["BOOK_STAGES"] * tile * ROWS["ROWS_PLANES"] + ROWS["GATE_RING"]
             + ENGINE["VOL_RING"] + ENGINE["CLOSE_RING"] + 4 * lv) * BLOCK
    return 4 * words + (lv + ENGINE["N_SKIPS"]) * BLOCK


def _scratch_floats(num_bars: int) -> int:
    """A resident thread's scratch floats (book_scratch_floats): its curve
    and its market draws of a chunk's first symbol, two floats a bar."""
    return 3 * num_bars


@pytest.mark.parametrize("form", FORMS)
def test_book_rows_kernel_constants_fit_the_card(form):
    """Under each sampler's form: two producer and two consumer warpgroups (a
    path a thread on each side); setmaxnreg's split within what
    ``__launch_bounds__`` leaves a CTA; an even tile; the dynamic shared
    memory with the static (the ring of argument slots, the mbarriers, the
    reductions) within a CTA's 227 KB and an SM's 228 KB;
    more argument slots than stages (the producers are at most BOOK_STAGES
    symbols ahead), a power of two; three named barriers (0 the CTA's, the
    consumers', the producers'); a launch's scratch (132 resident CTAs) at
    the longest W the kernel takes within half the L2."""
    threads = 2 * BLOCK
    assert BLOCK % 128 == 0 and BLOCK == ENGINE["BLOCK"]
    p, c, ctas = (BOOK[f"BOOK_PRODUCER_REGS_{form}"], BOOK[f"BOOK_CONSUMER_REGS_{form}"],
                  ROWS["ROWS_MIN_BLOCKS"])
    tile = BOOK[f"BOOK_TILE_{form}"]
    at_launch = SM_REGISTERS // (threads * ctas) // 8 * 8
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in (p, c))
    assert BLOCK * (p + c) <= threads * at_launch and p < at_launch < c
    slots = BOOK["BOOK_ARG_SLOTS"]
    assert slots > BOOK["BOOK_STAGES"] >= 2 and slots & (slots - 1) == 0
    assert len({0, ROWS["BAR_CONSUMERS"], BOOK["BAR_PRODUCERS"]}) == 3
    assert BOOK["BAR_PRODUCERS"] < 16 and tile % 2 == 0 and 2 <= tile <= 60
    slot = ctypes.sizeof(CE._EngineArgs) + ctypes.sizeof(SamplerArgs) + 8
    static = slots * slot + 16 * BOOK["BOOK_STAGES"] + 4 * (ENGINE["N_COUNTS"] + ENGINE["N_SKIPS"]
                                      + ENGINE["HIST_BINS"] + 6 * BLOCK // 32)
    smem = _smem(tile)
    assert smem + static <= CTA_SHARED
    assert ctas * (smem + static + CTA_RESERVED) <= SM_SHARED
    assert H100_SMS * ctas * threads // 2 * 4 * _scratch_floats(60) < H100_L2 / 2


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
    card-only steps (the device check, the stream, the SM count, the
    envelope's scratch) taken off, so the wrapper's routing runs on the CPU."""
    calls = []
    lib = _Lib(calls)
    for name in ("_library", "_corr_library", "_corr_sampler_library", "_book_rows_library"):
        monkeypatch.setattr(CE, name, lambda: lib)
    monkeypatch.setattr(CE, "_wide_library", lambda suffix: lib)
    monkeypatch.setattr(CE, "launch_pointer", lambda *a: None)
    monkeypatch.setattr(CE, "env_tail", lambda *a: ((0, 1, 0), ()))
    monkeypatch.setattr(CE, "sampler_args", lambda *a: (torch.zeros(1), None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: SimpleNamespace(multi_processor_count=H100_SMS))
    return calls


def _ladder(n: int, s0: float = 100.0) -> list:
    return [{"color": ("blue", "orange", "black", "teal")[i % 4],
             "type": "solid" if (i // 4) % 2 == 0 else "dashed", "index": i // 8,
             "price": round(s0 + (i - n // 2) * 0.12, 2)} for i in range(n)]


def _skw(sampler: str) -> dict:
    if sampler == "gbm":
        return {}
    if sampler == "heston":
        return dict(sampler=sampler)
    return dict(sampler=sampler, tables=TABLES[:3], block_len=5)


def _book(n_levels: int, n_sym: int = 3, betas=BETAS):
    """A book of ``n_sym`` symbols (3: S0, SIGMAS, ``betas``, WEIGHTS), each
    its own ``n_levels``-level ladder."""
    s0 = [100.0 + 0.1 * i for i in range(n_sym)]
    sig = (SIGMAS * 3)[:n_sym]
    beta = betas if n_sym == 3 else [(0.1 * i) % 0.9 for i in range(n_sym)]
    weights = WEIGHTS if n_sym == 3 else [1.0 / n_sym] * n_sym
    return (stack_levels([_ladder(n_levels, s) for s in s0], max_levels=n_levels),
            EngineParams.default(), s0, sig, beta, weights)


def _launch(sampler: str, n_levels: int, num_bars: int, **extra):
    """One ``engine_corr_rows`` on the CPU with the libraries stubbed;
    returns the ``LAUNCHES`` keys it moved."""
    before = dict(CE.LAUNCHES)
    CE.engine_corr_rows(0, *_book(n_levels), paths_per_symbol=8 * LANES, num_bars=num_bars,
                        dt=DT, lanes=LANES, device=torch.device("cpu"), **_skw(sampler),
                        **extra)
    return {k for k, v in CE.LAUNCHES.items() if v != before[k]}


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_parent_book_launches_go_to_the_book_rows_kernel(stubbed, sampler):
    """At 1, 3 and 8 levels and W 2, 40 and 60 (the parents' shapes) one
    launch of ``qmmx_mc_engine_book_rows``, counted under
    ``mc_engine_rows_corr`` / ``mc_engine_rows_corr_sampler``, never the
    parents'."""
    parent = "mc_engine_corr" + ("" if sampler == "gbm" else "_sampler")
    rows = "mc_engine_rows" + parent[len("mc_engine"):]
    assert rows in CE.LAUNCHES and CE._rows(parent) == rows
    for n_levels in LEVEL_COUNTS:
        for w in HORIZONS:
            del stubbed[:]
            assert _launch(sampler, n_levels, w) == {rows}, (n_levels, w)
            assert stubbed == ["qmmx_engine_book_rows_scratch", "qmmx_mc_engine_book_rows"], (
                n_levels, w)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_book_envelope_shapes_and_hooks_keep_their_kernels(stubbed, monkeypatch, sampler):
    """More than 8 levels and W > 61 go to the envelope book (``_wide``),
    the harvest to its harvest build, and the checks' hooks keep their
    meaning: ``_FORCE_ENVELOPE`` sends a parent's shape to the envelope,
    ``_FORCE_PARENT`` to the parent the book rows kernel replaced; an odd W
    is refused, as the books always refused it."""
    parent = "mc_engine_corr" + ("" if sampler == "gbm" else "_sampler")
    wide = CE._wide(parent)
    for n_levels, w in ((9, 40), (30, 40), (3, 62), (8, 390)):
        assert _launch(sampler, n_levels, w) == {wide}, (n_levels, w)
    assert _launch(sampler, 3, 40, harvest=True) == {wide + "_harvest"}
    monkeypatch.setattr(CE, "_FORCE_ENVELOPE", True)
    assert _launch(sampler, 3, 40) == {wide}
    monkeypatch.setattr(CE, "_FORCE_ENVELOPE", False)
    monkeypatch.setattr(CE, "_FORCE_PARENT", True)
    del stubbed[:]
    assert _launch(sampler, 3, 40) == {parent}
    assert stubbed == ["qmmx_mc_engine_corr" + ("" if sampler == "gbm" else "_sampler")]
    assert _launch(sampler, 3, 62) == {wide}
    with pytest.raises(ValueError):
        _launch(sampler, 3, 41)


# ---------------------------------------------------------------- the card

_BUILT = []


def _cuda():
    """The card, with the book rows kernel's, the parents' and the rows
    kernel's libraries built at once (one nvcc a source, in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if not _BUILT:
        from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

        build.build_all(["mc_engine", "mc_engine_corr", "mc_engine_corr_samplers",
                         CE.ROWS_SOURCE, CE.BOOK_ROWS_SOURCE])
        _BUILT.append(True)
    return torch.device("cuda")


def _equal_to_parent(monkeypatch, counter: str, launch):
    """``launch()`` on the book rows kernel (one launch under ``counter``) and
    on the parent (``_FORCE_PARENT``): every output tensor equal bit for bit."""
    before = CE.LAUNCHES[counter]
    got = launch()
    torch.cuda.synchronize()
    assert CE.LAUNCHES[counter] == before + 1
    monkeypatch.setattr(CE, "_FORCE_PARENT", True)
    want = launch()
    monkeypatch.setattr(CE, "_FORCE_PARENT", False)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 3
    for name, a, b in zip(("partial counts", "partial floats", "per-path rows"), got, want):
        assert torch.equal(a, b), name
    return got


def _uniforms(sampler, num_bars, n_sym, n_blocks, seed, dev):
    """Injected symbol and market uniforms of a book with noise."""
    rng = np.random.default_rng(seed)
    lay = EngineLayout(num_bars, True, sampler, True)
    u = rng.uniform(1e-6, 1.0, (n_sym, n_blocks, lay.u_rows, 8, LANES)).astype(np.float32)
    um = rng.uniform(1e-6, 1.0, (n_blocks, MarketLayout(num_bars, sampler).u_rows, 8,
                                 LANES)).astype(np.float32)
    return torch.from_numpy(u).to(dev), torch.from_numpy(um).to(dev)


CASES = [(s, n, w) for s in SAMPLERS for n in LEVEL_COUNTS for w in HORIZONS]


@pytest.mark.cuda
@pytest.mark.parametrize("sampler, n_levels, num_bars", CASES)
def test_cuda_book_rows_kernel_equals_the_parent(monkeypatch, sampler, n_levels, num_bars):
    """``engine_corr_rows`` on the book rows kernel against the parent, bit
    for bit: a 3-symbol book (betas 0.8, 0, 0.45) on injected uniforms (2
    blocks, noise; gbm with antithetic lanes) and on Philox at 2^20 + 2^13
    paths a symbol (the 4096-cell grid: two chunks in a cell, the last
    ragged); a 9-symbol book past the ring of argument slots."""
    dev = _cuda()
    gbm = sampler == "gbm"
    counter = "mc_engine_rows_corr" + ("" if gbm else "_sampler")
    kw = dict(num_bars=num_bars, dt=DT, lanes=LANES, device=dev, per_path=True,
              **_skw(sampler))
    u, um = _uniforms(sampler, num_bars, 3, 2, n_levels * 100 + num_bars, dev)
    _equal_to_parent(monkeypatch, counter, lambda: CE.engine_corr_rows(
        0, *_book(n_levels), paths_per_symbol=2 * 8 * LANES, antithetic=gbm,
        noise=McNoise.make(**STDS), external_uniforms=u, market_uniforms=um, **kw))
    _equal_to_parent(monkeypatch, counter, lambda: CE.engine_corr_rows(
        5, *_book(n_levels), paths_per_symbol=(1 << 20) + (1 << 13), **kw))
    nine = dict(kw, tables=TABLES) if "tables" in kw else kw
    _equal_to_parent(monkeypatch, counter, lambda: CE.engine_corr_rows(
        7, *_book(n_levels, 9), paths_per_symbol=1 << 16, antithetic=gbm,
        noise=McNoise.make(**STDS), **nine))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_book_rows_one_symbol_and_beta_zero(monkeypatch, sampler):
    """A one-symbol book (its book row then its symbol's, weight 1) and a
    book at beta 0, each equal to the parent; at beta 0 under gbm and Heston
    (whose draws are the single run's) each symbol's rows equal
    ``engine_universe_rows``' (one path a thread: the two reductions add in
    one order)."""
    dev = _cuda()
    gbm = sampler == "gbm"
    counter = "mc_engine_rows_corr" + ("" if gbm else "_sampler")
    n = 1 << 16
    kw = dict(num_bars=40, dt=DT, lanes=LANES, device=dev, per_path=True,
              noise=McNoise.make(**STDS), **_skw(sampler))
    lv, p, s0, sig, _, _ = _book(3)
    okw = dict(kw, noise=None, **({"tables": TABLES[:1]} if "tables" in kw else {}))
    one = _equal_to_parent(monkeypatch, counter, lambda: CE.engine_corr_rows(
        3, stack_levels([_ladder(3)], max_levels=3), p, [100.0], [0.3], [0.7], [1.0],
        paths_per_symbol=n, **okw))
    assert torch.equal(one[2][1][:, :6], one[2][0][:, :6])
    zero = _equal_to_parent(monkeypatch, counter, lambda: CE.engine_corr_rows(
        3, lv, p, s0, sig, 0.0, WEIGHTS, paths_per_symbol=n, **kw))
    if sampler in ("gbm", "heston"):
        uni = CE.engine_universe_rows(3, lv, p, s0, sig, paths_per_symbol=n, **kw)
        for a, b in zip(zero, uni):
            assert torch.equal(a[:3], b)
