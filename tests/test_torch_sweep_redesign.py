"""The two redesigned sweep kernels' host side, the port alone (no JAX): the
gbm sweep's shared memory (``mc_first_contact_sweep.cu``: the arguments, the
rows' sums and ``cap`` sine halves a thread) and the gated sampler sweep's
(``mc_gated_sampler_sweep.cu``: no dynamic shared memory, a bar store in a
device scratch) fit an SM at their ``__launch_bounds__`` across the horizons
they take, with the constants read from the kernels' sources; and the
first-contact bound's Philox count (``chip_smoke.fc_ops``, ``sweep_ops``)
against a direct count of the groups of four rows each path touches.  The
launch's own plan on the card (``cuda_mc.sweep_plan``) against the same
model is the one ``cuda`` case."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from chip_smoke import PHILOX_IMULS, fc_ops, sweep_ops
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GbmLayout, fused_uniforms
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import (BLOCK, SamplerArgs, consts,
                                                                   knobs, level_slots)
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
CONFIG5 = [(0.25, 0.15), (0.35, 0.25), (0.45, 0.35)]
SM_SHARED = 228 * 1024          # an H100 SM's shared memory
CTA_SHARED = 227 * 1024         # a CTA's, at most
CTA_RESERVED = 1024             # the runtime's reserve a CTA
DEFAULT_SHARED = 48 * 1024      # a CTA's without the dynamic shared memory opt-in
CSRC = Path(cuda_mc.__file__).parent / "csrc"


def _defines(source: str) -> dict:
    """The integer ``#define``s of a kernel source."""
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


FC = _defines("mc_first_contact_sweep.cu")
# the gbm sweep's static shared memory: McArgs and SweepGrid, the rows' counts
# and warp sums, and 16 bytes for their alignment (at most what the compiler lays out)
FC_STATIC = (ctypes.sizeof(cuda_mc._McArgs) + ctypes.sizeof(cuda_mc._SweepGrid)
             + 4 * cuda_mc.SWEEP_ROWS * (cuda_mc.ROW_COUNTS + cuda_mc.ROW_FLOATS * BLOCK // 32)
             + 16)


def _fc_plan(w: int, keep: bool = True) -> tuple:
    """The gbm sweep launch's plan at W, as the source's constants give it:
    (sine halves kept, CTAs an SM, static bytes at most, dynamic bytes)."""
    cap = min(w // 2, FC["FC_SWEEP_MAX_CAP"]) if keep else 0
    blocks = (FC["FC_SWEEP_MIN_BLOCKS_NARROW"] if cap <= FC["FC_SWEEP_NARROW_CAP"]
              else FC["FC_SWEEP_MIN_BLOCKS"])
    return cap, blocks, FC_STATIC, 4 * cap * BLOCK


def test_gbm_sweep_shared_memory_fits_at_every_even_w():
    """Every even W up to 2048, the sine halves kept or not: a CTA's static
    and dynamic shared memory within 227 KB, and its ``__launch_bounds__``
    CTAs an SM within 228 KB (1 KB reserved a CTA): the four-CTA build up to
    FC_SWEEP_NARROW_CAP sine halves (W = 90), else the three-CTA one; the
    halves all kept up to W = 128 (``mc_sweep``), 64 past it; from W = 76 a
    CTA takes more than the 48 KB it gets without opting in, so the launch
    opts in for either build."""
    assert FC["FC_SWEEP_MAX_CAP"] * 2 == cuda_mc.MAX_HALF_BARS
    assert FC["FC_SWEEP_NARROW_CAP"] < FC["FC_SWEEP_MAX_CAP"]
    for w in range(2, 2049, 2):
        for keep in (True, False):
            cap, blocks, static, dyn = _fc_plan(w, keep)
            assert static + dyn <= CTA_SHARED, (w, keep)
            assert blocks * (static + dyn + CTA_RESERVED) <= SM_SHARED, (w, keep)
        assert (2 * _fc_plan(w)[0] == w) == (w <= cuda_mc.MAX_HALF_BARS), w
    # the three shapes timed: W 40 (20 KB of halves), 128 and 390 (64 KB)
    assert [_fc_plan(w)[3] for w in (40, 128, 390)] == [20 * 1024, 64 * 1024, 64 * 1024]
    # the four-CTA build past the default 48 KB from W = 76 to its last, W = 90
    past = [w for w in range(2, 2049, 2) if sum(_fc_plan(w)[2:]) > DEFAULT_SHARED
            and _fc_plan(w)[1] == FC["FC_SWEEP_MIN_BLOCKS_NARROW"]]
    assert (past[0], past[-1]) == (76, 90)
    # the narrow bound is the most that fits: one half more and it would not
    assert (FC["FC_SWEEP_MIN_BLOCKS_NARROW"]
            * (FC_STATIC + 4 * (FC["FC_SWEEP_NARROW_CAP"] + 1) * BLOCK + CTA_RESERVED)
            > SM_SHARED)


GATED = _defines("mc_gated_sampler_sweep.cu")
# the gated sampler sweep's static shared memory: two GatedArgs (the bars'
# and the replayed row's), the SamplerArgs, cta_add_path_row's counts,
# histogram and warp sums
GATED_STATIC = (2 * ctypes.sizeof(cuda_gated._GatedArgs) + ctypes.sizeof(SamplerArgs)
                + 4 * cuda_gated.ROW_COUNTS + 4 * cuda_gated.ROW_FLOATS * BLOCK // 32)


@pytest.mark.parametrize("num_bars", [40, 390])
def test_gated_sampler_sweep_shared_memory_and_store_fit(num_bars):
    """No dynamic shared memory: the static (two GatedArgs, the SamplerArgs,
    the path row's counts and sums) lets 8 CTAs share an SM, more than the
    occupancy calculator can give; the bar store is BAR_PLANES planes of W x
    BLOCK floats a resident CTA: at the bound's 2 CTAs an SM of 132 32 MB at
    W = 40 (inside the 50 MB L2), 302 MB at 390; at 4 CTAs an SM twice that,
    on an 80 GB card."""
    assert GATED["BAR_PLANES"] == cuda_gated.BAR_PLANES
    assert GATED_STATIC <= DEFAULT_SHARED
    assert 8 * (GATED_STATIC + CTA_RESERVED) <= SM_SHARED
    ctas = 132 * GATED["GATED_SWEEP_MIN_BLOCKS"]
    floats = cuda_gated.sweep_store_floats(ctas, num_bars)
    assert floats == ctas * cuda_gated.BAR_PLANES * num_bars * BLOCK
    assert 4 * floats <= (32 << 20 if num_bars == 40 else 302 << 20)
    assert 8 * floats <= (610 << 20)


@pytest.mark.cuda
def test_cuda_sweep_kernels_plan_and_static_shared_memory_within_the_host_count():
    """The gbm sweep launch's own plan (``cuda_mc.sweep_plan``) at every
    even W up to 2048, the sine halves kept and not, equals the model above
    from the source's constants, its runtime static shared memory at most the
    host's count (so the fits above hold on the card); the gated sampler
    sweep's static shared memory at most its count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for keep in (True, False):
        for w in range(2, 2049, 2):
            prev, cuda_mc._FORCE_LONG = cuda_mc._FORCE_LONG, not keep
            try:
                cap, blocks, static, dyn = cuda_mc.sweep_plan(w)
            finally:
                cuda_mc._FORCE_LONG = prev
            want = _fc_plan(w, keep)
            assert (cap, blocks, dyn) == (want[0], want[1], want[3]), (w, keep)
            assert 0 < static <= FC_STATIC, (w, keep)
    got = cuda_gated._sampler_sweep_library().qmmx_gated_sampler_sweep_size(2)
    assert 0 < got <= GATED_STATIC


def _direct_groups(walked, ebar, entered, w):
    """The Philox calls a path needs, counted row by row: the groups j of
    the rows it reads (4j .. 4j + 3 are call j's four words)."""
    half, total = w // 2, 0
    for n, e, ent in zip(walked.tolist(), ebar.tolist(), entered.tolist()):
        pairs = min(n, half)
        rows = set(range(pairs)) | set(range(half, half + pairs))
        if ent:
            for t in range(e + 1, n):
                rows |= {w + t, 2 * w + t}
        total += len({r // 4 for r in rows})
    return total


def _walks(w, lanes, rows):
    """Per path of one block at seed 0: the bars each (stop, tp) row walks,
    the contact bar and whether the path entered, from the plain version's
    own steps."""
    levels = Levels.from_rows(ROWS, max_levels=8)
    layout = GbmLayout(w)
    u = fused_uniforms(0, layout, block0=0, n_blocks=1, lanes=lanes, device="cpu")
    lp, lv = level_slots(levels)
    p = EngineParams.default()
    ct = cuda_mc._contact(u, layout, lp, lv, levels.max_levels, knobs(p, None)["prox"],
                          consts(100.0, 0.0, SIGMA, DT), False)
    walked = [cuda_mc._replay(ct, layout, knobs(p.replace(stop_padding=sp, tp_padding=tp),
                                                None))[2].reshape(-1) for sp, tp in rows]
    return (torch.stack(walked).amax(dim=0), ct["ebar"].reshape(-1),
            ct["entered"].reshape(-1), levels)


@pytest.mark.parametrize("num_bars", [40, 390])
def test_fc_ops_counts_one_philox_call_a_group_of_four_rows(num_bars):
    """The recounted bound: ``fc_ops`` counts the Philox calls the plain
    version's work gives (``cuda_mc.philox_groups``), which equal a direct
    count of the groups of four rows each path touches (at W = 390 the
    radius, angle and high rows share their boundary groups); the count a
    uniform (``by_groups=False``, the bound before) is over 3x it.  The
    sweep's count is its longest row's walk."""
    lanes = 1024
    kw = dict(num_paths=lanes, num_bars=num_bars, sigma=SIGMA, lanes=lanes, device="cpu")
    walked, ebar, entered, levels = _walks(num_bars, lanes, [(0.35, 0.25)])
    direct = _direct_groups(walked, ebar, entered, num_bars)
    c, _, work = cuda_mc.fused_totals_reference(0, levels, EngineParams.default(), work=True,
                                                **kw)
    assert int(work[-1]) == direct
    ops = fc_ops(work, int(c[1]), 1.0)
    assert ops["imul"] == PHILOX_IMULS * direct
    per_uniform = 2 * int(work[0]) + 2 * int(work[2])
    assert fc_ops(work, int(c[1]), 1.0, by_groups=False)["imul"] == PHILOX_IMULS * per_uniform
    assert per_uniform > 3 * direct
    stops, tps = zip(*CONFIG5)
    walked, ebar, entered, _ = _walks(num_bars, lanes, CONFIG5)
    sc, _, swork = cuda_mc.sweep_totals_reference(0, levels, EngineParams.default(), stops,
                                                  tps, work=True, **kw)
    assert int(swork[-1]) == _direct_groups(walked, ebar, entered, num_bars)
    assert sweep_ops(swork, int(sc[0, 1]), 3, 1.0)["imul"] == PHILOX_IMULS * int(swork[-1])
