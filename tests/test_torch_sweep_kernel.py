"""The three sweep kernels' wrappers and plain versions, the port alone: each
plain sweep's row g equals the single-configuration plain version at the same
seed (Philox and injected uniforms), in totals and per path, bit for bit;
the wrappers' checks, device rules, launch counts and int64 folds; and, where
a CUDA device is present, each sweep kernel against its plain version and
row g against the single-configuration kernel.

The single-configuration plain versions are held against JAX in
``test_torch_mc_kernel.py``, ``test_torch_gated_kernel.py`` and
``test_torch_engine_kernel.py``.  Nothing here imports JAX, so the CUDA tests
also run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_sweep_kernel.py -m cuda``."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                             GbmLayout)
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import sweep as PS
from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
# the JAX engine kernel tests' levels (tests/test_pallas_engine.py:25-32)
ENGINE_ROWS = [dict(r) for r in ROWS]
ENGINE_ROWS[2]["price"] = 99.6
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
# BASELINE config #5's (stop, tp) rows (benchmarks/run_all.py:228)
CONFIG5 = [(0.25, 0.15), (0.35, 0.25), (0.45, 0.35)]
# the CLI sweep's default 3 x 3 (stop, tp) grid
GRID9 = [(sp, tp) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)]


def _levels(rows=ROWS):
    return Levels.from_rows(rows, max_levels=8)


def _stack(cfgs):
    return type(cfgs[0])(**{f.name: torch.stack([getattr(c, f.name) for c in cfgs])
                            for f in dataclasses.fields(cfgs[0])})


def _noise_rows(stds):
    """McNoise with [G] stds from rows (jitter, entry, stop, target)."""
    cols = list(zip(*stds))
    return McNoise(level_jitter_std=torch.tensor(cols[0]),
                   entry_slip_std=torch.tensor(cols[1]),
                   stop_slip_std=torch.tensor(cols[2]),
                   target_slip_std=torch.tensor(cols[3]))


def _fc_uniforms(seed, w, nb, lanes):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(1e-9, 1.0, (nb, GbmLayout(w).n_rows, lanes))
                            .astype(np.float32))


def _life_uniforms(seed, layout, nb, lanes):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(1e-6, 1.0, (nb, layout.u_rows, 8, lanes))
                            .astype(np.float32))


# ---------------------------------------------------------------------------
# first contact (kernel #3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["philox", "injected"])
def test_first_contact_sweep_rows_equal_single_configs(mode):
    lanes, nb, w = 1024, 2, 40
    stops, tps = zip(*CONFIG5)
    kw = dict(num_paths=nb * lanes, num_bars=w, sigma=SIGMA, dt=DT, lanes=lanes)
    kw.update(external_uniforms=_fc_uniforms(3, w, nb, lanes)) if mode == "injected" \
        else kw.update(device="cpu")
    params = EngineParams.default()
    counts, floats = cuda_mc.sweep_totals_reference(11, _levels(), params, stops, tps, **kw)
    assert counts.shape == (3, cuda_mc.ROW_COUNTS) and floats.dtype == torch.float64
    for g, (sp, tp) in enumerate(CONFIG5):
        c, f = cuda_mc.fused_totals_reference(
            11, _levels(), params.replace(stop_padding=sp, tp_padding=tp), **kw)
        assert torch.equal(c, counts[g]) and torch.equal(f, floats[g]), g
    # the rows change decisions: wider paddings resolve fewer paths
    assert int(counts[0, 4]) < int(counts[1, 4]) < int(counts[2, 4])
    assert int(counts[0, 1]) == int(counts[2, 1]) > 0       # the contact is shared
    stats = cuda_mc.mc_paths_sweep_fused(11, _levels(), params, stops, tps, **kw)
    assert stats.n.shape == (3,) and stats.hist.shape == (3, 128)
    assert float(stats.row(1).hit_rate) == float(stats.hit_rate[1])


def test_first_contact_sweep_work_counts_the_longest_row():
    lanes = 1024
    stops, tps = zip(*CONFIG5)
    kw = dict(num_paths=lanes, num_bars=40, sigma=SIGMA, lanes=lanes, device="cpu")
    *_, work = cuda_mc.sweep_totals_reference(2, _levels(), EngineParams.default(),
                                              stops, tps, work=True, **kw)
    singles = [cuda_mc.fused_totals_reference(
        2, _levels(), EngineParams.default(stop_padding=sp, tp_padding=tp),
        work=True, **kw)[2] for sp, tp in CONFIG5]
    assert int(work[1]) >= max(int(s[1]) for s in singles)
    assert int(work[3]) == sum(int(s[2]) for s in singles)


# ---------------------------------------------------------------------------
# gated (kernel #6)
# ---------------------------------------------------------------------------

def _gated_grid():
    """Four rows: touch limits and q_min on the grid axis, a cooldown row."""
    params = EngineParams.default()
    grid, gate_g = PS.grid_params_gated(params, GateConfig.from_params(params),
                                        stop_paddings=[0.35], tp_paddings=[0.25, 0.40],
                                        touch_limits=[2, 4], q_min_probs=[0.55])
    gate_g = gate_g.replace(cooldown_bars=torch.tensor([0, 0, 3, 0], dtype=torch.int32))
    return params, grid, gate_g


@pytest.mark.parametrize("mode,noisy", [("philox", False), ("injected", True)])
def test_gated_sweep_rows_equal_single_configs(mode, noisy):
    lanes, nb, w = 256, 2, 24
    params, grid, gate_g = _gated_grid()
    noise = _noise_rows([(0.0, 0.0, 0.0, 0.0), (0.02, 0.01, 0.015, 0.015),
                         (0.02, 0.0, 0.0, 0.0), (0.0, 0.01, 0.0, 0.015)]) if noisy else None
    kw = dict(num_paths=nb * 8 * lanes, num_bars=w, sigma=SIGMA, lanes=lanes, noise=noise)
    kw.update(external_uniforms=_life_uniforms(4, GatedLayout(w, noisy), nb, lanes)) \
        if mode == "injected" else kw.update(device="cpu")
    counts, floats, rows = cuda_gated.gated_sweep_totals_reference(
        7, _levels(), params, grid.stop_padding, grid.tp_padding, gate_g,
        per_path=True, **kw)
    assert rows.shape == (4, kw["num_paths"], cuda_gated.PATH_COLS)
    for g in range(4):
        single = dict(kw, noise=grid_row(noise, g))
        c, f, r = cuda_gated.gated_totals_reference(
            7, _levels(), grid_row(grid, g), grid_row(gate_g, g),
            per_path=True, **single)
        assert torch.equal(c, counts[g]) and torch.equal(f, floats[g]), g
        assert torch.equal(r, rows[g]), g
    trades = counts[:, 5].tolist()
    assert len(set(trades)) == 4, trades                 # every row decides differently
    # rows (tp, touch limit): (0.25, 2), (0.25, 4), (0.40, 2; cooldown 3), (0.40, 4)
    assert trades[0] < trades[1] and trades[2] < trades[3]   # the touch limit binds


def test_gated_sweep_default_gate_is_from_params():
    params = EngineParams.default(q_min_prob=0.7)
    kw = dict(num_paths=8 * 256, num_bars=8, sigma=SIGMA, lanes=256, device="cpu")
    a = cuda_gated.gated_sweep_totals_reference(1, _levels(), params, [0.3], [0.2], **kw)
    b = cuda_gated.gated_sweep_totals_reference(
        1, _levels(), params, [0.3], [0.2], GateConfig.from_params(params), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# engine (kernel #9)
# ---------------------------------------------------------------------------

# tests/test_pallas_engine.py:320-325 and the noise-std rows of :444
ENGINE_CFGS = [EngineParams.default(),
               EngineParams.default(stop_padding=0.20, tp_padding=0.40),
               EngineParams.default(q_min_prob=0.40, enable_veto=False),
               EngineParams.default(overtouch_limit=2, cooldown_s=180.0)]
NOISE_ROWS = [(0.0, 0.0, 0.0, 0.0), (0.02, 0.01, 0.015, 0.015)]
# `sweep --engine --jitter-stds 0 0.02`'s noise rows, and a slip row
CLI_NOISE_ROWS = [(0.0, 0.0, 0.0, 0.0), (0.02, 0.0, 0.0, 0.0), (0.02, 0.01, 0.015, 0.015)]


@pytest.mark.parametrize("case", ["configs", "noise"])
def test_engine_sweep_rows_equal_single_configs(case):
    lanes, w = 256, 24
    if case == "configs":
        grid, noise, n_grid = _stack(ENGINE_CFGS), None, None
        kw = dict(device="cpu")
    else:
        grid, noise, n_grid = EngineParams.default(), _noise_rows(NOISE_ROWS), 2
        kw = dict(external_uniforms=_life_uniforms(37, EngineLayout(w, True), 1, lanes))
    kw.update(num_paths=8 * lanes, num_bars=w, sigma=SIGMA, dt=DT, lanes=lanes)
    counts, floats, rows = cuda_engine.engine_sweep_totals_reference(
        0, _levels(ENGINE_ROWS), grid, n_grid=n_grid, noise=noise, per_path=True, **kw)
    g_rows = counts.shape[0]
    assert g_rows == (4 if case == "configs" else 2)
    for g in range(g_rows):
        c, f, r = cuda_engine.engine_totals_reference(
            0, _levels(ENGINE_ROWS), grid_row(grid, g), noise=grid_row(noise, g),
            per_path=True, **kw)
        assert torch.equal(c, counts[g]) and torch.equal(f, floats[g]), g
        assert torch.equal(r, rows[g]), g
    stats, skips, escal = cuda_engine.stats_from_engine_totals(counts, floats)
    assert skips.shape == (g_rows, 16) and escal.shape == (g_rows,)
    assert len({tuple(x) for x in skips.tolist()}) == g_rows   # the rows decide differently


# ---------------------------------------------------------------------------
# checks, device rules, launches, folds
# ---------------------------------------------------------------------------

def _sweeps():
    lv, p = _levels(), EngineParams.default()
    fc = dict(num_paths=1024, num_bars=8, lanes=1024)
    life = dict(num_paths=8 * 256, num_bars=8, lanes=256)
    return {
        "mc_paths_sweep_fused": lambda **k: cuda_mc.mc_paths_sweep_fused(
            0, lv, p, [0.3, 0.4], [0.2, 0.3], **{**fc, **k}),
        "sweep_totals_reference": lambda **k: cuda_mc.sweep_totals_reference(
            0, lv, p, [0.3], [0.2], **{**fc, **k}),
        "mc_paths_gated_sweep_fused": lambda **k: cuda_gated.mc_paths_gated_sweep_fused(
            0, lv, p, [0.3, 0.4], [0.2, 0.3], **{**life, **k}),
        "gated_sweep_totals_reference": lambda **k: cuda_gated.gated_sweep_totals_reference(
            0, lv, p, [0.3], [0.2], **{**life, **k}),
        "mc_paths_engine_sweep_fused": lambda **k: cuda_engine.mc_paths_engine_sweep_fused(
            0, lv, p, n_grid=2, **{**life, **k}),
        "engine_sweep_totals_reference": lambda **k: cuda_engine.engine_sweep_totals_reference(
            0, lv, p, n_grid=2, **{**life, **k}),
        "parallel.sweep_paths": lambda **k: PS.sweep_paths(
            0, lv, PS.grid_params(p, stop_paddings=[0.3], tp_paddings=[0.2]),
            num_paths=256, num_bars=8, block_paths=256, **k),
        "parallel.sweep_paths_gated": lambda **k: PS.sweep_paths_gated(
            0, lv, PS.grid_params(p, stop_paddings=[0.3], tp_paddings=[0.2]),
            num_paths=256, num_bars=8, block_paths=256, **k),
    }


@pytest.mark.parametrize("name", list(_sweeps()))
def test_entry_points_default_to_the_card(name):
    """device=None means the CUDA device: without one it raises, naming the
    way to the CPU; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _sweeps()[name]()


def test_sweep_wrappers_take_the_plain_version_for_cpu():
    before = [dict(m.LAUNCHES) for m in (cuda_mc, cuda_gated, cuda_engine)]
    for name in ("mc_paths_sweep_fused", "mc_paths_gated_sweep_fused",
                 "mc_paths_engine_sweep_fused"):
        out = _sweeps()[name](device="cpu")
        stats = out[0] if isinstance(out, tuple) else out
        assert stats.n.shape == (2,)
    assert [dict(m.LAUNCHES) for m in (cuda_mc, cuda_gated, cuda_engine)] == before


@pytest.mark.parametrize("bad", ["grid_lengths", "paths", "odd_bars", "levels",
                                 "gate_length", "engine_no_grid", "engine_leaf_length"])
def test_sweep_wrappers_reject_bad_inputs(bad):
    lv, p = _levels(), EngineParams.default()
    many = Levels.from_rows([{"color": "blue", "type": "solid", "index": i,
                              "price": 100.0 + i} for i in range(9)], max_levels=16)
    fc = dict(num_paths=1024, num_bars=8, lanes=1024, device="cpu")
    life = dict(num_paths=8 * 256, num_bars=8, lanes=256, device="cpu")
    calls = {
        "grid_lengths": [lambda: cuda_mc.mc_paths_sweep_fused(0, lv, p, [0.3, 0.4], [0.2], **fc),
                         lambda: cuda_gated.mc_paths_gated_sweep_fused(
                             0, lv, p, [0.3], [0.2, 0.3], **life)],
        "paths": [lambda: cuda_mc.mc_paths_sweep_fused(0, lv, p, [0.3], [0.2],
                                                       **dict(fc, num_paths=1536)),
                  lambda: cuda_gated.mc_paths_gated_sweep_fused(
                      0, lv, p, [0.3], [0.2], **dict(life, num_paths=8 * 256 + 256)),
                  lambda: cuda_engine.mc_paths_engine_sweep_fused(
                      0, lv, p, n_grid=1, **dict(life, num_paths=8 * 256 + 256))],
        "odd_bars": [lambda: cuda_mc.mc_paths_sweep_fused(0, lv, p, [0.3], [0.2],
                                                          **dict(fc, num_bars=9)),
                     lambda: cuda_gated.mc_paths_gated_sweep_fused(
                         0, lv, p, [0.3], [0.2], **dict(life, num_bars=9))],
        "levels": [lambda: cuda_mc.mc_paths_sweep_fused(0, many, p, [0.3], [0.2], **fc),
                   lambda: cuda_engine.mc_paths_engine_sweep_fused(0, many, p, n_grid=1,
                                                                   **life)],
        "gate_length": [lambda: cuda_gated.mc_paths_gated_sweep_fused(
            0, lv, p, [0.3, 0.4], [0.2, 0.3],
            GateConfig.default().replace(touch_limit=[1, 2, 3]), **life)],
        "engine_no_grid": [lambda: cuda_engine.mc_paths_engine_sweep_fused(0, lv, p, **life)],
        "engine_leaf_length": [lambda: cuda_engine.mc_paths_engine_sweep_fused(
            0, lv, p.replace(stop_padding=[0.2, 0.3]), noise=_noise_rows(
                [(0.0,) * 4] * 3), **life)],
    }[bad]
    for call in calls:
        with pytest.raises(ValueError):
            call()


def test_kernel_wrappers_do_not_import_the_sweep_pipelines():
    """The ops layer takes the grid rows from ops/kernel_args; only the layer
    above (parallel, host) imports parallel.sweep."""
    code = ("import sys\n"
            "from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, "
            "cuda_mc\n"
            "bad = [m for m in sys.modules if m.startswith("
            "'qmmx_monolithic_monte_carlo_tpu_torch.parallel')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_sweep_launchers_refuse_the_cpu():
    lv, p = _levels(), EngineParams.default()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mc.sweep_rows(0, lv, p, [0.3], [0.2], num_paths=1024, num_bars=8, s0=100.0,
                           mu=0.0, sigma=SIGMA, dt=DT, lanes=1024, external_uniforms=None,
                           device=torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gated.gated_sweep_rows(0, lv, p, [0.3], [0.2], num_paths=2048, num_bars=8,
                                    s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, lanes=256,
                                    noise=None, external_uniforms=None, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_engine.engine_sweep_rows(0, lv, p, n_grid=1, num_paths=2048, num_bars=8,
                                      lanes=256, device="cpu")


@pytest.mark.parametrize("mod", [cuda_mc, cuda_gated, cuda_engine])
def test_sweep_folds_stay_exact_int64_past_2_24(mod):
    big = torch.zeros((2, 3, mod.ROW_COUNTS), dtype=torch.int64)
    big[..., :6] = (1 << 28) + 1
    big[1] *= 2
    floats = torch.zeros((2, 3, mod.ROW_FLOATS))
    floats[..., 0] = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    c, f = mod.reduce_rows(big, floats)
    assert c.shape == (2, mod.ROW_COUNTS) and f.dtype == torch.float64
    assert int(c[0, 5]) == 3 * ((1 << 28) + 1) and int(c[1, 5]) == 6 * ((1 << 28) + 1)
    assert f[:, 0].tolist() == [6.0, 15.0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _lifecycle_differ(got, want) -> int:
    """Paths that differ: in their integer columns, or in equity or dd by
    more than 1e-3 per trade (a flipped decision may keep the counts)."""
    ints = [1, 2, 3, 4] + list(range(6, got.shape[1]))
    err = (got[:, [0, 5]] - want[:, [0, 5]]).abs().amax(dim=1)
    return int(((got[:, ints] != want[:, ints]).any(dim=1)
                | (err > 1e-3 * torch.clamp(want[:, 1], min=1.0))).sum())


@pytest.mark.cuda
def test_cuda_sweeps_match_their_plain_versions():
    _need_cuda()
    dev = torch.device("cuda")
    lanes, w = 1024, 40
    # first contact: injected uniforms, totals within the flip budget
    stops, tps = zip(*CONFIG5)
    u = _fc_uniforms(5, w, 4, 8192)
    kw = dict(num_paths=4 * 8192, num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
              lanes=8192)
    want = cuda_mc.sweep_totals_reference(0, _levels(), EngineParams.default(), stops, tps,
                                          external_uniforms=u, **kw)
    got = cuda_mc.reduce_rows(*cuda_mc.sweep_rows(
        0, _levels(), EngineParams.default(), stops, tps, external_uniforms=u.to(dev),
        device=dev, **kw))
    flips = 2 + kw["num_paths"] // 1024
    assert torch.equal(got[0][:, 0].cpu(), want[0][:, 0])
    assert int((got[0][:, 1:5].cpu() - want[0][:, 1:5]).abs().max()) <= flips
    # gated: per (row, path) within the flip budget of each row
    params, grid, gate_g = _gated_grid()
    noise = _noise_rows([(0.0,) * 4, (0.02, 0.01, 0.015, 0.015), (0.0,) * 4, (0.0,) * 4])
    u = _life_uniforms(6, GatedLayout(w, True), 2, lanes)
    gkw = dict(num_paths=2 * 8 * lanes, num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
               lanes=lanes, noise=noise)
    want = cuda_gated.gated_sweep_totals_reference(
        0, _levels(), params, grid.stop_padding, grid.tp_padding, gate_g,
        external_uniforms=u, per_path=True, **gkw)
    got = cuda_gated.gated_sweep_rows(
        0, _levels(), params, grid.stop_padding, grid.tp_padding, gate_g,
        external_uniforms=u.to(dev), device=dev, per_path=True, **gkw)
    flips = 2 + gkw["num_paths"] // 1024
    for g in range(4):
        assert _lifecycle_differ(got[2][g].cpu(), want[2][g]) <= flips, g
    # engine: per (row, path), skip counts included; the four configurations,
    # then [G] noise stds (the CLI's jitter rows and a slip row)
    for grid, noise in ((_stack(ENGINE_CFGS), None),
                        (EngineParams.default(), _noise_rows(CLI_NOISE_ROWS))):
        n_grid = None if noise is None else len(CLI_NOISE_ROWS)
        u = _life_uniforms(7, EngineLayout(w, noise is not None), 2, 256)
        ekw = dict(num_paths=2 * 8 * 256, num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
                   lanes=256, n_grid=n_grid, noise=noise, per_path=True)
        want = cuda_engine.engine_sweep_totals_reference(
            0, _levels(ENGINE_ROWS), grid, external_uniforms=u, **ekw)
        got = cuda_engine.engine_sweep_rows(
            0, _levels(ENGINE_ROWS), grid, external_uniforms=u.to(dev), device=dev, **ekw)
        flips = 2 + ekw["num_paths"] // 1024
        for g in range(want[0].shape[0]):
            assert _lifecycle_differ(got[2][g].cpu(), want[2][g]) <= flips, (g, noise)


@pytest.mark.cuda
def test_cuda_sweep_rows_equal_single_config_kernels():
    """Row g of each sweep kernel equals the single-configuration kernel at
    the same seed, bit for bit (Philox mode)."""
    _need_cuda()
    dev = torch.device("cuda")
    stops, tps = zip(*GRID9)
    p = EngineParams.default()
    kw = dict(num_paths=1 << 16, num_bars=40, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
              external_uniforms=None, device=dev)
    sc, sf = cuda_mc.reduce_rows(*cuda_mc.sweep_rows(
        3, _levels(), p, stops, tps, lanes=8192, **kw))
    for g, (sp, tp) in enumerate(GRID9):
        c, f = cuda_mc.reduce_rows(*cuda_mc.first_contact_rows(
            3, _levels(), p.replace(stop_padding=sp, tp_padding=tp), lanes=8192,
            noise=None, antithetic=False, **kw))
        assert torch.equal(c, sc[g]) and torch.equal(f, sf[g]), g
    params, grid, gate_g = _gated_grid()
    noise = _noise_rows([(0.0,) * 4, (0.02, 0.01, 0.015, 0.015), (0.0,) * 4, (0.0,) * 4])
    got = cuda_gated.gated_sweep_rows(3, _levels(), params, grid.stop_padding,
                                      grid.tp_padding, gate_g, lanes=1024, noise=noise,
                                      per_path=True, **kw)
    for g in range(4):
        one = cuda_gated.gated_rows(3, _levels(), grid_row(grid, g),
                                    grid_row(gate_g, g), lanes=1024,
                                    noise=grid_row(noise, g), antithetic=False,
                                    per_path=True, **kw)
        assert all(torch.equal(a, b[g]) for a, b in zip(one, got)), g
    grid = _stack(ENGINE_CFGS)
    got = cuda_engine.engine_sweep_rows(3, _levels(ENGINE_ROWS), grid, lanes=256,
                                        per_path=True, **kw)
    for g in range(4):
        one = cuda_engine.engine_rows(3, _levels(ENGINE_ROWS), ENGINE_CFGS[g], lanes=256,
                                      per_path=True, **kw)
        assert all(torch.equal(a, b[g]) for a, b in zip(one, got)), g
    noise = _noise_rows(CLI_NOISE_ROWS)
    got = cuda_engine.engine_sweep_rows(3, _levels(ENGINE_ROWS), p, n_grid=3, noise=noise,
                                        lanes=256, per_path=True, **kw)
    for g in range(3):
        one = cuda_engine.engine_rows(3, _levels(ENGINE_ROWS), p, noise=grid_row(noise, g),
                                      lanes=256, per_path=True, **kw)
        assert all(torch.equal(a, b[g]) for a, b in zip(one, got)), ("noise", g)
