"""Port types/config/McNoise held against the JAX package's, and the port's
import boundary (no JAX)."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu import config as jconfig
from qmmx_monolithic_monte_carlo_tpu import types as jtypes
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu_torch import config as tconfig
from qmmx_monolithic_monte_carlo_tpu_torch import types as ttypes
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

torch.set_num_threads(2)

ROWS = [
    {"color": "teal", "type": "solid", "index": 0, "price": 99.7},
    {"color": "blue", "type": "solid", "index": 1, "price": 100.0},
    {"color": "blue", "type": "dashed", "index": 0, "price": 100.4},
    {"color": "orange", "type": "dashed", "index": 2, "price": 101.25},
]


def _np_fields(obj) -> dict:
    return {k: np.asarray(v) for k, v in vars(obj).items()}


def _assert_same(port, jax_obj):
    for f in dataclasses.fields(port):
        got = getattr(port, f.name)
        want = np.asarray(getattr(jax_obj, f.name))
        if torch.is_tensor(got):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
            assert got.numpy().dtype == want.dtype, f.name
        else:
            assert got == want, f.name


@pytest.mark.parametrize("max_levels", [4, 8, 64])
def test_levels_from_numpy_equals_from_rows(max_levels):
    jl = jtypes.Levels.from_rows(ROWS, max_levels=max_levels)
    via_jax = ttypes.Levels.from_numpy(_np_fields(jl))
    own = ttypes.Levels.from_rows(ROWS, max_levels=max_levels)
    _assert_same(via_jax, jl)
    _assert_same(own, jl)
    assert own.max_levels == max_levels
    assert int(own.count) == len(ROWS)
    assert own.to_rows() == jl.to_rows()


def test_levels_rejects_overflow():
    with pytest.raises(ValueError):
        ttypes.Levels.from_rows(ROWS, max_levels=3)


@pytest.mark.parametrize("overrides", [
    {}, {"contact_prox": 0.07, "stop_padding": 0.5, "enable_veto": False,
         "overtouch_limit": 6, "stale_ms": 9000}])
def test_engine_params_match_jax(overrides):
    jp = jconfig.EngineParams.default(**overrides)
    _assert_same(tconfig.EngineParams.from_numpy(_np_fields(jp)), jp)
    _assert_same(tconfig.EngineParams.default(**overrides), jp)


def test_engine_params_from_settings_match_jax():
    store = {"CONTACT_PROX": "0.08", "Q_MIN_PROB": "65", "USE_BLEND": "1",
             "W_RULES": "", "STOP_PADDING": "0.4"}

    def get(k, d=None):
        return store.get(k, d)

    jp = jconfig.EngineParams.from_settings(get)
    _assert_same(tconfig.EngineParams.from_settings(get), jp)


def test_engine_params_replace():
    p = tconfig.EngineParams.default().replace(q_min_prob=0.7)
    assert p.q_min_prob.dtype == torch.float32
    assert float(p.q_min_prob) == pytest.approx(0.7)


@pytest.mark.parametrize("stds", [None, (0.02, 0.01, 0.015, 0.005)])
def test_mcnoise_from_numpy_equals_make(stds):
    if stds is None:
        jn, tn = JMcNoise.default(), McNoise.default()
    else:
        kw = dict(level_jitter_std=stds[0], entry_slip_std=stds[1],
                  stop_slip_std=stds[2], target_slip_std=stds[3])
        jn, tn = JMcNoise.make(**kw), McNoise.make(**kw)
    _assert_same(McNoise.from_numpy(_np_fields(jn)), jn)
    _assert_same(tn, jn)


def test_settings_defaults_match():
    assert tconfig.SETTINGS_DEFAULTS == jconfig.SETTINGS_DEFAULTS


@pytest.mark.parametrize("raw", ["0.6", "65", 0.42, "abc", None, "150", "-1",
                                 "0.99", "1.0", "99"])
def test_parse_prob_threshold_matches(raw):
    assert tconfig.parse_prob_threshold(raw) == jconfig.parse_prob_threshold(raw)


def test_compat_flags_match():
    for make in ("__call__", "strict_reference_quirks"):
        t = tconfig.CompatFlags() if make == "__call__" else \
            tconfig.CompatFlags.strict_reference_quirks()
        j = jconfig.CompatFlags() if make == "__call__" else \
            jconfig.CompatFlags.strict_reference_quirks()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_enum_constants_match():
    for name in ("COLORS", "KINDS", "KIND_SOLID", "KIND_DASHED", "SIDE_LONG",
                 "SIDE_SHORT", "SIDE_FLAT", "DIR_UP", "DIR_DOWN",
                 "APPROACH_FROM_ABOVE", "APPROACH_FROM_BELOW", "OUTCOME_OPEN",
                 "OUTCOME_TP", "OUTCOME_STOP"):
        assert getattr(ttypes, name) == getattr(jtypes, name), name


def test_bars_from_rows_match():
    rows = [{"t": 60_000 * i + 5, "o": 100 + i, "h": 101 + i, "l": 99 + i,
             "c": 100.5 + i, "v": 10 * i} for i in range(6)]
    _assert_same(ttypes.Bars.from_rows(rows, epoch_ms=5),
                 jtypes.Bars.from_rows(rows, epoch_ms=5))


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    without pulling in JAX, flax or the JAX package, and builds no kernel."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import qmmx_monolithic_monte_carlo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from qmmx_monolithic_monte_carlo_tpu_torch.utils import build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax',\n"
        "       'qmmx_monolithic_monte_carlo_tpu')]\n"
        "assert not bad, bad\n"
        "assert not build._LOADED\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the modules of slices 1-3 at least, engine and models packages included
    assert int(out.stdout.strip()) >= 30


def test_chip_smoke_imports_no_jax():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parent.parent / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "flax", "qmmx_monolithic_monte_carlo_tpu"}, roots
    assert "qmmx_monolithic_monte_carlo_tpu_torch" in roots
