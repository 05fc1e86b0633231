"""The port's learning flywheel (``sim/flywheel.py``) and its CLI on the CPU:
the cold start and the armed ML gate of round 1, the exploration mix, the
labeled-mass repair held against the JAX package's refresh (where JAX
disarms a refresh on the reweighted mass and the port arms it on the real
closed trades; with reweighting off the two agree), ``holdout_eval``'s rows,
and the ``flywheel`` and ``book --engine --harvest`` commands."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.models import harvest as jHV
from qmmx_monolithic_monte_carlo_tpu.models import online_policy as jOP
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu_torch.sim import flywheel as FW
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_harvest import assert_ml_close

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
LEVELS = Levels.from_rows(ROWS, max_levels=3)
ML_LOW = [r.name for r in EP.SKIP_REASONS].index("ML_CONF_LOW")
KW = dict(num_paths=1 << 11, num_bars=32, sigma=0.3, block_paths=1 << 11, device="cpu")
FKW = dict(KW, backend="torch")      # the flywheel's: the pipeline


@pytest.fixture(scope="module")
def pure():
    return FW.policy_iteration(0, LEVELS, EngineParams.default(), rounds=2, **FKW)


def test_policy_iteration_arms_the_ml_gate_from_round_one(pure):
    """Round 0 is the cold start (no model, no ML_CONF_LOW skip); it refreshes
    a model from its own labels, which round 1 arms and which prunes."""
    r0, r1 = pure
    assert int(r0.skips[ML_LOW]) == 0 and bool(r0.ml_model.present)
    assert int(r1.skips[ML_LOW]) > 0
    assert r0.labeled == int(r0.stats.n_tp + r0.stats.n_stop) > 0
    assert r0.labeled == int(r0.harvest.n_labeled) and r0.explored == 0
    assert float(r1.stats.sum_trades) != float(r0.stats.sum_trades)


def test_explore_mix_restores_pruned_buckets(pure):
    """JAX tests/test_harvest.py:221 on the port: round 0 is untouched, round
    1's labels split into main + explored, and the merged counts dominate the
    pure harvest bucket for bucket, with loss labels added."""
    mixed = FW.policy_iteration(0, LEVELS, EngineParams.default(), rounds=2,
                                explore_paths=1 << 11, explore_reweight=False, **FKW)
    assert pure[0].explored == 0 and mixed[0].explored == 0
    assert torch.equal(pure[0].harvest.ml_counts, mixed[0].harvest.ml_counts)
    assert mixed[1].explored > 0
    assert mixed[1].labeled == pure[1].labeled + mixed[1].explored
    extra = mixed[1].harvest.ml_counts - pure[1].harvest.ml_counts
    assert bool((extra >= 0).all()) and int(extra[:, 0].sum()) > 0


def _harvests(main_scale: int, explore_scale: int):
    """A survivors' harvest and a small exploration harvest (JAX's, integer
    counts, sums of x in [0, 1])."""
    rng = np.random.default_rng(main_scale + explore_scale)

    def one(scale):
        ml = rng.integers(0, scale + 1, (HV.ML_BUCKETS, 2)).astype(np.float32)
        pol = np.zeros((HV.POL_BUCKETS, 2), np.float32)
        per_b = ml.reshape(HV.POL_BUCKETS, -1, 2).sum(axis=1)   # any split of the trades
        pol[:] = per_b
        x1 = (pol * rng.uniform(0.05, 0.4, pol.shape)).astype(np.float32)
        x6 = (pol * rng.uniform(0.0, 1.0, pol.shape)).astype(np.float32)
        return jHV.EngineHarvest(*(jnp.asarray(a) for a in (ml, pol, x1, x6)))

    return one(main_scale), one(explore_scale)


def test_labeled_mass_repair_arms_where_jax_disarms():
    """Plenty of real labels (the survivors' thousands) and a small
    exploration population (~30 trades): JAX's refresh reads the reweighted
    mass (the exploration's size) and leaves the ML gate absent; the port's
    reads the raw merged count and arms it, with JAX's coefficients on the
    same reweighted harvest."""
    main, explore = _harvests(100, 1)
    jmerged = main.merge(explore)
    jrw = jHV.reweight_to_base(jmerged, explore)
    jml = jHV.ml_model_from_harvest(jrw, stop_padding=0.35, min_samples=50)
    assert float(jrw.n_labeled) < 50 <= float(jmerged.n_labeled)
    assert not bool(jml.present)
    fit_hv, labeled, ml, _ = FW.refresh_round(
        HV.EngineHarvest.from_numpy(main), HV.EngineHarvest.from_numpy(explore), None,
        stop_padding=0.35, min_samples=50)
    assert labeled == int(float(jmerged.n_labeled)) and bool(ml.present)
    armed = jHV.ml_model_from_harvest(jrw, stop_padding=0.35, min_samples=0)
    np.testing.assert_allclose(ml.coef.numpy(), np.asarray(armed.coef), rtol=0, atol=1e-5)


def test_labeled_mass_agrees_with_jax_without_reweighting():
    """With reweighting off the merged mass is the raw count: the port's
    refresh equals JAX's (the gate, the labeled count, the ML model and the
    policy heads to 1e-5).  At this mass (~1300) the stop-padding
    coefficient of a float32 fit, a constant beside the intercept, carries
    ~1e-5 of rounding noise on either side, so the ML gate is held on what
    it computes (``assert_ml_close``)."""
    main, explore = _harvests(20, 3)
    jmerged = main.merge(explore)
    jml = jHV.ml_model_from_harvest(jmerged, stop_padding=0.35, min_samples=50)
    jpol = jHV.policy_from_harvest(jOP.PolicyParams.init(), jmerged, min_samples=25)
    fit_hv, labeled, ml, pol = FW.refresh_round(
        HV.EngineHarvest.from_numpy(main), HV.EngineHarvest.from_numpy(explore), None,
        stop_padding=0.35, min_samples=50, explore_reweight=False)
    assert labeled == int(float(jmerged.n_labeled))
    assert bool(ml.present) == bool(jml.present)
    assert_ml_close(ml, jml, raw=False)
    np.testing.assert_allclose(pol.w_entry.numpy(), np.asarray(jpol.w_entry), rtol=0,
                               atol=1e-5)


def test_holdout_eval_rows():
    """JAX tests/test_harvest.py:197 on the port: one eval population for
    every arm (the disarmed row is a direct run on the eval seed), the
    trained arm armed and pruning; the exact tail is not ported yet."""
    train, rows = FW.holdout_eval(0, 4242, LEVELS, EngineParams.default(), rounds=1,
                                  eval_paths=1 << 11, **FKW)
    assert len(train) == 1 and [r["arm"] for r in rows] == ["disarmed", "round0"]
    base, armed = rows
    assert not base["ml_armed"] and base["skips_ml"] == 0
    stats, _, _ = EP.mc_paths_engine(4242, LEVELS, EngineParams.default(), **KW)
    assert base["trades"] == float(stats.sum_trades)
    assert base["mean_r"] == float(stats.mean_r)
    assert armed["ml_armed"] and armed["skips_ml"] > 0
    assert set(base) == {"arm", "ml_armed", "policy_armed", "paths", "trades",
                         "expectancy_r", "mean_r", "hit_rate", "mean_dd", "escalations",
                         "var_05", "cvar_05", "skips_ml", "skips_policy"}
    with pytest.raises(NotImplementedError, match="not ported yet"):
        FW.holdout_eval(0, 1, LEVELS, EngineParams.default(), exact_tail=True, **FKW)
    # the backend is the caller's, resolved: the kernel or the pipeline
    with pytest.raises(ValueError, match="cuda or torch"):
        FW.holdout_eval(0, 1, LEVELS, EngineParams.default(), **dict(KW, backend="auto"))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        FW.policy_iteration(0, LEVELS, EngineParams.default(), **dict(KW, backend="cuda"))


def _cli(tmp_path, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--db", str(tmp_path / "t.db"), *argv])
    return rc, [json.loads(x) for x in buf.getvalue().strip().splitlines()]


def test_cli_flywheel_rows(tmp_path):
    rc, rows = _cli(tmp_path, "flywheel", "--device", "cpu", "--rounds", "2", "--num-paths",
                    "2048", "--num-bars", "32", "--explore-paths", "1024")
    assert rc == 0 and [r["round"] for r in rows] == [0, 1]
    assert list(rows[0]) == ["round", "labeled", "explored", "hit_rate", "mean_r", "trades",
                             "escalations", "ml_present", "skips"]
    assert "ML_CONF_LOW" not in rows[0]["skips"] and rows[1]["skips"]["ML_CONF_LOW"] > 0
    assert rows[0]["explored"] == 0 and rows[1]["explored"] > 0
    assert rows[1]["labeled"] > rows[1]["explored"]
    with pytest.raises(SystemExit, match="--device cuda"):
        _cli(tmp_path, "flywheel", "--device", "cpu", "--backend", "cuda")
    # the kernel's shape rule (host/cli._fits) covers the exploration too
    args = cli.build_parser().parse_args(["flywheel", "--explore-paths", "1024"])
    assert "--explore-paths" in cli._fits(args, ROWS)


def test_cli_book_engine_harvest(tmp_path):
    rc, rows = _cli(tmp_path, "book", "--engine", "--harvest", "--device", "cpu",
                    "--backend", "torch", "--num-symbols", "2", "--num-paths", "1024",
                    "--num-bars", "16")
    assert rc == 0 and len(rows) == 3 and rows[2]["portfolio"] is True
    for r in rows[:2]:
        assert r["labeled"] > 0 and len(r["ml_coef"]) == 4
        assert all(np.isfinite(r["ml_coef"]))
