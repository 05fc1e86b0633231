"""The port's closed-trade label harvest (``models/harvest.py``) held against
the JAX package's on the same numpy inputs: the fold of a bar's closes, the
packed row, the reweighting, the [S] refresh batch (exact), and the ML-gate
and policy-head refreshes (coefficients to 1e-5, the ``min_samples`` gate
equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.models import harvest as jHV
from qmmx_monolithic_monte_carlo_tpu.models import online_policy as jOP
from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV
from qmmx_monolithic_monte_carlo_tpu_torch.models.online_policy import PolicyParams

torch.set_num_threads(2)


def _random_harvest(seed, lead=(), scale=40, zero_frac=0.3):
    """A JAX EngineHarvest of random integer counts (some buckets empty) and
    sums of x in [0, 1] per count."""
    rng = np.random.default_rng(seed)
    ml = rng.integers(0, scale, lead + (HV.ML_BUCKETS, 2)).astype(np.float32)
    ml *= rng.uniform(size=ml.shape) > zero_frac
    pol = rng.integers(0, 4 * scale, lead + (HV.POL_BUCKETS, 2)).astype(np.float32)
    pol *= rng.uniform(size=pol.shape) > zero_frac / 2
    x1 = (pol * rng.uniform(0.05, 0.5, pol.shape)).astype(np.float32)
    x6 = (pol * rng.uniform(0.0, 1.0, pol.shape)).astype(np.float32)
    return jHV.EngineHarvest(*(jnp.asarray(a) for a in (ml, pol, x1, x6)))


def _equal(port: HV.EngineHarvest, jax_h) -> None:
    for a, b in zip(port.numpy(), jax_h):
        np.testing.assert_array_equal(a.astype(np.float64), np.asarray(b, np.float64))


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_harvest_closed_matches_jax(seed, dyadic):
    """Counts exact; the sums exact where every order is exact (x on a 2^-10
    grid), else within 1e-6 relative (the reduction orders differ)."""
    rng = np.random.default_rng(seed)
    p = 512
    closed = rng.uniform(size=p) < 0.4
    label = rng.uniform(size=p) < 0.55
    pend_ml = rng.integers(0, HV.ML_BUCKETS, p).astype(np.int32)
    pend_pol = rng.integers(0, HV.POL_BUCKETS, p).astype(np.int32)
    x1, x6 = rng.uniform(0, 1, (2, p)).astype(np.float32)
    if dyadic:
        x1, x6 = (np.round(x * 1024) / 1024 for x in (x1, x6))
    start = _random_harvest(seed + 10)
    want = jHV.harvest_closed(start, closed=jnp.asarray(closed), label_pos=jnp.asarray(label),
                              pend_ml=jnp.asarray(pend_ml), pend_pol=jnp.asarray(pend_pol),
                              pend_x1=jnp.asarray(x1), pend_x6=jnp.asarray(x6))
    got = HV.harvest_closed(HV.EngineHarvest.from_numpy(start), closed=torch.from_numpy(closed),
                            label_pos=torch.from_numpy(label), pend_ml=torch.from_numpy(pend_ml),
                            pend_pol=torch.from_numpy(pend_pol), pend_x1=torch.from_numpy(x1),
                            pend_x6=torch.from_numpy(x6))
    assert got.ml_counts.dtype == torch.int64
    np.testing.assert_array_equal(got.ml_counts.numpy(), np.asarray(want.ml_counts))
    np.testing.assert_array_equal(got.pol_counts.numpy(), np.asarray(want.pol_counts))
    for a, b in ((got.pol_sum_x1, want.pol_sum_x1), (got.pol_sum_x6, want.pol_sum_x6)):
        if dyadic:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_row_and_from_acc_row_match_jax(lead):
    jh = _random_harvest(2, lead)
    h = HV.EngineHarvest.from_numpy(jh)
    np.testing.assert_array_equal(h.pack_row().numpy(), np.asarray(jh.pack_row(), np.float64))
    assert h.pack_row().shape == lead + (HV.HARVEST_COLS,)
    _equal(HV.EngineHarvest.from_acc_row(h.pack_row()), jHV.EngineHarvest.from_acc_row(
        jh.pack_row()))
    _equal(HV.EngineHarvest.from_acc_row(torch.from_numpy(np.array(jh.pack_row()))), jh)
    np.testing.assert_array_equal(h.n_labeled.numpy(), np.asarray(jh.n_labeled))
    # the kernels' columns: 72 int64 counts, 16 sums
    cols = h.pack_row()
    back = HV.EngineHarvest.from_columns(cols[..., :HV.COUNT_COLS].to(torch.int64),
                                         cols[..., HV.COUNT_COLS:])
    _equal(back, jh)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_reweight_to_base_matches_jax(seed):
    merged, base = _random_harvest(seed), _random_harvest(seed + 100, scale=10, zero_frac=0.5)
    want = jHV.reweight_to_base(merged, base)
    got = HV.reweight_to_base(HV.EngineHarvest.from_numpy(merged),
                              HV.EngineHarvest.from_numpy(base))
    _equal(got, want)


def test_ml_batch_from_harvest_matches_jax():
    jh = _random_harvest(6, (4,))
    want = jHV.ml_batch_from_harvest(jh, stop_padding=0.35)
    got = HV.ml_batch_from_harvest(HV.EngineHarvest.from_numpy(jh), stop_padding=0.35)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def assert_ml_close(got, want, stop_padding: float = 0.35, raw: bool = True) -> None:
    """Two ML gates within 1e-5 on what they compute: the coefficients of
    kind, touch count and direction, and the logit offset intercept +
    stop_padding x the stop-padding coefficient (the stop-padding feature is
    the constant stop padding, beside the unpenalized intercept: only that
    sum is identified).  ``raw``: also the intercept and every coefficient
    on its own, where the fit is well enough conditioned for float32."""
    g, w = got.coef.numpy().astype(np.float64), np.asarray(want.coef, np.float64)
    np.testing.assert_allclose(g[[0, 2, 3]], w[[0, 2, 3]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.intercept) + stop_padding * g[1],
                               float(want.intercept) + stop_padding * w[1], rtol=0, atol=1e-5)
    if raw:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(got.intercept), float(want.intercept), rtol=0,
                                   atol=1e-5)


# (seed, count scale, min_samples, raw): a small harvest under the gate, the
# usual, one past the weight-mass cap.  At the cap's mass (1e5) the Hessian's
# condition along the stop padding / intercept direction is ~1e5: both
# float32 fits (JAX's default float, the port's) carry ~1e-4 of rounding
# noise on those two on either side, so that case holds only their
# identified sum (``assert_ml_close``).
ML_CASES = {"gated": (7, 1, 5000, True), "usual": (8, 40, 50, True),
            "capped": (9, 40000, 50, False)}


@pytest.mark.parametrize("case", list(ML_CASES))
def test_ml_model_from_harvest_matches_jax(case):
    seed, scale, min_samples, raw = ML_CASES[case]
    jh = _random_harvest(seed, scale=scale)
    want = jHV.ml_model_from_harvest(jh, stop_padding=0.35, min_samples=min_samples)
    got = HV.ml_model_from_harvest(HV.EngineHarvest.from_numpy(jh), stop_padding=0.35,
                                   min_samples=min_samples)
    assert bool(got.present) == bool(want.present)
    assert_ml_close(got, want, raw=raw)
    # the gate reads n_labeled when given (the real closed-trade count)
    flipped = HV.ml_model_from_harvest(HV.EngineHarvest.from_numpy(jh), stop_padding=0.35,
                                       min_samples=min_samples,
                                       n_labeled=0 if bool(want.present) else 10 ** 9)
    assert bool(flipped.present) != bool(want.present)


@pytest.mark.parametrize("min_samples", [1, 10 ** 6])
@pytest.mark.parametrize("seed", [11, 12])
def test_policy_from_harvest_matches_jax(seed, min_samples):
    jh = _random_harvest(seed)
    rng = np.random.default_rng(seed)
    w0 = rng.normal(0, 0.3, (3, 7)).astype(np.float32)
    jpol = jOP.PolicyParams.init().replace(w_entry=jnp.asarray(w0))
    pol = PolicyParams.from_numpy({k: np.asarray(v) for k, v in vars(jpol).items()})
    want = jHV.policy_from_harvest(jpol, jh, min_samples=min_samples)
    got = HV.policy_from_harvest(pol, HV.EngineHarvest.from_numpy(jh), min_samples=min_samples)
    np.testing.assert_allclose(got.w_entry.numpy(), np.asarray(want.w_entry), rtol=0, atol=1e-5)
    if min_samples > 1:     # both heads gated: the policy is unchanged
        np.testing.assert_array_equal(got.w_entry.numpy(), w0)
