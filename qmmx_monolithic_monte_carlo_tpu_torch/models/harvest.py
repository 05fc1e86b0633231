"""Per-trade label harvest: the reference's learning flywheel at path scale.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/models/harvest.py:1-326``, a
JAX-free copy.  In the reference every trade labels its policy event by pnl
sign on close (qmmx_monolithic.py:1934-1945); the labeled stream retrains the
OnlinePolicy (:3753-3803) and the contact-trade join feeds the batch LR
(:3833-3894).  At path scale every CLOSED simulated trade contributes one
example, label ``pnl > 0``, with its features latched at its ENTRY bar, and
the harvest is a set of exact sufficient statistics:

* the ML gate's 4 features ``[kind, |level - stop|, touch_count, direction]``
  are discrete at entry (``|level - stop|`` is the stop padding), so a count
  per ``(touch_count, kind, direction, label)`` bucket is exact:
  ``ml_counts[TC_CAP * 4 buckets, 2 labels]``;
* the OnlinePolicy entry head's vector is ``[1, min(1, dist), 0, 1 - glf,
  glf, confl, min(1, minutes / 390)]``: the bucket ``(glf, confl)`` with the
  two continuous coordinates summed per bucket (count, Σx1, Σx6).

Counts are int64 (the JAX harvest keeps them as float32, exact only to
2^24); Σx1 and Σx6 are float32.  A reweighted harvest (``reweight_to_base``)
holds float32 counts, as JAX's does.  The fits cast the counts to their
float dtype.

``ml_model_from_harvest`` replays the batch retrain (:3833-3853) as a
weighted IRLS fit (``models/logistic.fit``, sample weight = bucket count)
behind the ``min_samples`` gate (:3838-3840); ``policy_from_harvest`` fits
the go_long / go_short entry heads on the bucket-mean rows.  Both gates read
the harvest's own mass unless ``n_labeled`` names the real closed-trade
count (``sim/flywheel`` passes it: a reweighted mass counts the exploration
population, not the trades).  The fits run in float32, JAX's default
float.

The CUDA kernels (``ops/csrc/mc_engine_wide*_harvest.cu``) tally the same
statistics; ``EngineHarvest.from_columns`` takes their [..., 72] int64 counts
and [..., 16] float sums.  Determinism: the counts are exact in any order, so
the ML gate's refresh is a function of the trades alone; the sums are float32
and their last bits follow the reduction order, so the policy heads (which
threshold the bucket-mean x1 and x6) can move by float32 ulps between
reduction orders.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..engine.state import MlModel
from . import logistic
from .online_policy import A_GO_LONG, A_GO_SHORT, PolicyParams

TC_CAP = 8                       # touch-count clamp of the ML bucket axis
ML_BUCKETS = TC_CAP * 4          # (tc, kind, glf) -> tc*4 + kind*2 + glf
POL_BUCKETS = 4                  # (glf, confl)    -> glf*2 + confl

# the packed row (JAX's accumulator row):
#   cols 0..63   ml_counts[b, label] at col b*2 + label
#   cols 64..71  pol_counts[b, label] at col 64 + b*2 + label
#   cols 72..79  pol Σx1, same order
#   cols 80..87  pol Σx6, same order
HARVEST_COLS = 2 * ML_BUCKETS + 3 * 2 * POL_BUCKETS
COUNT_COLS = 2 * ML_BUCKETS + 2 * POL_BUCKETS      # 72 int64 columns
SUM_COLS = 2 * 2 * POL_BUCKETS                     # 16 float32 columns

_F32, _I64 = torch.float32, torch.int64


class EngineHarvest(NamedTuple):
    """Sufficient statistics of the closed-trade label stream (leading axes
    broadcast, e.g. [S] for a universe's symbols)."""

    ml_counts: torch.Tensor   # int64[..., ML_BUCKETS, 2]  (bucket, label)
    pol_counts: torch.Tensor  # int64[..., POL_BUCKETS, 2]
    pol_sum_x1: torch.Tensor  # f32[..., POL_BUCKETS, 2]  Σ min(1, dist)
    pol_sum_x6: torch.Tensor  # f32[..., POL_BUCKETS, 2]  Σ min(1, minutes / 390)

    @classmethod
    def zero(cls, *lead, device=None) -> "EngineHarvest":
        return cls(
            ml_counts=torch.zeros(lead + (ML_BUCKETS, 2), dtype=_I64, device=device),
            pol_counts=torch.zeros(lead + (POL_BUCKETS, 2), dtype=_I64, device=device),
            pol_sum_x1=torch.zeros(lead + (POL_BUCKETS, 2), dtype=_F32, device=device),
            pol_sum_x6=torch.zeros(lead + (POL_BUCKETS, 2), dtype=_F32, device=device))

    def merge(self, other: "EngineHarvest") -> "EngineHarvest":
        return EngineHarvest(*(a + b for a, b in zip(self, other)))

    @property
    def n_labeled(self) -> torch.Tensor:
        """Total closed-trade examples harvested."""
        return self.ml_counts.sum(dim=(-2, -1))

    def to(self, device) -> "EngineHarvest":
        return EngineHarvest(*(x.to(device) for x in self))

    def pack_row(self) -> torch.Tensor:
        """The (..., HARVEST_COLS) row of JAX's layout, float64 (int64 counts
        below 2^53 and float32 sums convert exactly)."""
        lead = self.ml_counts.shape[:-2]
        return torch.cat([x.reshape(lead + (-1,)).to(torch.float64) for x in self], dim=-1)

    @classmethod
    def from_acc_row(cls, row) -> "EngineHarvest":
        """Unpack a (..., >= HARVEST_COLS) row of JAX's layout: counts
        rounded to int64, sums as float32."""
        row = torch.as_tensor(row)
        lead = row.shape[:-1]
        o1 = 2 * ML_BUCKETS
        o2 = o1 + 2 * POL_BUCKETS
        o3 = o2 + 2 * POL_BUCKETS
        o4 = o3 + 2 * POL_BUCKETS

        def counts(x):
            return torch.round(x.to(torch.float64)).to(_I64) if x.is_floating_point() \
                else x.to(_I64)

        return cls(
            ml_counts=counts(row[..., :o1]).reshape(lead + (ML_BUCKETS, 2)),
            pol_counts=counts(row[..., o1:o2]).reshape(lead + (POL_BUCKETS, 2)),
            pol_sum_x1=row[..., o2:o3].to(_F32).reshape(lead + (POL_BUCKETS, 2)),
            pol_sum_x6=row[..., o3:o4].to(_F32).reshape(lead + (POL_BUCKETS, 2)))

    @classmethod
    def from_columns(cls, counts: torch.Tensor, sums: torch.Tensor) -> "EngineHarvest":
        """From the kernels' columns: int64 [..., COUNT_COLS] (ml then pol
        counts) and float [..., SUM_COLS] (Σx1 then Σx6), summed in any float
        dtype and rounded once to float32."""
        lead = counts.shape[:-1]
        m = 2 * ML_BUCKETS
        return cls(
            ml_counts=counts[..., :m].to(_I64).reshape(lead + (ML_BUCKETS, 2)),
            pol_counts=counts[..., m:].to(_I64).reshape(lead + (POL_BUCKETS, 2)),
            pol_sum_x1=sums[..., :2 * POL_BUCKETS].to(_F32).reshape(lead + (POL_BUCKETS, 2)),
            pol_sum_x6=sums[..., 2 * POL_BUCKETS:].to(_F32).reshape(lead + (POL_BUCKETS, 2)))

    @classmethod
    def from_numpy(cls, h, device=None) -> "EngineHarvest":
        """A JAX ``EngineHarvest`` (its leaves as numpy arrays, or the JAX
        object itself) as the port's: float32 counts rounded to int64."""
        leaves = [np.asarray(x) for x in h]
        return cls(*(torch.as_tensor(np.rint(x).astype(np.int64) if i < 2
                                     else x.astype(np.float32), device=device)
                     for i, x in enumerate(leaves)))

    def numpy(self) -> tuple:
        return tuple(x.detach().cpu().numpy() for x in self)


def stack(hs, dim: int = 0) -> EngineHarvest:
    """Harvests of equal shape stacked along a new axis ``dim``."""
    return EngineHarvest(*(torch.stack(f, dim) for f in zip(*hs)))


def reweight_to_base(merged: EngineHarvest, base: EngineHarvest) -> EngineHarvest:
    """Importance-reweight a survivors + exploration merge to the BASE
    (gates-off) bucket distribution (JAX ``reweight_to_base``, harvest.py:121):
    each bucket's counts and feature sums scale to the exploration harvest's
    bucket totals, keeping the merged per-bucket label proportions and
    bucket-mean features; buckets the exploration never reached get weight 0.
    float32, in JAX's order of operations; the counts come out float32."""
    def tot(x):
        return x.to(_F32).sum(dim=-1, keepdim=True)

    def scale(m, b):
        m_tot, b_tot = tot(m), tot(b)
        return torch.where(m_tot > 0, b_tot / torch.clamp(m_tot, min=1.0),
                           torch.zeros((), dtype=_F32, device=m.device))

    ml_scale = scale(merged.ml_counts, base.ml_counts)
    p_scale = scale(merged.pol_counts, base.pol_counts)   # counts and Σx together
    return EngineHarvest(
        ml_counts=merged.ml_counts.to(_F32) * ml_scale,
        pol_counts=merged.pol_counts.to(_F32) * p_scale,
        pol_sum_x1=merged.pol_sum_x1 * p_scale,
        pol_sum_x6=merged.pol_sum_x6 * p_scale)


def ml_bucket(touch_count, kind_solid, go_long) -> torch.Tensor:
    """ML-gate bucket index: tc*4 + kind*2 + glf, tc clamped to TC_CAP-1."""
    tc = torch.clamp(torch.as_tensor(touch_count).to(torch.int32), 0, TC_CAP - 1)
    k = torch.as_tensor(kind_solid).to(torch.int32)
    g = torch.as_tensor(go_long).to(torch.int32)
    return tc * 4 + k * 2 + g


def pol_bucket(go_long, confluence) -> torch.Tensor:
    """Policy bucket index: glf*2 + confl."""
    return (torch.as_tensor(go_long).to(torch.int32) * 2
            + torch.as_tensor(confluence).to(torch.int32))


def harvest_closed(h: EngineHarvest, *, closed, label_pos, pend_ml, pend_pol, pend_x1,
                   pend_x6) -> EngineHarvest:
    """Fold one bar's closed trades ([P] masks / indices) into the harvest:
    ``pend_*`` are the entry-time bucket indices and continuous coordinates
    latched while each position was open; ``label_pos`` is pnl > 0
    (:1934-1945).  Counts exact (int64 scatter-adds); the sums add the bar's
    one-hot rows in float32, as JAX does.  Nothing waits on the device."""
    closed = torch.as_tensor(closed)
    lab = torch.as_tensor(label_pos).to(_I64)
    one = closed.to(_I64)
    ml_idx = torch.as_tensor(pend_ml).to(_I64) * 2 + lab
    pol_all = torch.as_tensor(pend_pol).to(_I64) * 2 + lab
    ml = torch.zeros(2 * ML_BUCKETS, dtype=_I64, device=one.device).scatter_add_(0, ml_idx, one)
    pol = torch.zeros(2 * POL_BUCKETS, dtype=_I64, device=one.device).scatter_add_(
        0, pol_all, one)
    oh = ((pol_all[:, None] == torch.arange(2 * POL_BUCKETS, device=pol_all.device))
          & closed[:, None]).to(_F32)
    return EngineHarvest(
        ml_counts=h.ml_counts + ml.reshape(ML_BUCKETS, 2),
        pol_counts=h.pol_counts + pol.reshape(POL_BUCKETS, 2),
        pol_sum_x1=h.pol_sum_x1 + (oh * torch.as_tensor(pend_x1, dtype=_F32)[:, None])
        .sum(0).reshape(POL_BUCKETS, 2),
        pol_sum_x6=h.pol_sum_x6 + (oh * torch.as_tensor(pend_x6, dtype=_F32)[:, None])
        .sum(0).reshape(POL_BUCKETS, 2))


def _ml_bucket_features(stop_padding, device=None) -> torch.Tensor:
    """The exact 4-dim serving features of every ML bucket (:1457-1461):
    [kind_solid, |level - stop| = stop_padding, touch_count, go_long],
    f32[ML_BUCKETS, 4]."""
    b = torch.arange(ML_BUCKETS, device=device)
    tc = (b // 4).to(_F32)
    kind = ((b // 2) % 2).to(_F32)
    glf = (b % 2).to(_F32)
    pad = torch.full((ML_BUCKETS,), float(stop_padding), dtype=_F32, device=device)
    return torch.stack([kind, pad, tc, glf], dim=1)


# Billion-path harvests give count masses ~1e8+: against the fixed L2 (C=1)
# the data term then dwarfs the penalty and near-separable bucket sets drive
# unbounded Newton steps.  Refreshes above this mass rescale the weights to
# it: the same label proportions, a numerically meaningful penalty.
WEIGHT_MASS_CAP = 1.0e5


def _capped(w: torch.Tensor):
    tot = w.sum()
    scale = torch.where(tot > WEIGHT_MASS_CAP, WEIGHT_MASS_CAP / tot,
                        torch.ones((), dtype=w.dtype, device=w.device))
    return w * scale, tot


def ml_model_from_harvest(h: EngineHarvest, *, stop_padding, min_samples: int = 50,
                          c: float = 1.0, max_iter: int = 100, n_labeled=None) -> MlModel:
    """The batch-LR retrain (:3833-3853) on harvested counts: weighted IRLS
    on the exact bucket features, fitted on the harvest's device.  Below
    ``min_samples`` labeled trades the model stays absent (:3838-3840).  The
    gate reads ``n_labeled`` when given (the real closed-trade count), else
    the harvest's own mass, as JAX's does."""
    dev = h.ml_counts.device
    feats = _ml_bucket_features(stop_padding, dev)
    x = torch.cat([feats, feats], dim=0)                    # label-0 rows, label-1
    y = torch.cat([torch.zeros(ML_BUCKETS, dtype=_F32, device=dev),
                   torch.ones(ML_BUCKETS, dtype=_F32, device=dev)])
    w, tot = _capped(torch.cat([h.ml_counts[:, 0], h.ml_counts[:, 1]]).to(_F32))
    m = logistic.fit(x, y, sample_weight=w, c=c, max_iter=max_iter)
    mass = float(tot) if n_labeled is None else float(n_labeled)
    ok = (mass >= min_samples
          and bool(torch.isfinite(m.coef).all()) and bool(torch.isfinite(m.intercept)))
    if not ok:
        return MlModel.absent().to(dev)
    return MlModel(coef=m.coef, intercept=m.intercept,
                   n_features=torch.tensor(4, dtype=torch.int32, device=dev),
                   present=torch.tensor(True, device=dev))


def _pol_bucket_features(h: EngineHarvest):
    """Bucket-mean 6-dim rows (the fit's intercept is the bias): [x1 mean,
    vol_trend = 0, from_above, from_below, confl, x6 mean] per (bucket,
    label), with the matching labels, counts and glf."""
    dev = h.pol_counts.device
    cnt = h.pol_counts.reshape(-1).to(_F32)
    safe = torch.clamp(cnt, min=1.0)
    x1 = h.pol_sum_x1.reshape(-1) / safe
    x6 = h.pol_sum_x6.reshape(-1) / safe
    b = torch.arange(POL_BUCKETS, device=dev).repeat_interleave(2)
    glf = (b // 2).to(_F32)
    confl = (b % 2).to(_F32)
    feats = torch.stack([x1, torch.zeros_like(x1), 1.0 - glf, glf, confl, x6], dim=1)
    labels = torch.arange(2, device=dev).repeat(POL_BUCKETS).to(_F32)
    return feats, labels, cnt, glf


def ml_batch_from_harvest(h: EngineHarvest, *, stop_padding):
    """An [S]-batched harvest as the (xs [S, 2B, 4], ys [S, 2B], w [S, 2B])
    of ``parallel.universe.universe_policy_refresh`` / ``logistic.fit_batched``:
    each symbol's weighted bucket rows.  BASELINE config #4's per-symbol LR
    refresh trains on this (harvested simulation output)."""
    counts = h.ml_counts
    s, dev = counts.shape[0], counts.device
    feats = _ml_bucket_features(stop_padding, dev)
    xs = torch.cat([feats, feats], dim=0)[None].expand(s, 2 * ML_BUCKETS, 4)
    ys = torch.cat([torch.zeros(ML_BUCKETS, dtype=_F32, device=dev),
                    torch.ones(ML_BUCKETS, dtype=_F32, device=dev)])[None].expand(
                        s, 2 * ML_BUCKETS)
    w = torch.cat([counts[:, :, 0], counts[:, :, 1]], dim=1).to(_F32)
    return xs, ys, w


def policy_from_harvest(policy: PolicyParams, h: EngineHarvest, *, min_samples: int = 1,
                        c: float = 1.0, max_iter: int = 100,
                        n_labeled=None) -> PolicyParams:
    """Refresh the entry go_long / go_short heads from harvested labels (the
    incremental pass :3753-3803): each head a weighted logistic fit on its
    own bucket-mean rows.  A head with fewer than ``min_samples`` events
    keeps its weights: its events are ``n_labeled`` = (go_long, go_short)
    real closed-trade counts when given, else its harvest mass, as JAX's
    reads it.  The skip and exit heads are never trade-labeled and stay."""
    feats, labels, cnt, glf = _pol_bucket_features(h)
    w_entry = policy.w_entry.clone()
    zero = torch.zeros((), dtype=cnt.dtype, device=cnt.device)
    for i, (action, sel) in enumerate(((A_GO_LONG, 1.0), (A_GO_SHORT, 0.0))):
        w, tot = _capped(torch.where(glf.to(cnt.device) == sel, cnt, zero))
        m = logistic.fit(feats, labels, sample_weight=w, c=c, max_iter=max_iter)
        vec = torch.cat([m.intercept.reshape(1), m.coef])
        mass = float(tot) if n_labeled is None else float(n_labeled[i])
        if mass >= min_samples and bool(torch.isfinite(vec).all()):
            w_entry[action] = vec.to(w_entry.device)
    return policy.replace(w_entry=w_entry)

