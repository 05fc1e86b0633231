"""The closed learning loop at path scale: simulate -> label -> retrain -> re-simulate.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/sim/flywheel.py:1-268``
(``FlywheelRound``, ``policy_iteration``, ``holdout_eval``).  In the
reference every closed trade labels its policy event by pnl sign
(qmmx_monolithic.py:1934-1945), the labeled stream retrains the OnlinePolicy
(:3753-3803) and the contact-trade join feeds the batch LR (:3833-3894).
Each round here runs the full-engine MC with the label harvest on (the CUDA
kernel, ``ops/cuda_engine.mc_paths_engine_fused``, or the streamed PyTorch
pipeline, ``sim/enginepath.mc_paths_engine``), refreshes the ML gate
(``models/harvest.ml_model_from_harvest``) and the OnlinePolicy entry heads
(``policy_from_harvest``), then re-simulates with the refreshed models armed.

Where the port parts from JAX: a round's ``labeled`` is the raw closed-trade
count of the merged harvest (survivors plus exploration), and the refresh
gates (``min_samples``) read it.  JAX reports and gates on the REWEIGHTED
mass under ``explore_reweight`` (flywheel.py:142-159), which counts the
exploration population's size, not the trades, so a small ``explore_paths``
could disarm a refresh that had plenty of real labels.  Without reweighting
the two are the same number.

Backends: ``cuda`` (the default) launches the kernel on ``device`` (a CUDA
device) and raises where the shape does not fit it, ``torch`` runs the
pipeline on ``device``; the device is the caller's (``utils/device.resolve``:
the card by default).  The CLI picks between the two (``host/cli._backend``).
Round r's draws are keyed by the port's Philox seed ``seed +
7919 r`` (an exploration population's ``+ 104729``), so they agree with the
JAX flywheel's statistically, not bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import EngineParams
from ..engine.state import MlModel
from ..models import harvest as HV
from ..models import online_policy as OP
from ..ops.kernel_args import MAX_ENGINE_LEVELS, check_blocks
from ..types import Levels
from ..utils import device as devices
from . import enginepath as EP

ROUND_STRIDE = 7919      # seed offset a round
EXPLORE_FOLD = 104729    # seed offset of the exploration populations


class FlywheelRound(NamedTuple):
    """One simulate -> refresh iteration's observables."""

    stats: object             # PathStats of the simulation that ran
    skips: np.ndarray         # int64[len(SKIP_REASONS)]
    escalations: int
    harvest: HV.EngineHarvest  # what the refresh trained on (reweighted when asked)
    labeled: int              # closed trades harvested this round (raw, merged)
    ml_model: MlModel         # model REFRESHED from this round's harvest
    policy: OP.PolicyParams   # policy refreshed from this round's harvest
    explored: int = 0         # closed trades of the exploration harvest


def _use_kernel(backend: str, device) -> bool:
    if backend not in ("torch", "cuda"):
        raise ValueError(f"backend must be cuda or torch, not {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend='cuda' launches the CUDA kernel and needs a CUDA device")
    return backend == "cuda"


def _simulate(seed: int, levels, params, *, kernel: bool, n: int, ml_model, policy,
              harvest: bool, device, num_bars, s0, sigma, dt, block_paths, sampler,
              hist_bars, block_len, heston):
    kw = dict(num_paths=n, num_bars=num_bars, s0=s0, sigma=sigma, dt=dt, policy=policy,
              ml_model=ml_model, policy_gate_disabled=policy is None, harvest=harvest,
              sampler=sampler, hist_bars=hist_bars, block_len=block_len, heston=heston,
              device=device)
    if kernel:
        from ..ops.cuda_engine import mc_paths_engine_fused

        return mc_paths_engine_fused(seed, levels, params, **kw)
    return EP.mc_paths_engine(seed, levels, params, block_paths=min(block_paths, n), **kw)


def _head_counts(h: HV.EngineHarvest) -> tuple[int, int]:
    """(go_long, go_short) closed trades of a raw harvest: its policy
    buckets glf*2 + confl with glf 1, then 0."""
    pc = h.pol_counts
    return int(pc[2:].sum()), int(pc[:2].sum())


def refresh_round(hv: HV.EngineHarvest, hv_explore: HV.EngineHarvest | None,
                  policy: OP.PolicyParams | None, *, stop_padding: float,
                  min_samples: int = 50, explore_reweight: bool = True):
    """One round's refresh (JAX flywheel.py:129-159): the round's harvest
    ``hv`` merged with the exploration harvest ``hv_explore`` (or None), the
    merge reweighted to the exploration's bucket frequencies with
    ``explore_reweight``, the ML gate and the OnlinePolicy entry heads fitted
    on it.  The gates read the raw merged closed-trade counts (per head for
    the policy).  Returns (the harvest fitted, the raw labeled count, the ML model, the
    policy)."""
    fit_hv = hv
    if hv_explore is not None:
        hv = hv.merge(hv_explore)
        fit_hv = HV.reweight_to_base(hv, hv_explore) if explore_reweight else hv
    labeled = int(hv.n_labeled)
    ml = HV.ml_model_from_harvest(fit_hv, stop_padding=stop_padding, min_samples=min_samples,
                                  n_labeled=labeled)
    policy = HV.policy_from_harvest(
        OP.PolicyParams.init() if policy is None else policy, fit_hv,
        min_samples=max(1, min_samples // 2), n_labeled=_head_counts(hv))
    return fit_hv, labeled, ml, policy


def policy_iteration(seed: int, levels: Levels, params: EngineParams, *, rounds: int = 2,
                     num_paths: int = 1 << 13, num_bars: int = 40, s0: float = 100.0,
                     sigma: float = 0.3, dt: float = 1.0 / (390.0 * 252.0),
                     backend: str = "cuda", device=None, min_samples: int = 50,
                     arm_policy_gate: bool = False, block_paths: int = 1 << 13,
                     sampler: str = "gbm", hist_bars=None, block_len: int = 10,
                     heston=None, explore_paths: int = 0,
                     explore_reweight: bool = True) -> list[FlywheelRound]:
    """Run ``rounds`` simulate -> harvest -> refresh iterations (JAX
    ``policy_iteration``, flywheel.py:46).

    Round 0 simulates with no ML model and the policy gate disarmed (the
    reference's cold start); each later round arms the previous round's
    refreshed ML gate (and, with ``arm_policy_gate``, the OnlinePolicy
    heads; disarmed by default: its chosen >= 0.60 rule vetoes every entry
    while the win rate sits below 60%, the reference's DISABLE_POLICY_GATE
    posture).  ``explore_paths > 0``: every armed round also harvests a
    gates-off population of that many paths on a disjoint seed and merges
    it before the refresh, so a pruned bucket's base rate stays observable;
    ``explore_reweight`` then reweights the merge to the exploration
    population's bucket frequencies (``models/harvest.reweight_to_base``).
    The refresh gates read the raw merged closed-trade count (the module's
    notes)."""
    device = devices.resolve(device)
    kernel = _use_kernel(backend, device)
    if kernel and explore_paths:     # before round 0, not at round 1's launch
        from ..ops import cuda_engine as CE

        check_blocks(seed, levels, num_paths=explore_paths, lanes=CE.ENGINE_LANES,
                     sub=CE.ENGINE_SUB, what="engine", max_slots=MAX_ENGINE_LEVELS)
    sim = dict(levels=levels, params=params, kernel=kernel, harvest=True, device=device,
               num_bars=num_bars, s0=s0, sigma=sigma, dt=dt, block_paths=block_paths,
               sampler=sampler, hist_bars=hist_bars, block_len=block_len, heston=heston)
    stop_padding = float(params.stop_padding)
    ml: MlModel | None = None
    policy: OP.PolicyParams | None = None
    out: list[FlywheelRound] = []
    for r in range(rounds):
        armed_policy = policy if arm_policy_gate else None
        stats, skips, escal, hv = _simulate(int(seed) + ROUND_STRIDE * r, n=num_paths,
                                            ml_model=ml, policy=armed_policy, **sim)
        hv_x = None
        if explore_paths and r >= 1:
            # round 0 is gates-off already: only armed rounds need the mix
            _, _, _, hv_x = _simulate(int(seed) + ROUND_STRIDE * r + EXPLORE_FOLD,
                                      n=explore_paths, ml_model=None, policy=None, **sim)
        fit_hv, labeled, ml, policy = refresh_round(
            hv, hv_x, policy, stop_padding=stop_padding, min_samples=min_samples,
            explore_reweight=explore_reweight)
        explored = 0 if hv_x is None else int(hv_x.n_labeled)
        out.append(FlywheelRound(
            stats=stats, skips=skips.cpu().numpy(), escalations=int(escal),
            harvest=fit_hv, labeled=labeled, ml_model=ml, policy=policy,
            explored=explored))
    return out


def holdout_eval(train_seed: int, eval_seed: int, levels: Levels, params: EngineParams, *,
                 rounds: int = 2, num_paths: int = 1 << 13, eval_paths: int | None = None,
                 num_bars: int = 40, s0: float = 100.0, sigma: float = 0.3,
                 dt: float = 1.0 / (390.0 * 252.0), backend: str = "cuda", device=None,
                 min_samples: int = 50, arm_policy_gate: bool = False,
                 block_paths: int = 1 << 13, sampler: str = "gbm", hist_bars=None,
                 block_len: int = 10, heston=None, exact_tail: bool = False,
                 explore_paths: int = 0,
                 explore_reweight: bool = True) -> tuple[list[FlywheelRound], list[dict]]:
    """Does the flywheel learn, or just train?  (JAX ``holdout_eval``,
    flywheel.py:165.)  Trains the gates on the ``train_seed`` population
    (``policy_iteration``), then evaluates each round's refreshed models on
    the disjoint ``eval_seed`` population, every arm on the same paths (common
    random numbers: differences are gate effects).  Returns (train_rounds,
    eval_rows): the ``disarmed`` arm, then ``round{i}`` for each trained
    round's ML gate (and OnlinePolicy heads with ``arm_policy_gate``), each
    row with per-trade expectancy, mean R, hit rate, trades, drawdown,
    escalations, histogram VaR/CVaR and the ML / policy skip counts.
    ``exact_tail=True`` raises: the exact tail (``sim/tailexact``) is not
    ported yet."""
    if exact_tail:
        raise NotImplementedError("exact_tail=True is not ported yet (the exact-tail "
                                  "slice, with sim/tailexact.py)")
    train_rounds = policy_iteration(
        train_seed, levels, params, rounds=rounds, num_paths=num_paths, num_bars=num_bars,
        s0=s0, sigma=sigma, dt=dt, backend=backend, device=device,
        min_samples=min_samples, arm_policy_gate=arm_policy_gate, block_paths=block_paths,
        sampler=sampler, hist_bars=hist_bars, block_len=block_len, heston=heston,
        explore_paths=explore_paths, explore_reweight=explore_reweight)
    eval_paths = int(eval_paths or num_paths)
    device = devices.resolve(device)
    kernel = _use_kernel(backend, device)
    sim = dict(levels=levels, params=params, kernel=kernel, harvest=False, device=device,
               num_bars=num_bars, s0=s0, sigma=sigma, dt=dt, block_paths=block_paths,
               sampler=sampler, hist_bars=hist_bars, block_len=block_len, heston=heston)
    arms = [("disarmed", None, None)] + [
        (f"round{i}", rd.ml_model, rd.policy if arm_policy_gate else None)
        for i, rd in enumerate(train_rounds)]
    names = [r.name for r in EP.SKIP_REASONS]
    rows: list[dict] = []
    for label, ml, pol in arms:
        stats, skips, escal = _simulate(int(eval_seed), n=eval_paths, ml_model=ml,
                                        policy=pol, **sim)
        skips = skips.cpu().numpy()
        trades = float(stats.sum_trades)
        rows.append({
            "arm": label,
            "ml_armed": ml is not None and bool(ml.present),
            "policy_armed": pol is not None,
            "paths": eval_paths,
            "trades": trades,
            "expectancy_r": float(stats.sum_r) / trades if trades else 0.0,
            "mean_r": float(stats.mean_r),
            "hit_rate": float(stats.hit_rate),
            "mean_dd": float(stats.mean_dd),
            "escalations": float(escal),
            "var_05": float(stats.quantile(0.05)),
            "cvar_05": float(stats.cvar(0.05)),
            "skips_ml": float(skips[names.index("ML_CONF_LOW")]),
            "skips_policy": float(skips[names.index("ONLINE_POLICY")]),
        })
    return train_rounds, rows
