"""Configuration: engine parameters, compat flags and the settings-key inventory.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/config.py``.  The reference
keeps all knobs in a SQLite ``settings`` KV table read via
``settings_get(key, default)``; the port splits them the same way:

* ``EngineParams`` — a dataclass of 0-d tensors, the engine's numeric knobs;
* ``CompatFlags`` — static booleans selecting reference-quirk behaviour;
* ``SETTINGS_DEFAULTS`` — the full key inventory with the reference's defaults,
  used by the host SQLite layer (io/db.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Full settings-key inventory of the reference (SURVEY.md §5).
SETTINGS_DEFAULTS: dict[str, str] = {
    "symbol": "SPY",
    "polygon_api_key": "",
    "allow_after_hours": "0",
    "chart_candles": "120",
    "portfolio_start": "10000",
    "CONTACT_PROX": "0.05",
    "Q_SIGNAL_COOLDOWN": "8",
    "STOP_PADDING": "0.35",
    "TP_PADDING": "0.25",
    "Q_MIN_PROB": "0.60",
    "ENABLE_VETO": "1",
    "VETO_VOL_STRONG": "0.25",
    "VETO_PROX": "0.06",
    "DISABLE_ML_GATE": "0",
    "DISABLE_POLICY_GATE": "0",
    "USE_BLEND": "0",
    "W_RULES": "0.7",
    "W_ML": "0.3",
    "retrain_time": "02:00",
    "auto_retrain": "1",
    "last_trained_policy_event_id": "0",
    # rebuild-only keys: opt-in exit-head gating
    "USE_EXIT_HEAD": "0",
    "EXIT_HEAD_MIN": "0.60",
}


def parse_prob_threshold(raw) -> float:
    """Reference ``_read_prob_threshold`` semantics: accepts 0-1 or 0-100
    (percent), falls back to 0.60 on parse error or out-of-range."""
    try:
        val = float(raw)
    except (TypeError, ValueError):
        val = 0.60
    if val > 1.0:
        val = val / 100.0
    if not (0.0 <= val <= 0.99):
        val = 0.60
    return val


_BOOL_FIELDS = ("enable_veto", "disable_ml_gate", "use_blend")
_INT_FIELDS = ("stale_ms", "overtouch_limit")


def _field_dtype(name: str) -> torch.dtype:
    if name in _BOOL_FIELDS:
        return torch.bool
    if name in _INT_FIELDS:
        return torch.int32
    return torch.float32


@dataclasses.dataclass
class EngineParams:
    """The engine's numeric knobs as 0-d tensors (defaults = reference defaults)."""

    contact_prox: torch.Tensor          # CONTACT_PROX, 0.05
    cooldown_s: torch.Tensor            # Q_SIGNAL_COOLDOWN, 8
    reverse_touch_decay: torch.Tensor   # 0.08 hardcoded
    stop_padding: torch.Tensor          # 0.35
    tp_padding: torch.Tensor            # 0.25
    q_min_prob: torch.Tensor            # 0.60
    enable_veto: torch.Tensor           # bool
    veto_vol_strong: torch.Tensor       # 0.25
    veto_prox: torch.Tensor             # 0.06
    disable_ml_gate: torch.Tensor       # bool
    use_blend: torch.Tensor             # bool
    w_rules: torch.Tensor               # 0.7
    w_ml: torch.Tensor                  # 0.3
    stale_ms: torch.Tensor              # 15000 hardcoded
    confluence_within: torch.Tensor     # 0.15 hardcoded
    overtouch_limit: torch.Tensor       # 4 hardcoded

    @classmethod
    def default(cls, device=None, **overrides) -> "EngineParams":
        vals = dict(
            contact_prox=0.05,
            cooldown_s=8.0,
            reverse_touch_decay=0.08,
            stop_padding=0.35,
            tp_padding=0.25,
            q_min_prob=0.60,
            enable_veto=True,
            veto_vol_strong=0.25,
            veto_prox=0.06,
            disable_ml_gate=False,
            use_blend=False,
            w_rules=0.7,
            w_ml=0.3,
            stale_ms=15000,
            confluence_within=0.15,
            overtouch_limit=4,
        )
        unknown = set(overrides) - set(vals)
        if unknown:
            raise TypeError(f"unknown EngineParams fields: {sorted(unknown)}")
        vals.update(overrides)
        out = {}
        for k, v in vals.items():
            dt = _field_dtype(k)
            if dt is torch.int32:
                v = int(v)
            out[k] = torch.tensor(v, dtype=dt, device=device)
        return cls(**out)

    @classmethod
    def from_settings(cls, get, device=None) -> "EngineParams":
        """Build from a ``settings_get``-style callable (host layer)."""
        def g(key):
            return get(key, SETTINGS_DEFAULTS[key])

        return cls.default(
            device=device,
            contact_prox=float(g("CONTACT_PROX")),
            cooldown_s=float(g("Q_SIGNAL_COOLDOWN")),
            stop_padding=float(g("STOP_PADDING")),
            tp_padding=float(g("TP_PADDING")),
            q_min_prob=parse_prob_threshold(get("Q_MIN_PROB", get("minp", "0.60"))),
            enable_veto=g("ENABLE_VETO") == "1",
            veto_vol_strong=float(g("VETO_VOL_STRONG")),
            veto_prox=float(g("VETO_PROX")),
            disable_ml_gate=g("DISABLE_ML_GATE") == "1",
            use_blend=g("USE_BLEND") == "1",
            w_rules=float(g("W_RULES") or 0.7),
            w_ml=float(g("W_ML") or 0.3),
        )

    @classmethod
    def from_numpy(cls, d: dict, device=None) -> "EngineParams":
        """From a dict of numpy arrays, e.g. the fields of the JAX
        ``EngineParams`` (``{k: np.asarray(v) for k, v in vars(p).items()}``)."""
        return cls(**{f.name: torch.as_tensor(np.array(d[f.name]),
                                              dtype=_field_dtype(f.name),
                                              device=device)
                      for f in dataclasses.fields(cls)})

    def replace(self, **changes) -> "EngineParams":
        return dataclasses.replace(self, **{
            k: torch.as_tensor(v, dtype=_field_dtype(k))
            for k, v in changes.items()})


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Static switches selecting reference-quirk behaviour (SURVEY.md §3 Q1-Q9).

    Defaults are the *fixed* behaviours; ``strict_reference_quirks()`` selects
    the reference's for audit-parity replays against its recorded WAL.
    """

    # Q1: the reference's VETO reason-code NameError → vetoes surface as ENGINE_ERR.
    veto_nameerror: bool = False
    # Q2: evaluate_entry called twice per tick with identical args.
    double_evaluate: bool = False
    # Q5: sklearn gate train/serve feature skew silently disables the ML gate.
    ml_feature_skew: bool = False
    # Q7: the sim seeds its gate state from the live state.
    sim_seeds_from_live_state: bool = True
    # Q9: record a contact event on every fresh touch latch (the reference
    # never writes contact_events, so its batch retrain never trains).
    record_contact_events: bool = True
    # Q8: live escalation never fires in the reference; True reproduces it.
    escalation_broken: bool = False

    @classmethod
    def strict_reference_quirks(cls) -> "CompatFlags":
        return cls(
            veto_nameerror=True,
            double_evaluate=True,
            ml_feature_skew=True,
            sim_seeds_from_live_state=True,
            record_contact_events=False,
            escalation_broken=True,
        )
