"""Reason codes for entry/exit decisions.

A copy of ``qmmx_monolithic_monte_carlo_tpu/reasons.py`` (which imports no
JAX itself, but importing it runs the JAX package's ``__init__``).

The reference app (qmmx_monolithic.py:246-257) defines its reason codes as module-level
string constants and threads them through ``evaluate_entry`` returns, ``policy_events``
JSON payloads and ``audit_log`` rows.  The TPU rebuild keeps the exact string names as
the external contract (SQLite rows, analyzer output) but uses small integers on device
so the gate stack can run branchless inside ``jit``/``lax.scan``.

Two code spaces exist, mirroring the reference:

* the *detailed* reason recorded in ``policy_events`` (e.g. ``ML_CONF_LOW``,
  ``COMBINED_LOW``, ``EDGE_FATIGUE``, ``ACC_BREAKOUT_GATE``, ``CONTRA_VOL_LONG``), and
* the *returned* code from ``evaluate_entry`` (the reference maps ML/blend failures
  back to ``CONF_LOW`` at qmmx_monolithic.py:1740/:1755, returns the undefined name
  ``VETO`` for fatigue/budget/veto branches — quirk Q1 — and the bare int ``904`` for
  the accumulation-breakout gate at :1666).

``returned_code`` reproduces that mapping, including the quirks behind an explicit
compat switch (see config.CompatFlags.strict_reference_quirks).
"""

from __future__ import annotations

import enum


class Reason(enum.IntEnum):
    """Detailed decision reasons, in gate-priority order (qmmx_monolithic.py:1492-1771)."""

    OK = 0
    MISSING_API_KEY = 1
    PRICE_STALE = 2
    IN_POSITION = 3
    COOLDOWN = 4
    NOLEVELS = 5
    DIR_UNKNOWN = 6
    TOO_FAR = 7
    LEVEL_OVERTOUCHED = 8
    EDGE_FATIGUE = 9          # accumulation gate 7b-a (:1596-1604)
    TOUCH_BUDGET = 10         # LevelTouchMemory bounce budget exhausted (:1229-1231)
    TOUCH_COOLDOWN = 11       # LevelTouchMemory per-level cooldown (:1233-1235)
    CONF_LOW = 12
    ACC_BREAKOUT_GATE = 13    # counter-trend block after volume-confirmed breakout (:1652-1666)
    CONTRA_VOL_LONG = 14      # soft veto (:1786/:1790)
    CONTRA_VOL_SHORT = 15     # soft veto (:1787/:1791)
    ML_CONF_LOW = 16          # AND-mode ML gate fail (:1745-1755)
    COMBINED_LOW = 17         # blended gate fail (:1730-1740)
    RISK_INVALID = 18         # defined but unused in the reference (:256)
    ONLINE_POLICY = 19        # app-level OnlinePolicy gate skip (:3095-3109)
    ENGINE_ERR = 20           # loop-level exception absorption (:3192-3195)


# The exact strings the reference writes into policy_events features_json["reason"].
REASON_NAMES: dict[int, str] = {r.value: r.name for r in Reason}

# Reasons the reference's LevelTouchMemory returns as free-text (":1229-:1235"); the
# analyzer (log_analyzer.py:56-58) groups the VETO family by the "veto" extras key.
_VETO_FAMILY = frozenset(
    {
        Reason.EDGE_FATIGUE,
        Reason.TOUCH_BUDGET,
        Reason.TOUCH_COOLDOWN,
        Reason.CONTRA_VOL_LONG,
        Reason.CONTRA_VOL_SHORT,
    }
)

# Reference `evaluate_entry` return-code for the accumulation-breakout gate is the bare
# int 904 (qmmx_monolithic.py:1666).
ACC_BREAKOUT_RETURN_CODE = 904


def returned_code(reason: Reason, *, strict_reference_quirks: bool = False) -> str | int:
    """Map a detailed reason to the code ``evaluate_entry`` returns.

    With ``strict_reference_quirks`` the VETO family reproduces quirk Q1: the
    reference's ``VETO`` name is undefined, so those branches raise ``NameError``
    and surface as ``ENGINE_ERR`` in the audit log (qmmx_monolithic.py:1604/:1617/
    :1705 vs. constants :247-257, absorbed at :3192-3195).
    """
    if reason in _VETO_FAMILY:
        return "ENGINE_ERR" if strict_reference_quirks else "VETO"
    if reason == Reason.ACC_BREAKOUT_GATE:
        return ACC_BREAKOUT_RETURN_CODE
    if reason in (Reason.ML_CONF_LOW, Reason.COMBINED_LOW):
        return "CONF_LOW"
    return reason.name
