"""SQLite persistence layer with the reference's exact schema and semantics.

A copy of ``qmmx_monolithic_monte_carlo_tpu/io/db.py``, which imports no JAX
itself; importing it would still import JAX through that package's
``__init__`` (config, types), so the port carries its own copy.

Re-expression of qmmx_monolithic.py:63-160: WAL journal, NORMAL sync, the six
tables (settings, price_levels, audit_log, trades, contact_events, policy_events)
plus QVoice's q_explanations (q_voice.py:193-206).  Column names, types and
orderings are identical so the reference's ``qmmx.db`` opens unmodified and the
reason-code rows this layer writes are drop-in comparable.
"""

from __future__ import annotations

import json
import sqlite3
from datetime import datetime, timezone

from ..config import SETTINGS_DEFAULTS

SCHEMA = [
    # settings KV (:71-74)
    """CREATE TABLE IF NOT EXISTS settings(
        k TEXT PRIMARY KEY,
        v TEXT NOT NULL
    );""",
    # price levels (:75-81)
    """CREATE TABLE IF NOT EXISTS price_levels(
        id INTEGER PRIMARY KEY,
        color TEXT NOT NULL,
        level_type TEXT NOT NULL,
        level_index INTEGER NOT NULL,
        price REAL NOT NULL
    );""",
    # audit log (:82-89)
    """CREATE TABLE IF NOT EXISTS audit_log(
        id INTEGER PRIMARY KEY,
        ts TEXT NOT NULL,
        phase TEXT NOT NULL,
        code TEXT NOT NULL,
        message TEXT NOT NULL,
        extras_json TEXT
    );""",
    # trades (:90-103)
    """CREATE TABLE IF NOT EXISTS trades(
        id INTEGER PRIMARY KEY,
        ts_open TEXT,
        ts_close TEXT,
        symbol TEXT,
        side TEXT,
        entry REAL,
        exit REAL,
        stop REAL,
        target REAL,
        reason_open TEXT,
        reason_close TEXT,
        pnl REAL
    );""",
    # contact events (:104-115)
    """CREATE TABLE IF NOT EXISTS contact_events(
        id INTEGER PRIMARY KEY,
        ts TEXT NOT NULL,
        symbol TEXT NOT NULL,
        level_color TEXT NOT NULL,
        level_type TEXT NOT NULL,
        level_index INTEGER NOT NULL,
        level_price REAL NOT NULL,
        approach TEXT,
        reaction TEXT,
        distance REAL
    );""",
    # policy events (:116-126)
    """CREATE TABLE IF NOT EXISTS policy_events (
        id INTEGER PRIMARY KEY,
        ts TEXT NOT NULL,
        phase TEXT NOT NULL,
        action TEXT NOT NULL,
        features_json TEXT NOT NULL,
        label INTEGER,
        trade_id INTEGER,
        notes TEXT
    );""",
    # QVoice explanations (q_voice.py:197-204)
    """CREATE TABLE IF NOT EXISTS q_explanations (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        ts TEXT NOT NULL,
        code TEXT NOT NULL,
        text TEXT NOT NULL,
        payload_json TEXT
    );""",
]


def utcnow() -> str:
    """ISO-8601 UTC timestamp (:159-160)."""
    return datetime.now(timezone.utc).isoformat()


def db_connect(path: str = "qmmx.db") -> sqlite3.Connection:
    conn = sqlite3.connect(path, check_same_thread=False)
    conn.execute("PRAGMA journal_mode=WAL;")
    conn.execute("PRAGMA synchronous=NORMAL;")
    return conn


def db_init(conn: sqlite3.Connection) -> None:
    cur = conn.cursor()
    for stmt in SCHEMA:
        cur.execute(stmt)
    conn.commit()


def settings_get(conn, key: str, default=None):
    row = conn.execute("SELECT v FROM settings WHERE k=?", (key,)).fetchone()
    return row[0] if row else default


def settings_get_with_defaults(conn, key: str):
    return settings_get(conn, key, SETTINGS_DEFAULTS.get(key))


def settings_set(conn, key: str, value) -> None:
    conn.execute(
        "INSERT INTO settings(k,v) VALUES(?,?) "
        "ON CONFLICT(k) DO UPDATE SET v=excluded.v;",
        (key, str(value)),
    )
    conn.commit()


def load_levels(conn) -> list[dict]:
    rows = conn.execute(
        "SELECT color, level_type, level_index, price FROM price_levels "
        "ORDER BY color, level_type, level_index;"
    ).fetchall()
    return [{"color": c, "type": t, "index": i, "price": float(p)}
            for (c, t, i, p) in rows]


def replace_levels(conn, levels: list[dict]) -> None:
    cur = conn.cursor()
    cur.execute("DELETE FROM price_levels;")
    cur.executemany(
        "INSERT INTO price_levels(color, level_type, level_index, price) "
        "VALUES(?,?,?,?)",
        [(lv["color"], lv["type"], int(lv["index"]), float(lv["price"]))
         for lv in levels],
    )
    conn.commit()


def audit(conn, phase: str, code, message: str, extras: dict | None = None) -> None:
    """Reason-coded audit row (:153-157); commit-per-insert like the reference."""
    conn.execute(
        "INSERT INTO audit_log(ts, phase, code, message, extras_json) "
        "VALUES(?,?,?,?,?)",
        (utcnow(), phase, str(code), message, json.dumps(extras or {})),
    )
    conn.commit()


def insert_policy_event(conn, phase: str, action: str, features: dict,
                        label=None, trade_id=None, notes: str = "") -> int:
    cur = conn.execute(
        "INSERT INTO policy_events(ts, phase, action, features_json, label, "
        "trade_id, notes) VALUES(?,?,?,?,?,?,?)",
        (utcnow(), phase, action, json.dumps(features), label, trade_id, notes),
    )
    conn.commit()
    return cur.lastrowid


def open_trade(conn, symbol: str, side: str, entry: float, stop: float,
               target: float, reason_open: str) -> int:
    """INSERT + attach the latest unlabeled entry policy_event (:1888-1915)."""
    cur = conn.execute(
        "INSERT INTO trades(ts_open, symbol, side, entry, stop, target, "
        "reason_open) VALUES(?,?,?,?,?,?,?)",
        (utcnow(), symbol, side, entry, stop, target, reason_open),
    )
    conn.commit()
    trade_id = cur.lastrowid
    conn.execute(
        """UPDATE policy_events SET trade_id = ?
           WHERE id = (SELECT id FROM policy_events
                       WHERE phase='entry' AND trade_id IS NULL
                       ORDER BY id DESC LIMIT 1)""",
        (trade_id,),
    )
    conn.commit()
    return trade_id


def close_trade(conn, trade_id: int, exit_price: float, reason_close: str):
    """UPDATE close + label the attached entry policy_event by pnl sign
    (:1917-1948). Returns pnl or None when the trade doesn't exist."""
    row = conn.execute("SELECT side, entry FROM trades WHERE id=?", (trade_id,)).fetchone()
    if not row:
        return None
    side, entry = row
    pnl = (exit_price - float(entry)) if side == "long" else (float(entry) - exit_price)
    conn.execute(
        "UPDATE trades SET ts_close=?, exit=?, reason_close=?, pnl=? WHERE id=?",
        (utcnow(), exit_price, reason_close, pnl, trade_id),
    )
    conn.execute(
        "UPDATE policy_events SET label=? WHERE trade_id=? AND phase='entry' "
        "AND label IS NULL",
        (1 if pnl > 0 else 0, trade_id),
    )
    conn.commit()
    return pnl
