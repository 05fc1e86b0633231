"""The recorded-bar CSV loader.

JAX-free copy of ``qmmx_monolithic_monte_carlo_tpu/io/native.py:156-200``
(``parse_bars_csv`` and its pure-Python parser ``_parse_bars_csv_py``): a
header naming t, o, h, l, c and optionally v, in any column order; a
missing or empty volume reads 0.  The JAX package's g++ fast path
(``native/qmmx_native.cpp``) is not ported; its 2^22-row buffer is kept as
the cap, and a longer file raises instead of being cut short.
"""

from __future__ import annotations

import csv

import numpy as np

MAX_ROWS = 1 << 22


def parse_bars_csv(path: str, max_rows: int = MAX_ROWS) -> dict:
    """{t: int64[n], o, h, l, c, v: float64[n]} of the bars in ``path``."""
    cols = {"t": [], "o": [], "h": [], "l": [], "c": [], "v": []}
    with open(path) as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or not {"t", "o", "h", "l", "c"} <= set(
                reader.fieldnames):
            raise ValueError(f"{path}: header must contain t,o,h,l,c")
        for row in reader:
            if len(cols["t"]) == max_rows:
                raise ValueError(f"{path}: more than {max_rows} bars")
            cols["t"].append(int(float(row["t"])))
            for k in ("o", "h", "l", "c"):
                cols[k].append(float(row[k]))
            cols["v"].append(float(row.get("v", 0.0) or 0.0))
    out = {"t": np.asarray(cols["t"], np.int64)}
    out.update({k: np.asarray(cols[k], np.float64) for k in "ohlcv"})
    return out
