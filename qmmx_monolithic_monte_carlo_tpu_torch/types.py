"""Core data types of the port: enums, constants and tensor dataclasses.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/types.py``.  The pytrees there
become plain dataclasses of tensors here; the field names, dtypes and the
(color, type, index) level ordering are the same, so a JAX object's fields
carried across as numpy arrays (``from_numpy``) build the identical port object.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Level colors in the reference GUI (Blue/Orange/Black/Teal).
COLORS = ("blue", "orange", "black", "teal")
COLOR_IDS = {c: i for i, c in enumerate(COLORS)}

# Level kinds ("level_type" column): solid / dashed.
KIND_DASHED = 0
KIND_SOLID = 1
KINDS = ("dashed", "solid")

# Trade sides as signed ints: +1 long, -1 short, 0 flat.
SIDE_LONG = 1
SIDE_SHORT = -1
SIDE_FLAT = 0

# Tick directions: +1 up, -1 down, 0 unknown.
DIR_UP = 1
DIR_DOWN = -1
DIR_UNKNOWN = 0

# Approach encoding for policy features.
APPROACH_FROM_ABOVE = 0
APPROACH_FROM_BELOW = 1

# Sim outcomes.
OUTCOME_OPEN = 0
OUTCOME_TP = 1
OUTCOME_STOP = 2


def _fields_from_numpy(cls, d: dict, dtypes: dict, device=None):
    return cls(**{k: torch.as_tensor(np.array(d[k]), dtype=dt, device=device)
                  for k, dt in dtypes.items()})


@dataclasses.dataclass
class Levels:
    """Padded SoA of price levels; invalid slots masked out.

    ``price`` for invalid slots is +inf so a nearest-level search never
    selects them.
    """

    price: torch.Tensor   # f32[L]
    kind: torch.Tensor    # i32[L]  (KIND_SOLID / KIND_DASHED)
    color: torch.Tensor   # i32[L]  (index into COLORS)
    index: torch.Tensor   # i32[L]  (user slot index within color/kind grid)
    valid: torch.Tensor   # bool[L]

    _DTYPES = {"price": torch.float32, "kind": torch.int32,
               "color": torch.int32, "index": torch.int32,
               "valid": torch.bool}

    @property
    def max_levels(self) -> int:
        return self.price.shape[-1]

    @property
    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)

    @classmethod
    def from_rows(cls, rows: list[dict[str, Any]], max_levels: int = 64,
                  device=None) -> "Levels":
        """Build from host dict rows ({"color","type","index","price"}) in the
        reference's (color, type, index) SQL ordering, so nearest-level ties
        resolve identically."""
        rows = sorted(rows, key=lambda r: (str(r["color"]), str(r["type"]),
                                           int(r["index"])))
        if len(rows) > max_levels:
            raise ValueError(f"{len(rows)} levels > max_levels={max_levels}")
        d = {
            "price": np.full((max_levels,), np.inf, dtype=np.float32),
            "kind": np.zeros((max_levels,), dtype=np.int32),
            "color": np.zeros((max_levels,), dtype=np.int32),
            "index": np.zeros((max_levels,), dtype=np.int32),
            "valid": np.zeros((max_levels,), dtype=bool),
        }
        for i, r in enumerate(rows):
            d["price"][i] = float(r["price"])
            d["kind"][i] = KIND_SOLID if str(r["type"]) == "solid" else KIND_DASHED
            d["color"][i] = COLOR_IDS.get(str(r["color"]), 0)
            d["index"][i] = int(r["index"])
            d["valid"][i] = True
        return cls.from_numpy(d, device=device)

    @classmethod
    def from_numpy(cls, d: dict, device=None) -> "Levels":
        """From a dict of numpy arrays, e.g. the fields of the JAX ``Levels``
        (``{k: np.asarray(v) for k, v in vars(jax_levels).items()}``)."""
        return _fields_from_numpy(cls, d, cls._DTYPES, device)

    def to(self, device) -> "Levels":
        return Levels(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})

    def to_rows(self) -> list[dict[str, Any]]:
        out = []
        price, kind = self.price.cpu().numpy(), self.kind.cpu().numpy()
        color, index = self.color.cpu().numpy(), self.index.cpu().numpy()
        for i, ok in enumerate(self.valid.cpu().numpy()):
            if ok:
                out.append({"color": COLORS[int(color[i])],
                            "type": KINDS[int(kind[i])],
                            "index": int(index[i]),
                            "price": float(price[i])})
        return out


@dataclasses.dataclass
class Bars:
    """SoA 1-minute OHLCV bars, oldest → newest along the last axis.

    ``ts_ms`` is int32 milliseconds relative to the host epoch of the dataset;
    ``valid`` masks padding so fixed-shape windows can hold variable history.
    """

    ts_ms: torch.Tensor   # i32[..., N]
    open: torch.Tensor    # f32[..., N]
    high: torch.Tensor    # f32[..., N]
    low: torch.Tensor     # f32[..., N]
    close: torch.Tensor   # f32[..., N]
    volume: torch.Tensor  # f32[..., N]
    valid: torch.Tensor   # bool[..., N]

    @property
    def num_bars(self) -> int:
        return self.close.shape[-1]

    @classmethod
    def from_arrays(cls, ts_ms, o, h, l, c, v=None, valid=None,
                    device=None) -> "Bars":
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        c = f32(c)
        return cls(
            ts_ms=torch.as_tensor(np.asarray(ts_ms, np.int32), device=device),
            open=f32(o), high=f32(h), low=f32(l), close=c,
            volume=torch.zeros_like(c) if v is None else f32(v),
            valid=(torch.ones(c.shape, dtype=torch.bool, device=device)
                   if valid is None
                   else torch.as_tensor(np.asarray(valid, bool), device=device)),
        )

    @classmethod
    def from_rows(cls, rows: list[dict[str, Any]], epoch_ms: int = 0,
                  device=None) -> "Bars":
        """Build from host dict rows with Polygon-style keys t/o/h/l/c(/v)."""
        cols = {k: np.zeros((len(rows),), np.float32) for k in "ohlcv"}
        ts = np.zeros((len(rows),), np.int64)
        for i, b in enumerate(rows):
            ts[i] = int(b.get("t", b.get("ts", 0))) - epoch_ms
            for k in "ohlc":
                cols[k][i] = float(b.get(k, b.get("price", 0.0)))
            cols["v"][i] = float(b.get("v", b.get("volume", 0.0)))
        return cls.from_arrays(ts.astype(np.int32), cols["o"], cols["h"],
                               cols["l"], cols["c"], cols["v"], device=device)


@dataclasses.dataclass
class Ticks:
    """Raw trade prints for live-loop replay."""

    ts_ms: torch.Tensor   # i32[N] relative ms
    price: torch.Tensor   # f32[N]
    volume: torch.Tensor  # f32[N]
