"""The ML gate of the 12-gate entry ladder.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/engine/gates.py:92-110``
(``_ml_allowed``, the reference's :1454-1466).  The full tick-scale ladder
(``evaluate_entry``) waits for the slice that ports the hosts; the
generated-path engine runs its gates in ``sim/enginepath.py``.
"""

from __future__ import annotations

import torch

from ..types import DIR_UP
from ..utils.floats import fma
from .state import MlModel

_F32 = torch.float32


def _ml_allowed(model: MlModel, params, *, level_solid, level_price, stop,
                touch_count, direction):
    """Linear model over [lvl_type, |level_price - stop|, touch_count,
    direction == up]; passes when sigmoid >= Q_MIN_PROB.  An absent or
    3-feature model never blocks and reports no probability.  Returns (ok,
    proba, usable).

    The JAX gate's ``jnp.dot`` compiles to a chain of fused multiply-adds
    from the first product, then the intercept is added: the same order
    here.  ``torch.sigmoid`` and XLA's ``1 / (1 + exp(-z))`` can differ in
    the last place."""
    x = (torch.as_tensor(level_solid).to(_F32),
         (torch.as_tensor(level_price, dtype=_F32) - stop).abs(),
         torch.as_tensor(touch_count).to(_F32),
         (torch.as_tensor(direction) == DIR_UP).to(_F32))
    dev = x[1].device
    coef = model.coef.to(dev)
    z = coef[0] * x[0]
    for i in range(1, 4):
        z = fma(coef[i], x[i], z)
    proba = torch.sigmoid(z + model.intercept.to(dev))
    usable = model.present & (model.n_features == 4)
    ok = torch.where(usable, proba >= params.q_min_prob, True)
    return ok, torch.where(usable, proba, 0.0), usable
