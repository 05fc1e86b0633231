"""Where the port's entry points run: on the card unless the caller asks for the CPU.

``resolve`` is the one rule every entry point follows.  ``device=None`` means
the CUDA device, and raises when there is none; the CPU runs only when the
caller names it (``device="cpu"``) or hands in a CPU tensor of inputs
(``external_uniforms``), which names it just as plainly.
"""

from __future__ import annotations

import torch

NO_GPU = ("no CUDA device (torch.cuda.is_available() is false); pass "
          "device='cpu' to run on the CPU")


def resolve(device=None, tensor: torch.Tensor | None = None) -> torch.device:
    """The device an entry point runs on.  ``tensor`` (optional) is an input
    whose device, when ``device`` is None, is the caller's choice; when both
    are given they must agree."""
    if device is None:
        device = tensor.device if tensor is not None else torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_GPU)
    if tensor is not None:
        td = tensor.device
        if td.type != device.type or (device.index is not None
                                      and td.index != device.index):
            raise ValueError(f"inputs lie on {td}, not {device}")
    return device
