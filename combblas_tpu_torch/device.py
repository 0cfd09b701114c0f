"""Where the port's constructors put their tensors.

A constructor that is not told a device puts its tensors on the card, as the
JAX package's ``from_arrays`` puts its arrays on the accelerator.  Without a
card it raises: it never falls back to the CPU.  Callers that want the host
(the CPU tests, the plain reference runs) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's constructors put their "
                           "tensors on the card unless given device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())
