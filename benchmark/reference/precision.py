"""The reference's float type: float32, as the configurations state, or a
lower precision for the control (``computed_in``), which the comparison
has to refuse."""

from __future__ import annotations

import contextlib

import torch

FT = torch.float32


@contextlib.contextmanager
def computed_in(dtype):
    """Run the reference with every float tensor it makes in ``dtype``:
    its explicit casts (``FT``) and torch's default type alike."""
    global FT
    old, old_default = FT, torch.get_default_dtype()
    FT = dtype
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        FT = old
        torch.set_default_dtype(old_default)
