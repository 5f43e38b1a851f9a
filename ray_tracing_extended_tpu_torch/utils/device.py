"""Where the port's entry points put their tensors.

Builders, loaders, presets and cameras take ``device=`` and default to
``"cuda"``: the port's work belongs on the card. A caller who wants the
plain PyTorch path on the CPU asks for it with ``device="cpu"``. Asking for
CUDA where there is none raises; nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "build on the CPU and render with the plain PyTorch path"
        )
    return dev
