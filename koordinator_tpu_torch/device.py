"""Device selection shared by every entry point that creates tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU.

    With no device given and no GPU present this raises instead of carrying
    on quietly on the CPU: a CPU run is something the caller asks for
    (``device="cpu"``), never a fallback.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
