"""The device of the port's entry points.

Mesh constructors and model cases put their tensors on the CUDA device
unless the caller asks for another one (`device="cpu"`). Without a CUDA
GPU a CUDA request raises: nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """`device` as a torch.device; raises RuntimeError for a CUDA device
    when torch sees no CUDA GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is available: orc_tpu_torch runs on the card by "
            "default; pass device='cpu' to run on the CPU"
        )
    return dev
