"""The device of the port's entry points.

Mesh constructors and model cases put their tensors on the CUDA device
unless the caller asks for another one (`device="cpu"`). Without a CUDA
GPU a CUDA request raises: nothing falls back to the CPU silently.

`warm_cpu_vector_math` runs once at import of the package (see there).
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


def warm_cpu_vector_math():
    """Make the process's first threaded call of torch.sqrt on the CPU a
    discarded one, in float64 and float32. torch.sqrt on the CPU is MKL's
    vector math, threaded inside MKL, and the first threaded call of a
    process has returned the second thread's half of its values off by
    up to 3e-11 relative (2 of 200 fresh processes at 2 intra-op threads;
    every later call exact to the bit; ROADMAP Queue 3). The plain
    pressure-correction assembly's face norms met it as the flake of
    tests/test_torch_kernels.py's pc_assembly test. The warm-up covers
    the intra-op threads that exist when it runs, at import: a process
    that raises torch's thread count later gets fresh threads, which it
    does not cover."""
    for dtype in (torch.float64, torch.float32):
        torch.sqrt(torch.ones(1 << 16, dtype=dtype))
