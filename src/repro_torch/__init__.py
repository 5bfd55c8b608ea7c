"""repro_torch — the Hiku serving/scheduling stack in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

It mirrors the layout of the JAX package ``repro`` (``configs/``, ``core/``,
``kernels/``, ``models/``, ``serving/``) so each module's counterpart is found
by name, and it imports nothing from it: the pure-Python control plane it
needs is copied here.

Entry points run on the card.  Pass ``device="cpu"`` to run the plain
PyTorch versions instead (as the CPU tests do); with no device on a machine
without CUDA they raise rather than quietly moving to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve the device an entry point runs on.

    ``None`` means the card: ``cuda`` when CUDA is available, else a
    ``RuntimeError``.  An explicit device is returned as given.  Whenever the
    result is a CUDA device, float32 matrix products and convolutions are
    pinned to full float32 (TF32 off): the kernels are checked against the
    plain versions to ``atol=1e-4, rtol=1e-3``, which TF32 would not meet.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch entry points run on the card; "
                'pass device="cpu" to run the plain PyTorch path'
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
