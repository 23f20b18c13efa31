"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Raises when CUDA is asked for and absent — there is no
    silent fall back to the CPU.

    On CUDA it pins full-f32 matmuls and convolutions (no TF32), as the
    reference's f32 dots are full precision."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev


@contextmanager
def host_sync_allowed():
    """Lift ``torch.cuda.set_sync_debug_mode`` for the body and restore it
    after: for a wait on the card that a step makes on purpose (the
    probe-parallel step's copy of its losses to the host)."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)
