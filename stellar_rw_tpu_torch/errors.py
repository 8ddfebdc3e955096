"""Errors for what the port does not serve yet, and for a missing GPU."""

import torch


class NotPorted(NotImplementedError):
    """A flag value or code path that the JAX package serves and the port
    does not yet; the message names the ROADMAP.md item that ports it."""


class CudaUnavailable(RuntimeError):
    """An entry point was asked for the GPU and torch sees none."""


def resolve_device(entry: str, device) -> torch.device:
    """The device an entry point runs on. Every entry point defaults to
    "cuda"; without a GPU that raises CudaUnavailable, never a silent CPU
    run: the caller asks for the CPU by device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailable(
            f"{entry}: no CUDA device is visible to torch (pass "
            'device="cpu" for the plain version on the CPU)')
    return device
