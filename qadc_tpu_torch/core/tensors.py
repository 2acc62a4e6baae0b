"""Device, generator and matmul-precision helpers shared by the port.

One rule decides where an entry point runs: a tensor argument stays on its
own device; numpy (or anything else array-like) goes to the `device`
argument, which defaults to the card. Nothing falls back to the CPU when
there is no card: the copy raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def as_f32(x, device=DEFAULT_DEVICE) -> torch.Tensor:
    """x as a float32 tensor: a tensor keeps its device, anything else is
    copied to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    a = np.ascontiguousarray(x, dtype=np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def to_f32(x, device) -> torch.Tensor:
    """x as a float32 tensor on `device`, whatever it was."""
    return as_f32(x, device).to(device)


def as_generator(generator, device) -> torch.Generator:
    """A torch.Generator on `device`: an int seeds a new one; a Generator
    must already live on that device (torch's samplers take no other).

    One seed gives different streams on the CPU and on CUDA.
    """
    device = torch.device(device)
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"generator is on {generator.device}, the data on {device}")
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside the block,
    whatever the process-wide setting; the setting is restored after. The
    JAX package pins Precision.HIGHEST on the same products."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
