"""Device, generator and matmul-precision helpers shared by the port.

One rule decides where an entry point runs: a tensor argument stays on its
own device; numpy (or anything else array-like) goes to the `device`
argument, which defaults to the card. Nothing falls back to the CPU when
there is no card: the copy raises.
"""

from __future__ import annotations

import contextlib
import threading

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


# torch's float32 matmul precision is one setting for the whole process:
# the guards of all threads share it, and the first to enter saves it.
_precision_lock = threading.Lock()
_precision_depth = 0
_precision_saved = "highest"


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside the block,
    whatever the process-wide setting. The JAX package pins
    Precision.HIGHEST on the same products.

    Safe across threads and nested: the setting is saved when the first
    guard of the process opens and restored when the last one closes, so no
    thread's product inside a guard runs in TF32 because another thread
    left its own."""
    global _precision_depth, _precision_saved
    with _precision_lock:
        if _precision_depth == 0:
            _precision_saved = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
        _precision_depth += 1
    try:
        yield
    finally:
        with _precision_lock:
            _precision_depth -= 1
            if _precision_depth == 0:
                torch.set_float32_matmul_precision(_precision_saved)
