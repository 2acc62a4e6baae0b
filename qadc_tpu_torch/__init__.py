"""qadc_tpu_torch: `qadc_tpu` in PyTorch: PQ/OPQ training, the flat and IVF
index builders, the checkpoint, and Quick-ADC and conventional ADC search.

The JAX package `qadc_tpu` is the reference; this package mirrors its module
paths (`qadc_tpu_torch/index/ivf.py` <-> `qadc_tpu/index/ivf.py`). Plain
tensor code is PyTorch; every Pallas kernel of the reference has a
hand-written CUDA C++ counterpart for Hopper (`csrc/`, built at first use by
`kernels/build.py`). Each kernel wrapper runs the kernel on CUDA tensors and
its plain PyTorch version on CPU tensors (`kernels/lut_scan.py`). Entry
points run on the card unless the caller hands them CPU tensors or names
another device (`core/tensors.py`).

This package never imports jax. Importing it (or a subpackage) builds no
kernel and initialises no CUDA context: kernels are built at their first
launch.
"""

import torch

from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import IVFIndex
from qadc_tpu_torch.quantizers.opq import OPQQuantizer, train_opq
from qadc_tpu_torch.quantizers.pq import ProductQuantizer, decode, encode, train_pq
from qadc_tpu_torch.version import __version__

# Float32 matmuls outside the kernels (coarse assignment, ADC tables, OPQ
# rotation) must run in full float32, as the JAX package's
# Precision.HIGHEST does: TF32 keeps about three decimal digits, which would
# move the int8 tables' truncation points and the ranking.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "__version__",
    "ProductQuantizer",
    "OPQQuantizer",
    "train_pq",
    "train_opq",
    "encode",
    "decode",
    "FlatIndex",
    "IVFIndex",
]
