"""qadc_tpu_torch: the IVF Quick-ADC search of `qadc_tpu`, in PyTorch.

The JAX package `qadc_tpu` is the reference; this package mirrors its module
paths (`qadc_tpu_torch/index/ivf.py` <-> `qadc_tpu/index/ivf.py`). Plain
tensor code is PyTorch; the three Pallas kernels on the search path are
hand-written CUDA C++ for Hopper (`csrc/`, built at first use by
`kernels/build.py`). Each kernel wrapper runs the kernel on CUDA tensors and
its plain PyTorch version on CPU tensors (`kernels/lut_scan.py`).

This package never imports jax.
"""

import torch

# Float32 matmuls outside the kernels (coarse assignment, ADC tables, OPQ
# rotation) must run in full float32, as the JAX package's
# Precision.HIGHEST does: TF32 keeps about three decimal digits, which would
# move the int8 tables' truncation points and the ranking.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
