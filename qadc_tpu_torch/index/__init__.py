from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import IVFIndex

__all__ = ["FlatIndex", "IVFIndex"]
