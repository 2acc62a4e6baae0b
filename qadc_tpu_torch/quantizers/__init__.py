from qadc_tpu_torch.quantizers.opq import OPQQuantizer, train_opq
from qadc_tpu_torch.quantizers.pq import ProductQuantizer, decode, encode, train_pq

__all__ = [
    "ProductQuantizer",
    "OPQQuantizer",
    "train_pq",
    "train_opq",
    "encode",
    "decode",
]
