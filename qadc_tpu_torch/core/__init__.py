from qadc_tpu_torch.core.layout import DEFAULT_BLOCK, pad_codes_to_block, padded_count
from qadc_tpu_torch.core.packing import code_bytes, pack_codes, unpack_codes

__all__ = [
    "pack_codes",
    "unpack_codes",
    "code_bytes",
    "pad_codes_to_block",
    "padded_count",
    "DEFAULT_BLOCK",
]
