from qadc_tpu_torch.io.checkpoint import load_index, save_index
from qadc_tpu_torch.io.quantizer_files import load_quantizer_file, save_quantizer_file
from qadc_tpu_torch.io.stream import VectorStream
from qadc_tpu_torch.io.vecs import load_vectors, save_vectors, split_vecs, vecs_info

__all__ = [
    "load_vectors",
    "save_vectors",
    "vecs_info",
    "split_vecs",
    "VectorStream",
    "load_quantizer_file",
    "save_quantizer_file",
    "save_index",
    "load_index",
]
