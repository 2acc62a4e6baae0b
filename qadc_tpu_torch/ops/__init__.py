from qadc_tpu_torch.ops.kmeans import kmeans, kmeans_plusplus_init
from qadc_tpu_torch.ops.knn import assign_nearest, exact_knn
from qadc_tpu_torch.ops.quantization import keep_prefix_bound, quantize_tables_int8
from qadc_tpu_torch.ops.tables import adc_tables
from qadc_tpu_torch.ops.topk import merge_topk, window_min_reduce

# As in the JAX package, the name `kmeans` here is the function: import the
# module as qadc_tpu_torch.ops.kmeans (importlib), not from this package.
__all__ = [
    "adc_tables",
    "exact_knn",
    "assign_nearest",
    "kmeans",
    "kmeans_plusplus_init",
    "quantize_tables_int8",
    "keep_prefix_bound",
    "window_min_reduce",
    "merge_topk",
]
