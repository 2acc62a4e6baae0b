"""Sharded search over torch.distributed (counterpart of qadc_tpu/dist)."""

from qadc_tpu_torch.dist.mesh import make_mesh
from qadc_tpu_torch.dist.sharded import (
    search_adc_flat_sharded,
    search_qadc_flat_sharded,
    search_query_parallel,
    shard_flat_codes,
)
from qadc_tpu_torch.dist.sharded_ivf import (
    load_sharded_index,
    search_qadc_ivf_sharded,
    shard_ivf_partitions,
)

__all__ = [
    "make_mesh",
    "shard_flat_codes",
    "search_qadc_flat_sharded",
    "search_adc_flat_sharded",
    "search_query_parallel",
    "shard_ivf_partitions",
    "search_qadc_ivf_sharded",
    "load_sharded_index",
]
