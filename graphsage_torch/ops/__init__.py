from graphsage_torch.ops.sampling import sample_neighbors, full_neighbors
from graphsage_torch.ops.aggregate import (
    masked_max,
    masked_mean,
    gather,
    spmm_mean,
    segment_max_csr,
    segment_mean_csr,
)

# The kernel modules are graphsage_torch.ops.gather_mean and
# graphsage_torch.ops.spmm; the gather_mean dispatcher lives in
# graphsage_torch.ops.aggregate so that it does not shadow its module's name.
__all__ = [
    "sample_neighbors",
    "full_neighbors",
    "masked_max",
    "masked_mean",
    "gather",
    "spmm_mean",
    "segment_max_csr",
    "segment_mean_csr",
]
