from mgtpu_torch.parallel.mesh import (
    Mesh,
    all_gather_slices,
    all_reduce_mean,
    fetch_global,
    gather_tree,
    init_multihost,
    is_primary,
    make_mesh,
    mean_metrics,
    own_slice,
    reduce_scatter_mean,
    replicate,
    same_bits,
    shard_batch,
    shard_opt_zero1,
    zero1_spec,
)
from mgtpu_torch.parallel.axis import (
    shard_params_tp,
    spatial_split,
    tp_spec,
    whole_tensors,
)
