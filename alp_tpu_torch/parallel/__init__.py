"""Multi-device data parallelism over ``torch.distributed`` (NCCL on cards,
gloo on the CPU): rowgroups of 1024-value vectors split over the ranks of
a 1-D mesh.  Importing this package starts no process group; the caller
starts one and builds the mesh with :func:`make_mesh`."""

from .container_par import compress_sharded, decompress_sharded
from .sharded import (ColumnShare, column_share, gather_rows,
                      join_rank_totals, make_mesh, share_decode,
                      share_filter_count, share_filter_sum, share_groupby,
                      share_mean, share_sum, sharded_decode,
                      sharded_encode_decode_step, sharded_exact_sum,
                      sharded_filter_count, sharded_groupby)

__all__ = ["ColumnShare", "column_share", "compress_sharded",
           "decompress_sharded", "gather_rows", "join_rank_totals",
           "make_mesh", "share_decode", "share_filter_count",
           "share_filter_sum", "share_groupby", "share_mean", "share_sum",
           "sharded_decode", "sharded_encode_decode_step",
           "sharded_exact_sum", "sharded_filter_count", "sharded_groupby"]
