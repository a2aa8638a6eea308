from decompdiff_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather_rows, all_reduce_mean, barrier, broadcast_,
    broadcast_object, destroy_mesh, draw_rows, gather_objects, make_mesh,
    shard_batch, take_rows)
