from .mesh import Mesh, default_mesh, make_mesh
from .multihost import (
    globalize_replicated,
    host_frame_schedule,
    host_image_tiles,
    host_ray_slice,
    process_count,
    process_index,
    rank_zero_first,
)
from .sharding import (
    all_gather_tiled,
    make_sharded_train_step,
    psum,
    pvary,
    sharded_compute_step_loss,
)
