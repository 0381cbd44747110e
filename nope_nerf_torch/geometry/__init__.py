"""Camera model and so(3)/SE(3) maps: the names nope_nerf_tpu/geometry exports."""

from .lie import vec2skew, exp_so3, make_c2w, log_so3, convert3x4_4x4
from .camera import (
    pixel_grid,
    camera_matrix_from_focal,
    intrinsics_ndc,
    intrinsics_ndc_np,
    transform_to_world,
    origin_to_world,
    image_points_to_world,
    transform_to_camera_space,
    project_to_cam,
    get_ndc_rays_fxfy,
    rays_from_pixels,
)
