from .loader import SceneData, batch_for_frame, epoch_order, frame_iterator
from .synthetic import make_driving_scene, make_synthetic_scene, write_vkitti_scene
from .fields import DataField
from .degrade import offset_depths, sparsify_depths
