from .loader import SceneData
from .synthetic import make_driving_scene, make_synthetic_scene
