from .ply import read_ply, write_ply
from .waymo import SceneData, read_lidar_scene
from .scene import Scene
