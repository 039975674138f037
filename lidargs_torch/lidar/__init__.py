from .beams import (
    helios_beam_inclinations,
    kitti_beam_inclinations,
    uniform_beam_inclinations,
)
from .frames import LidarFrame
