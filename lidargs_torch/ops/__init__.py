from .projection import (
    PackedCols,
    Splats,
    build_cov3d,
    pack_splats,
    preprocess_gaussians,
    preprocess_gaussians_hv,
    quat_to_rotmat,
)
from .composite import CompositeOut, composite_depth_ordered, composite_packed
from .composite_kernel import (
    CompositeTiles,
    composite_tiles,
    composite_tiles_bwd,
    composite_tiles_bwd_plain,
    composite_tiles_plain,
)
from .reference import render_reference
from .rasterize import RenderOut, render_tiled
from .surfel import SurfelCols, SurfelOut, preprocess_surfels, render_surfels, surfel_composite
from .surfel_kernel import (
    SurfelCompositeTiles,
    surfel_composite_tiles,
    surfel_composite_tiles_bwd,
    surfel_composite_tiles_bwd_plain,
    surfel_composite_tiles_plain,
)
