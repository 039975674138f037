from .field import (
    AnchorField,
    NeuralGaussians,
    field_splats,
    field_surfels,
    generate_neural_gaussians,
    init_field_from_points,
    init_field_params,
    prefilter_anchors,
    render_field,
    render_field_surfel,
    render_fn,
    voxelize_points,
)
from .densify import DensifyStats, densify_step
