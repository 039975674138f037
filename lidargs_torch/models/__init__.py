from .field import (
    AnchorField,
    NeuralGaussians,
    field_splats,
    field_surfels,
    generate_neural_gaussians,
    init_field_params,
    prefilter_anchors,
    render_field,
    render_field_surfel,
    render_fn,
)
from .densify import DensifyStats, densify_step
