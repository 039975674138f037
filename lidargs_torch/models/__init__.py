from .field import (
    AnchorField,
    NeuralGaussians,
    field_splats,
    generate_neural_gaussians,
    init_field_params,
    prefilter_anchors,
    render_field,
)
from .densify import DensifyStats, densify_step
