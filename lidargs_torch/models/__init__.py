from .field import (
    AnchorField,
    NeuralGaussians,
    generate_neural_gaussians,
    init_field_params,
    render_field,
)
