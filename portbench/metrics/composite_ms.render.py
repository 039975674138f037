"""composite_ms.render: device ms of the composite kernels a frame."""
from portbench.readers import composite_ms


def read(rec):
    return composite_ms(rec, "render")
