"""composite_roofline.render: the composite kernels' bound over their
device ms."""
from portbench.readers import composite_roofline


def read(rec):
    return composite_roofline(rec, "render")
