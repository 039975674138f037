"""composite_ms.train: device ms of the composite kernels a step."""
from portbench.readers import composite_ms


def read(rec):
    return composite_ms(rec, "train")
