"""mfu.render: the FP32 operations a frame needs over its traced time at
67 TFLOP/s."""
from portbench.readers import mfu


def read(rec):
    return mfu(rec, "render")
