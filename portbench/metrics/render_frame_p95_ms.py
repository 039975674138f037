"""render_frame_p95_ms: the 95th percentile of every frame of the window,
each timed from its call to its completion on the device (CUDA events)."""
import numpy as np


def read(rec):
    if rec.kind != "render" or not rec.latency_ms:
        return None
    return float(np.percentile(np.asarray(rec.latency_ms), 95))
