"""refine_roofline.render: the refiner stage's bound a frame over its
device ms (`stage_refine_ms.render`).

The bound is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) of the
stage's `work` (`stages/unet_refiner.py` `counts`), a mean over the
counted frames; None without a traced run, without that stage in the
configuration, or without the stage's time.
"""
import statistics

from portbench import registry

STAGE = "unet_refiner"


def read(rec):
    if rec.kind != "render" or not getattr(rec, "work", None):
        return None
    bounds = [dict(w.stages)[STAGE].ms for w in rec.work if STAGE in dict(w.stages)]
    ms = registry.reader("stage_refine_ms.render")(rec) if bounds else None
    return 100.0 * statistics.mean(bounds) / ms if ms else None
