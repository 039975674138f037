"""stage_refine_ms.render: mean device ms a frame between the refine and end stamps (the ray-drop
refiner inside the render's program).

Read from the program's recorder (`lidargs_torch/utils/profiling.py`
`telemetry`) over the frames that no profiler watched; None for a train
cell, for a frame without a refiner, and for a program without the
recorder, its refine stamp, or a record.
"""


def read(rec):
    if rec.kind != "render":
        return None
    try:
        from lidargs_torch.utils.profiling import telemetry
    except ImportError:            # a program without the recorder
        return None
    return telemetry.metric("stage_refine_ms", "render")
