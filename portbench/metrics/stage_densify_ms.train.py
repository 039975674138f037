"""stage_densify_ms.train: mean device ms of a densify call, between its eager stamps.

Read from the program's recorder (`lidargs_torch/utils/profiling.py`
`telemetry`) over the steps or frames that no profiler watched; None for
the other kind of cell and for a program without the recorder or with no
record.
"""


def read(rec):
    if rec.kind != "train":
        return None
    try:
        from lidargs_torch.utils.profiling import telemetry
    except ImportError:            # a program without the recorder
        return None
    return telemetry.metric("stage_densify_ms", "train")
