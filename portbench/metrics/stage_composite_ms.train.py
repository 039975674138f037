"""stage_composite_ms.train: mean device ms a training step between the composite's stamps (K1 or
K5 with its glue), forward plus backward.

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
    return telemetry.metric("stage_composite_ms", "train")
