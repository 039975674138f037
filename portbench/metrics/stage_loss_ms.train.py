"""stage_loss_ms.train: mean device ms a training step between the loss's stamps, forward
plus backward.

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
    return telemetry.metric("stage_loss_ms", "train")
