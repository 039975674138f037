"""host_gap_ms.render: mean device ms from one frame's end stamp to the next frame's begin
stamp: the device waiting on the host, and the frame's copy.

Read from the program's recorder (`lidargs_torch/utils/profiling.py`
`telemetry`) over the steps or frames that no profiler watched; None for
the other kind of cell and for a program without the recorder or with no
record.
"""


def read(rec):
    if rec.kind != "render":
        return None
    try:
        from lidargs_torch.utils.profiling import telemetry
    except ImportError:            # a program without the recorder
        return None
    return telemetry.metric("host_gap_ms", "render")
