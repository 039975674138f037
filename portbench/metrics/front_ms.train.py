"""front_ms.train: device ms of the prefilter, decode and projection with
their backward (the "grad project" row)."""
from portbench.readers import row


def read(rec):
    return row(rec, "train", "grad project")
