"""raster_ms.train: device ms of the cull sort, bin sort and gather with
their backward (row "grad gather" less "grad project")."""
from portbench.readers import row


def read(rec):
    return row(rec, "train", "grad gather", "grad project")
