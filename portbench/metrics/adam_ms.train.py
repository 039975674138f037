"""adam_ms.train: device ms of the Adam update (row "+ adam" less "+ grad")."""
from portbench.readers import row


def read(rec):
    return row(rec, "train", "+ adam", "+ grad")
