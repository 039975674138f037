"""loss_ms.train: device ms of the loss (row "+ loss" less "render")."""
from portbench.readers import row


def read(rec):
    return row(rec, "train", "+ loss", "render")
