"""launches.train: device operations a training iteration (densify included) in the traced segment."""
from portbench.readers import launches


def read(rec):
    return launches(rec, "train")
