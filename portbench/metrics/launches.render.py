"""launches.render: device operations a frame in the traced segment."""
from portbench.readers import launches


def read(rec):
    return launches(rec, "render")
