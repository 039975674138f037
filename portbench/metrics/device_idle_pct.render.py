"""device_idle_pct.render: the traced segment's share in which no device
operation ran."""
from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "render")
