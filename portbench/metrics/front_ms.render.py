"""front_ms.render: device ms of the prefilter, decode and projection (the
"project" row)."""
from portbench.readers import row


def read(rec):
    return row(rec, "render", "project")
