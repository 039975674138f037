"""raster_ms.render: device ms of the cull sort, bin sort and gather (row
"gather" less "project")."""
from portbench.readers import row


def read(rec):
    return row(rec, "render", "gather", "project")
