"""setup_s: seconds from the process's start to the start of the window."""


def read(rec):
    return rec.setup_s
