"""densify_ms.train: mean host ms of the window's densify calls, each to the
host's read of its grown count."""


def read(rec):
    if rec.kind != "train" or not rec.densify_s:
        return None
    return 1e3 * sum(rec.densify_s) / len(rec.densify_s)
