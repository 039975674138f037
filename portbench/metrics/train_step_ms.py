"""train_step_ms: the window's length over the training iterations it
completed (densify calls and loss reads included)."""


def read(rec):
    return rec.window_s * 1e3 / rec.iterations if rec.kind == "train" and rec.iterations else None
