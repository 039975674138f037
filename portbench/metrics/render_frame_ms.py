"""render_frame_ms: the window's length over the frames it rendered."""


def read(rec):
    return rec.window_s * 1e3 / rec.iterations if rec.kind == "render" and rec.iterations else None
