"""The padded frame-rows of the plans the window ran, Σ(B·Tb - valid
frames), over all their frame-rows."""


def read(ctx):
    w = ctx["window"]
    if not w.get("frame_rows"):
        return None
    return 100.0 * (w["frame_rows"] - w["valid_frames"]) / w["frame_rows"]
