"""Decode loop: the window's wall time over the beam steps the window's
decodes ran (``Captioner.decode_steps``), in ms a step."""


def read(r):
    steps = r.data.get("steps")
    return r.data["window_s"] / steps * 1e3 if steps else None
