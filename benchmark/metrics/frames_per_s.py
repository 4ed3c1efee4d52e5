"""frames_per_s (end to end, serving cells): the frames denoised in the
window (16 a clip of 16, 1 an image) over the window's seconds."""


def read(run: dict):
    return run["frames"] / run["window_s"] if run.get("frames") else None
