"""launches_per_frame (model and fused loops): the kernel launches the
program's wrappers counted in the window (kernels.lista3d.launches, 2D and
3D names summed) over the frames served (16 a clip, 1 an image)."""


def read(run: dict):
    return run["launches"] / run["frames"] if run.get("frames") else None
