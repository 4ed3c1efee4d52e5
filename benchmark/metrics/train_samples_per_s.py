"""train_samples_per_s (end to end, training cells): the samples (clips or
crops) of every step done in the window, which ends at its last loss read,
over the window's seconds."""


def read(run: dict):
    return run["samples"] / run["window_s"] if run.get("samples") else None
