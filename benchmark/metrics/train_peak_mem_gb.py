"""train_peak_mem_gb (end to end, training cells): the CUDA allocator's
peak (torch.cuda.max_memory_allocated) over set-up and window, the staged
corpus included, in GB."""


def read(run: dict):
    return run["memory_peak_bytes"] / 1e9 if run.get("kind") == "train" else None
