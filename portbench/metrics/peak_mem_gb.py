"""peak_mem_gb (GB), the device: ``torch.cuda.max_memory_allocated()``
over the window, after ``reset_peak_memory_stats()`` at its start; it
holds the weights, the int8 weight cache and the KV pool, which stay
allocated through the window."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 1e9
