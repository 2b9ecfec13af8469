"""peak_device_gb: `torch.cuda.max_memory_allocated` from the port's layout
to the window's close (the benchmark's graph generator runs before and is
not counted), in GB of 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
