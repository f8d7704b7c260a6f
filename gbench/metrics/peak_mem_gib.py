"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the
program's set-up and the window, in GiB (the benchmark's generator runs
before the peak is reset, its reference after it is read)."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.memory_peak_bytes / 2**30
