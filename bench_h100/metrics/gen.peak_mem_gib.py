"""gen.peak_mem_gib: the most device memory PyTorch's allocator held at
once in the window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(rec):
    return rec.counters["window_peak_bytes"] / 2**30
