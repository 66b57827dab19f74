"""The device memory allocated at its peak inside the window (weights
included), in GiB: ``torch.cuda.max_memory_allocated()`` after
``reset_peak_memory_stats()`` at the window's opening."""


def read(ctx):
    return ctx.timeline.peak_bytes / 2**30
