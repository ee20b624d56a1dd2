"""The card's memory that the fleet's tensors held at their peak, in MiB:
what a deployment of this many cameras needs of one card (the allocator's
peak, read once the window has closed and before the judge runs)."""


def read(ctx):
    return ctx.run.memory_peak_bytes / 2 ** 20
