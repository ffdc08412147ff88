"""ops.probe_walk: the probe_walk_filter kernel's device time in the
window, nanoseconds a read."""

from portbench.readers import kernel_per_item


def read(ctx):
    return kernel_per_item(ctx, "probe_walk_filter", 1e9)
