"""ops.probe_walk: the least time of the cell's distinct reads' launches
over their device time, percent."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "probe_walk_filter")
