"""device: the share of the window in which no kernel, copy or set ran,
percent."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
