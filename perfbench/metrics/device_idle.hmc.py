"""The traced window's share in which no device operation ran: 1 minus the
union of the device's busy intervals over the window."""

from perfbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
