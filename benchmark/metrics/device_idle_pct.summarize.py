"""Share of the traced summarize window in which no operation ran on the
device (the union of the device's operations' intervals)."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
