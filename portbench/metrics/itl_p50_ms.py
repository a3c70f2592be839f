"""Median of every gap between two consecutive output tokens of one
request, over all requests, by the host's clock (ms): every gap whose
two tokens were both emitted in the window. Where most ticks carry no
prefill it is a decode tick as the clients see it."""
from metrics._stats import itl_gaps_ms, pct


def read(run, name):
    return pct(itl_gaps_ms(run), 50)
