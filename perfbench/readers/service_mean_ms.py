"""Mean arrival-to-last-token milliseconds over every request due in the
window (the paper's objective, Eqn 2)."""
from perfbench import layers


def read(rec):
    d = layers.delays_s(rec)
    return float(d.mean() * 1e3) if d.size else None
