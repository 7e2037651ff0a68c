"""idle_share.seq (device): 100 (1 - busy / window) over the traced
window, busy being the union of every device record's interval; read only
where the trace holds the port's kernel launches as its counters (exact in
one thread) saw them, less at most 1% lost."""

from benchmark.core.readers import idle_share


def read(run):
    return idle_share(run, exact_counters=True)
