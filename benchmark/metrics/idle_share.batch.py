"""idle_share.batch (device): 100 (1 - busy / window) over the traced
window of a batch cell.  The launch counters may lose counts under
prove_batch's threads, so the trace's records of the port's kernels are
held to at least what they saw, less 1%."""

from benchmark.core.readers import idle_share


def read(run):
    return idle_share(run, exact_counters=False)
