"""glue_s (API layer): per proof of the window, the ``verify`` call's host
seconds less its rounds r1..r5 (``phase_seconds``): the witness solve with
its BSB22 device call, the self-verify and the glue; the mean."""

from benchmark.core.readers import mean


def read(run):
    return mean(p.call_s - sum(p.phase_seconds.values()) for p in run.done)
