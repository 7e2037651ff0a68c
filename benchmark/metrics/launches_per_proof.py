"""launches_per_proof (field ops and dispatch): the port's launch counters
(every kernel, every width) over the window, per proof completed in it.
Exact in one thread only: read in the sequential cells."""


def read(run):
    done = len(run.done)
    return sum(run.launches.values()) / done if done else None
