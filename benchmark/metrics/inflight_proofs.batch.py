"""inflight_proofs.batch (batch proving): the sum over the window's proofs
of their rounds r1..r5 (each prover's ``phase_seconds``, marked on its own
stream) over the window's time: how many proofs overlap on average."""


def read(run):
    if not run.done or run.window_s <= 0:
        return None
    return sum(sum(p.phase_seconds.values()) for p in run.done) / run.window_s
