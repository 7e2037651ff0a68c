"""The entry ``verify``: each assignment of a request proved in turn by
``CompiledCircuit.verify`` (witness solve, prove, self-verify), then
marshalled to the AVM verifier's bytes.  ``call_s`` is the verify call's
host seconds."""

import time


def request(run, cc, P, items) -> None:
    for item in items:
        t0 = time.perf_counter()
        try:
            vp = cc.verify(P(**item.assignment))
            item.call_s = time.perf_counter() - t0
            run.marshal(vp, item)
        except Exception as e:     # a failed proof is counted, not fatal
            item.error = f"{type(e).__name__}: {e}"
