"""The entry ``prove_batch``: a request's assignments proved together by
``parallel.batch_prove.prove_batch`` on the traffic's ``streams`` worker
streams, spread over the cell's cards in turn, then marshalled to the AVM
verifier's bytes.  ``call_s`` is the whole batch call's host seconds, for
each of its proofs."""

import time


def request(run, cc, P, items) -> None:
    from algoplonk_tpu_torch.parallel.batch_prove import prove_batch

    streams = run.cell.traffic["streams"]
    devices = [run.devices[i % len(run.devices)] for i in range(streams)]
    t0 = time.perf_counter()
    try:
        vps = prove_batch(cc, [P(**it.assignment) for it in items], devices=devices)
        call = time.perf_counter() - t0
        for item, vp in zip(items, vps):
            if vp is not None:
                item.call_s = call
                run.marshal(vp, item)
    except Exception as e:
        for item in items:
            item.error = f"{type(e).__name__}: {e}"
