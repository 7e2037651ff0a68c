"""msm_s (MSM layer): the host seconds inside
``MsmCtx.msm_to_affine_int`` over the traced window, per proof completed
in it.  The benchmark's span adds no synchronise: the method ends in its
own read of the sum back to the host, so the span holds its device work,
and with the card idle most of the time it starts on an empty queue."""


def read(run):
    done = len(run.done)
    total = sum(t1 - t0 for label, t0, t1, _ in run.spans.items if label == "msm")
    return total * 1e-9 / done if done and total else None
