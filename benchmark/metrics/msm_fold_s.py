"""msm_fold_s (MSM layer): the program's ``msm.fold`` spans, the host-int
Horner over each device MSM's window sums after their read back
(``MsmCtx._host_fold``), seconds per proof of the traced window
(core/program_spans.py)."""

from benchmark.core.program_spans import spans_per_proof


def read(run):
    return spans_per_proof(run, "msm.fold")
