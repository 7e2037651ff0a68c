"""field_mul_roofline (kernels, K8 ``field_mul``): the recorded launches'
least time over their device time in the trace, in percent, over the
probe request traced after the window (core/cell.py).

Each launch's shape is recorded by wrapping ``ops/field_kernels.py``'s
``_launch`` for the probe: W words a row, one Montgomery multiply a row,
and the bytes of the operands' distinct elements and of the output.  The
least time is core/roofline.py's ``Bound``; the device time is the sum of
the ``field_mul_kernel`` records."""

from benchmark.core.readers import roofline_share
from benchmark.core.roofline import nbytes

KEY = "field_mul"


def install(run):
    from algoplonk_tpu_torch.ops import field_kernels as fk

    shapes = run.records.setdefault(KEY, [])

    def make(orig):
        def recorded(name, f, xs, op=None):
            out = orig(name, f, xs, op)
            if name == KEY and out.numel():
                shapes.append((f.W, out.numel() // f.W, nbytes(*xs, out)))
            return out
        return recorded

    run.patches.wrap(fk, "_launch", make)


def read(run):
    return roofline_share(run, KEY, "field_mul_kernel")
