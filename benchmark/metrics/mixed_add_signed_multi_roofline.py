"""mixed_add_signed_multi_roofline (kernels, K1): the recorded launches'
least time over their device time in the trace, in percent, over the
probe request traced after the window (core/cell.py).

Each launch's shape is recorded by wrapping ``ops/msm.py``'s
``mixed_add_signed_multi`` for the probe: B lanes each adding g signed
affine points, 11 Montgomery multiplies an add at the width W of the base
field; bytes: the accumulator in and out, the packed indices, and each
gathered point row read once (at most the table's rows).  The least time
is core/roofline.py's ``Bound``; the device time is the sum of the
``mixed_add_signed_multi_kernel`` records."""

from benchmark.core.readers import roofline_share
from benchmark.core.roofline import MIXED_ADD_MULS, nbytes

KEY = "mixed_add_signed_multi"


def install(run):
    from algoplonk_tpu_torch.ops import msm as M

    shapes = run.records.setdefault(KEY, [])

    def make(orig):
        def recorded(ops, acc, pts_flat, packed):
            out = orig(ops, acc, pts_flat, packed)
            B, g, W = acc.shape[-1], packed.shape[0], ops.W
            rows = min(g * B, pts_flat.shape[0])
            moved = nbytes(acc, packed, out) + rows * pts_flat.shape[1] * pts_flat.element_size()
            shapes.append((W, g * B * MIXED_ADD_MULS, moved))
            return out
        return recorded

    run.patches.wrap(M, "mixed_add_signed_multi", make)


def read(run):
    return roofline_share(run, KEY, "mixed_add_signed_multi_kernel")
