"""The plain versions of the port's four MSM kernels (K1-K4,
algoplonk_tpu_torch/ops/curve_kernels.py) against the JAX Pallas kernels
they replace, run in interpret mode at tile = 8 as tests/test_pallas_kernels.py
runs them.

Both sides get the same values (port words converted to reference limbs
through ints).  Projective X, Y and Z must be equal mod p, exactly: both run
the same RCB operation sequence.  The lanes cover identity accumulators,
identity points, doublings, cancellations and negated rows.  The CUDA
kernels themselves are held to these plain versions on the GPU
(tests/test_torch_cuda_kernels.py and chip_smoke.py)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algoplonk_tpu.fields import limbs as jax_limbs
from algoplonk_tpu.fields.params import BN254 as JBN254
from algoplonk_tpu.ops import curve_pallas as cp
from algoplonk_tpu_torch import BN254
from algoplonk_tpu_torch._ref.host import fp as hfp
from algoplonk_tpu_torch.fields.words import word_field, words_to_ints
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops.curve import curve_ops
from torch_parity import (  # noqa: F401
    jax_ints,
    mont_words_to_jax_limbs,
    one_torch_thread,
    port_ints,
    sample_points,
)

B = 8      # lanes: one interpret-mode tile
STEPS = 2  # fused steps of K1 and K2

P_MOD = BN254.fp.modulus
F = hfp.GF(P_MOD)


@pytest.fixture(scope="module")
def ops():
    return curve_ops(BN254, "cpu")


def to_jax(lm: torch.Tensor) -> jnp.ndarray:
    """Port limbs-major [C, W, B] words -> reference [C, L, B] limbs."""
    bm = lm.permute(0, 2, 1).numpy()                          # [C, B, W]
    limbs = mont_words_to_jax_limbs(bm, word_field(BN254.fp))  # [C, B, L]
    return jnp.asarray(np.ascontiguousarray(limbs.transpose(0, 2, 1)))


def proj_lm(ops, points) -> torch.Tensor:
    """Affine points (None = identity) -> doubled projective [3, W, B], so
    that Z is not 1 (the doubling of the identity stays the identity)."""
    p = ops.jac_double(ops.affine_to_jac(ops.encode_affine(points)))
    return p.permute(1, 2, 0).contiguous()


def dbl(point):
    return hfp.ec_add(F, point, point)


def assert_same_projective(port_lm, jax_lm):
    """[3k, W, B] port words and [3k, L, B] reference limbs hold the same
    coordinates mod p."""
    got = port_ints(port_lm.permute(0, 2, 1), BN254.fp)
    want = jax_ints(np.asarray(jax_lm).transpose(0, 2, 1), JBN254.fp)
    assert got == want


def operand_points(seed):
    """P (accumulators) and Q (addends) with the special lanes."""
    rng = random.Random(seed)
    P = sample_points(rng, BN254, B)
    Q = sample_points(rng, BN254, B)
    P[0] = None                       # identity accumulator
    Q[1] = None                       # identity addend (bucket padding)
    Q[2] = P[2]                       # doubling
    Q[3] = hfp.ec_neg(F, P[3])        # cancellation
    return P, Q


def test_k3_jac_add_matches_pallas(ops):
    P, Q = operand_points(11)
    p, q = proj_lm(ops, P), proj_lm(ops, Q)
    before = dict(ck.LAUNCHES)
    got = ck.jac_add(ops, p, q)
    assert ck.LAUNCHES == before      # the plain version counts no launch
    assert_same_projective(got, cp.pallas_jac_add(JBN254, tile=8)(to_jax(p), to_jax(q)))
    affine = ops.decode_affine(ops.to_affine(got.permute(2, 0, 1)))
    assert affine == [hfp.ec_add(F, dbl(a), dbl(b)) for a, b in zip(P, Q)]


def test_k1_mixed_add_signed_multi_matches_pallas(ops):
    """Gather from the flat table, per-lane sign, identity row, clamped
    rows: the kernel's fused gather against the reference's gathered rows."""
    rng = random.Random(12)
    P, _ = operand_points(12)
    table_pts = sample_points(rng, BN254, 5) + [P[2], P[3]]   # rows 0..6
    n = len(table_pts)
    pts_flat = torch.cat(
        [ops.encode_affine(table_pts), torch.zeros(1, 2, ops.W, dtype=torch.int32)]
    ).reshape(n + 1, 2 * ops.W)                               # row n = identity
    rows = torch.tensor([[rng.randrange(n + 1) for _ in range(B)] for _ in range(STEPS)])
    sign = torch.tensor([[rng.randrange(2) for _ in range(B)] for _ in range(STEPS)])
    rows[0, 1], rows[0, 2], rows[0, 3] = n, 5, 6   # identity, doubling, P[3]
    sign[0, 2], sign[0, 3] = 0, 1                  # ... and its cancellation
    rows[1, 4] = n + 9                             # beyond the table: clamps
    packed = (rows | (sign << ck.SIGN_SHIFT)).to(torch.int32)
    acc = proj_lm(ops, P)

    got = ck.mixed_add_signed_multi(ops, acc, pts_flat, packed)

    clamped = rows.clamp(max=n).numpy()
    tbl = to_jax(pts_flat.reshape(n + 1, 2, ops.W).permute(1, 2, 0).contiguous())
    tbl = np.asarray(tbl)                                     # [2, L, n+1]
    pts = np.concatenate([tbl[:, :, clamped[k]] for k in range(STEPS)])  # [2g, L, B]
    want = cp.pallas_mixed_add_signed_multi(JBN254, 8, STEPS)(
        to_jax(acc), jnp.asarray(pts), jnp.asarray(sign.numpy().astype(np.int32))
    )
    assert_same_projective(got, want)
    host = []
    for lane in range(B):
        a = dbl(P[lane])
        for k in range(STEPS):
            q = table_pts[clamped[k, lane]] if clamped[k, lane] < n else None
            if q is not None and sign[k, lane]:
                q = hfp.ec_neg(F, q)
            a = hfp.ec_add(F, a, q)
        host.append(a)
    assert ops.decode_affine(ops.to_affine(got.permute(2, 0, 1))) == host


def test_k2_jac_add_multi_scan_matches_pallas(ops):
    P, Q = operand_points(13)
    rng = random.Random(13)
    acc = proj_lm(ops, P)
    q2 = sample_points(rng, BN254, B)
    q2[0] = None
    qs = torch.cat([proj_lm(ops, Q), proj_lm(ops, q2)])       # [3g, W, B]
    got = ck.jac_add_multi_scan(ops, acc, qs)
    assert got.shape == qs.shape
    want = cp.pallas_jac_add_multi_scan(JBN254, 8, STEPS)(to_jax(acc), to_jax(qs))
    assert_same_projective(got, want)
    step0 = [hfp.ec_add(F, dbl(a), dbl(b)) for a, b in zip(P, Q)]
    step1 = [hfp.ec_add(F, a, dbl(b)) for a, b in zip(step0, q2)]
    for k, host in enumerate((step0, step1)):
        aff = ops.to_affine(got[3 * k : 3 * k + 3].permute(2, 0, 1))
        assert ops.decode_affine(aff) == host


def test_k4_canon_matches_pallas(ops):
    """Any 256-bit words -> canonical residues; the reference canonicalises
    relaxed limbs of the same values."""
    rng = random.Random(14)
    vals = [rng.randrange(1 << 256) for _ in range(3 * B - 4)]
    vals += [0, P_MOD, 2 * P_MOD + 1, (1 << 256) - 1]
    x = torch.from_numpy(
        np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4").copy()
    ).reshape(3, B, ops.W).permute(0, 2, 1).contiguous()      # [3, W, B]
    got = ck.canon(ops, x)
    canon_words = got.permute(0, 2, 1).reshape(-1, ops.W).numpy()
    assert words_to_ints(canon_words) == [v % P_MOD for v in vals]
    # the reference takes the same values as relaxed limbs (value + p)
    wf = word_field(BN254.fp)
    canon_ints = [wf.from_mont(v % P_MOD) for v in vals]
    jfp = JBN254.fp
    limbs = jax_limbs.ints_to_limbs([jfp.to_mont(v) + P_MOD for v in canon_ints], jfp)
    jx = jnp.asarray(limbs.reshape(3, B, -1).transpose(0, 2, 1))
    want = cp.pallas_canon(JBN254.fp, 8)(jx)
    assert jax_ints(np.asarray(want).transpose(0, 2, 1), JBN254.fp) == canon_ints
    assert port_ints(got.permute(0, 2, 1), BN254.fp) == canon_ints


def test_wrappers_never_fall_back_off_cpu(ops):
    """A tensor that is not on the CPU never takes the plain version: on a
    device other than CUDA the wrapper refuses it before any build."""
    p = torch.empty((3, ops.W, B), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ck.jac_add(ops, p, p)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ck.canon(ops, p)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ck.jac_add_multi_scan(ops, p, p)
    table = torch.empty((4, 2 * ops.W), dtype=torch.int32, device="meta")
    packed = torch.empty((STEPS, B), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ck.mixed_add_signed_multi(ops, p, table, packed)
