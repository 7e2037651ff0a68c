"""The port's large-size path against the JAX package, on the CPU, with
exact equality: the test SRS made on the device as the reference makes it
above 2^16 points (``setups/srs.py:test_only_srs``: tau's powers, their
bits by ``FieldOps.bits_from_mont``, the double-and-add in chunks, the
words cache), and the four-step plan's table eviction
(``FourStepPlan.drop_tables``).

The round-3 quotient with every eviction taken and the prove profile's
phase names are held to the reference's prover in
tests/test_torch_four_step.py, beside its reference proves."""

import numpy as np
import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.host import fp as jhfp
from algoplonk_tpu.setups import registry as jax_registry
from algoplonk_tpu_torch.ops import ntt_kernels as nk
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import field_ops
from algoplonk_tpu_torch.setups import srs as srs_mod
from torch_parity import one_torch_thread  # noqa: F401


def jax_host_srs(name: str, count: int) -> list:
    """[tau^i] G1 for i < count from the JAX package's host arithmetic and
    its test tau: what its test_only_srs computes on the device."""
    curve = getattr(jparams, name)
    F, r = jhfp.GF(curve.fp.modulus), curve.fr.modulus
    tau = jax_registry._test_tau(curve)
    return [jhfp.ec_mul(F, curve.g1, pow(tau, i, r)) for i in range(count)]


@pytest.mark.parametrize("name,count,chunk,reference", [
    ("BN254", 5, 4, "test_only_srs"),       # two chunks, the last cut to one point
    ("BLS12_381", 3, 1 << 16, "host"),      # one chunk, at the 12-word width
])
def test_test_srs_matches_reference_and_its_cache(tmp_path, monkeypatch, name, count, chunk,
                                                  reference):
    """The device-side builder at ``count`` points in chunks of ``chunk``
    equals the reference's test SRS point for point (its test_only_srs on
    BN254, whose jit compile dominates; its host arithmetic on
    BLS12-381); the words cache it writes reads back equal; the SRS
    carries no host points."""
    curve = getattr(apt, name)
    monkeypatch.setattr(srs_mod, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax_registry, "CACHE_DIR", str(tmp_path))
    if reference == "test_only_srs":
        want = jax_registry.test_only_srs(getattr(jparams, name), count).g1
        assert want == jax_host_srs(name, count)
    else:
        want = jax_host_srs(name, count)
    srs = srs_mod.test_only_srs(curve, count, "cpu", chunk=chunk)
    assert srs.g1 == []
    assert tuple(srs.g1_limbs.shape) == (count, 2, curve_ops(curve, "cpu").W)
    assert curve_ops(curve, "cpu").decode_affine(srs.g1_limbs) == want
    words = np.load(tmp_path / f"torch_testsrs_words_{curve.name}_{count}.npz")["g1"]
    assert words.dtype == np.uint32
    again = srs_mod.test_only_srs(curve, count, "cpu", chunk=chunk)
    assert torch.equal(again.g1_limbs, srs.g1_limbs)


@pytest.mark.parametrize("name", ["BN254", "BLS12_381"])
def test_bits_from_mont_matches_host_bits(name):
    fp = getattr(apt, name).fr
    f = field_ops(fp, "cpu")
    p = fp.modulus
    vals = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << (p.bit_length() - 1), 0x5A5A << 200]
    nbits = p.bit_length()
    got = f.bits_from_mont(f.encode(vals), nbits)
    want = [[int(c) for c in format(v, f"0{nbits}b")] for v in vals]
    assert got.dtype == torch.int32
    assert got.tolist() == want


@pytest.mark.parametrize("first", [True, False, None], ids=["inverse", "forward", "both"])
def test_drop_tables_rebuilds_equal_words(first):
    """drop_tables of one direction frees that direction's cross, coset and
    twiddle tables and keeps the rest (of both: every directed table); the
    transforms after it give the same words, and the rebuilt tables are
    equal."""
    fsp = nk.FourStepPlan("bn254", 6, "cpu")
    f, g = fsp.f, apt.BN254.coset_shift
    x = f.encode(list(range(3, 3 + fsp.n)))
    fwd = fsp.ntt_scr(x, coset_shift=g)
    inv = fsp.intt_scr(fwd, coset_shift=g)
    before = {k: v.clone() for k, v in fsp._tables.items()}
    directed = [k for k in before if k[0] in ("tw", "cross", "coset")]
    assert {k[-1] for k in directed} == {False, True}
    fsp.drop_tables(first)
    dropped = {k for k in directed if first is None or k[-1] == first}
    assert dropped and set(fsp._tables) == set(before) - dropped
    assert torch.equal(fsp.intt_scr(fwd, coset_shift=g), inv)
    assert torch.equal(fsp.ntt_scr(x, coset_shift=g), fwd)
    assert set(fsp._tables) == set(before)
    assert all(torch.equal(fsp._tables[k], v) for k, v in before.items())
