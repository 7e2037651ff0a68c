"""The gnark-compat mode reaches every cache of the port that depends on it.

The port keeps its own copy of the reference's ``fields/params.py``, whose
``set_gnark_compat`` must clear the port's MiMC round constants and
four-step plans.  Both entry points are checked (the package's and the one
on ``algoplonk_tpu_torch.fields.params``), each against the JAX package
after its own toggle; both modes are restored afterwards."""

import random

import pytest

import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.host import mimc as jmimc
from algoplonk_tpu_torch.fields import params as tparams
from algoplonk_tpu_torch.host import mimc as tmimc
from algoplonk_tpu_torch.ops.ntt import ntt_plan
from algoplonk_tpu_torch.ops.ntt_kernels import four_step_plan
from torch_parity import one_torch_thread  # noqa: F401

ENTRY_POINTS = {
    "apt.set_gnark_compat": apt.set_gnark_compat,
    "fields.params.set_gnark_compat": tparams.set_gnark_compat,
}


@pytest.fixture
def native_mode_after():
    yield
    tparams.set_gnark_compat(False)
    jparams.set_gnark_compat(False)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_mimc_round_constants_follow_toggle(entry, native_mode_after):
    toggle = ENTRY_POINTS[entry]
    r = apt.BN254.fr.modulus
    native = tmimc.round_constants("bn254", r)              # cached in native mode
    assert native == jmimc.round_constants("bn254", r)
    toggle(True)
    jparams.set_gnark_compat(True)
    gnark = jmimc.round_constants("bn254", r)
    assert gnark != native
    assert tmimc.round_constants("bn254", r) == gnark
    toggle(False)
    jparams.set_gnark_compat(False)
    assert tmimc.round_constants("bn254", r) == native


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_four_step_plan_not_reused_across_toggle(entry, native_mode_after):
    """On BLS12-381's scalar field the two modes give different domain
    roots: a plan built before a toggle is never served after it, and the
    new plan transforms with the new mode's roots."""
    toggle = ENTRY_POINTS[entry]
    log_n = 4
    before = four_step_plan("bls12_381", log_n, "cpu")
    toggle(True)
    after = four_step_plan("bls12_381", log_n, "cpu")
    assert after is not before
    assert after.omega == tparams.domain_generator("bls12_381", log_n) != before.omega
    f = after.f
    rng = random.Random(5)
    coeffs = [rng.randrange(f.modulus) for _ in range(after.n)]
    want = f.decode(ntt_plan("bls12_381", log_n, "cpu").ntt(f.encode(coeffs)))
    got = f.decode(after.ntt_scr(f.encode(coeffs)))
    assert got == [want[k] for k in after.scramble_perm()]
    toggle(False)
    assert four_step_plan("bls12_381", log_n, "cpu") is not after
