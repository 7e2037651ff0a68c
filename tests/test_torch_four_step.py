"""The port's four-step NTT (ops/ntt_kernels.py) and four-step quotient
(``Prover._quotient_lm``) against the JAX reference's ``ops/ntt_pallas.py``
and ``_quotient_lm``.

The reference's Pallas kernels run in interpret mode on the CPU, as
tests/test_ntt_pallas.py runs them; the port's K9 runs its plain version.
Every comparison is exact: decoded ints, position by position (the port's
row p against the reference's column p), or proof bytes.  The reference
proves once per quotient path (``reference``), with its table eviction
taken at every size (AP_QUOTIENT_SYNC_MIN_LOG=0; the port's
``EVICT_MIN_LOG`` set to 0 to match) and under AP_PROVE_PROFILE=1, and the
port's prove tests share its bytes and its phase names.  The reference's
path is forced by its AP_QUOTIENT_LM (``FOUR_STEP``, ``BATCH_MAJOR``), the
port's by its constant ``LM_MIN_LOG`` (0, or above any coset)."""

import contextlib
import io
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.frontend import witness as jax_witness
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu.ops.ntt_pallas import _pass_kernel
from algoplonk_tpu.ops.ntt_pallas import four_step_plan as jax_four_step_plan
from algoplonk_tpu.plonk.marshal import marshal_proof as jax_marshal
from algoplonk_tpu.plonk.prove import Prover as JaxProver
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.ops import ntt_kernels as nk
from algoplonk_tpu_torch.ops.field import field_ops
from algoplonk_tpu_torch.plonk import prove as prove_mod
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import jax_ints, one_commit, one_torch_thread, pythagorean  # noqa: F401

BN254 = apt.BN254
R = BN254.fr.modulus
G = BN254.coset_shift
PHASE = re.compile(r"^  prove phase (.+?): \d+\.\d\ds(?:  \[hbm .*\])?$", re.M)
FOUR_STEP = {"AP_QUOTIENT_LM": "1"}     # the reference's variables
BATCH_MAJOR = {"AP_QUOTIENT_LM": "0"}
NEVER = 64                                 # an LM_MIN_LOG above any coset
EVICT_ALL = {"AP_QUOTIENT_SYNC_MIN_LOG": "0"}   # the reference's threshold
EVICT_MIN_LOG = prove_mod.EVICT_MIN_LOG           # the port's


def rand_ints(seed: int, n: int) -> list[int]:
    rng = random.Random(seed)
    return [0, 1, R - 1] + [rng.randrange(R) for _ in range(n - 3)]


@pytest.fixture(scope="module")
def fields():
    return jax_field_ops(jparams.BN254.fr), field_ops(BN254.fr, "cpu")


def to_lm(jf, ints):
    """ints -> the reference's limbs-major [L, n] Montgomery array."""
    return jnp.asarray(np.asarray(jf.encode(ints)).T)


def from_lm(lm) -> list[int]:
    return jax_ints(np.asarray(lm).T, jparams.BN254.fr)


@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("fused", [False, True], ids=["bare", "entry_exit"])
def test_plain_pass_matches_reference_pass_kernel(fields, inverse, fused):
    """plain_ntt_pass equals the reference's _pass_kernel (which launches K9) at
    N = 64, C = 8, with and without the fused entry and exit multiplies."""
    jf, tf = fields
    N, C = 64, 8
    xs, en, ex = rand_ints(1, N), rand_ints(2, N), rand_ints(3, N)
    run = _pass_kernel("bn254", C, N, inverse, fused, fused)
    kw = dict(entry=to_lm(jf, en), exit_=to_lm(jf, ex)) if fused else {}
    want = from_lm(run(to_lm(jf, xs), **kw))
    tw = tf.encode(nk.stage_twiddles("bn254", C, inverse))
    tkw = dict(entry=tf.encode(en), exit_=tf.encode(ex)) if fused else {}
    launches = nk.LAUNCHES["ntt_pass"]
    got = nk.ntt_pass(tf, tf.encode(xs), tw, C, inverse, **tkw)
    assert tf.decode(got) == want
    assert nk.LAUNCHES["ntt_pass"] == launches   # CPU tensors: the plain version


@pytest.mark.parametrize("log_n,shift", [(4, None), (6, G)], ids=["n16", "n64-coset"])
def test_transforms_match_reference_four_step(fields, log_n, shift):
    """ntt_scr / intt_scr against ntt_scr_lm / intt_scr_lm, row p of the
    port against column p of the reference; the round trip is the identity."""
    jf, tf = fields
    coeffs = rand_ints(10 + log_n, 1 << log_n)
    jfs = jax_four_step_plan("bn254", log_n)
    tfs = nk.four_step_plan("bn254", log_n, "cpu")
    assert (tfs.n1, tfs.n2) == (jfs.n1, jfs.n2)
    assert np.array_equal(tfs.scramble_perm(), jfs.scramble_perm())
    got = tfs.ntt_scr(tf.encode(coeffs), coset_shift=shift)
    want = from_lm(jfs.ntt_scr_lm(to_lm(jf, coeffs), coset_shift=shift))
    assert tf.decode(got) == want
    back = tfs.intt_scr(got, coset_shift=shift)
    assert tf.decode(back) == coeffs
    assert tf.decode(back) == from_lm(jfs.intt_scr_lm(to_lm(jf, want), coset_shift=shift))


def test_scrambled_order_tables_match_reference(fields):
    jf, tf = fields
    jfs = jax_four_step_plan("bn254", 6)
    tfs = nk.four_step_plan("bn254", 6, "cpu")
    assert tf.decode(tfs.coset_x_scr(G)) == from_lm(jfs.coset_x_scr(G))
    pattern = rand_ints(20, 4)
    assert tf.decode(tfs.tile_by_k_mod4(pattern)) == from_lm(jfs.tile_by_k_mod4(pattern))


def jax_prove(jcc, JPyth, env: dict):
    """The reference's Prover(rng=False) proof bytes and its profile's phase
    names under ``env`` and AP_PROVE_PROFILE=1."""
    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(err):
        for k, v in {**env, "AP_PROVE_PROFILE": "1"}.items():
            mp.setenv(k, v)
        prover = JaxProver(jcc.pk, jcc.ccs, rng=False)
        proof = prover.prove(jax_witness.solve(jcc.ccs, JPyth(a=3, b=4, c=5)))
    return jax_marshal(ap.BN254, proof), PHASE.findall(err.getvalue())


@pytest.fixture(scope="module")
def reference():
    """The reference's proves of the Pythagorean circuit: through its
    _quotient_lm with every table eviction taken, and batch-major."""
    JPyth = pythagorean(ap)
    jcc = ap.compile(JPyth, ap.BN254, ap.SetupName.TEST_ONLY_BN254)
    return {"four_step": jax_prove(jcc, JPyth, {**FOUR_STEP, **EVICT_ALL}),
            "batch_major": jax_prove(jcc, JPyth, BATCH_MAJOR)}


@pytest.fixture(scope="module")
def port_circuit():
    TPyth = pythagorean(apt)
    return apt.compile(TPyth, BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu"), TPyth


def port_prove(cc, TPyth, monkeypatch, four_step: bool, check_path: bool = False,
               evict_all: bool = False, profile: bool = False) -> bytes:
    """The port's Prover(rng=False) proof bytes through the quotient path
    ``four_step`` picks, with AP_PROVE_PROFILE=1 where ``profile``."""
    monkeypatch.delenv("AP_PROVE_PROFILE", raising=False)
    if profile:
        monkeypatch.setenv("AP_PROVE_PROFILE", "1")
    monkeypatch.setattr(prove_mod, "LM_MIN_LOG", 0 if four_step else NEVER)
    monkeypatch.setattr(prove_mod, "EVICT_MIN_LOG", 0 if evict_all else EVICT_MIN_LOG)
    prover = Prover(cc.pk, cc.ccs, rng=False)
    if check_path:
        assert prover._use_lm_quotient() == four_step
    wit = witness_mod.solve(cc.ccs, TPyth(a=3, b=4, c=5), commitment_solver=prover.bsb_solver)
    proof = prover.prove(wit)
    assert V.verify(cc.vk, proof, [3, 4])
    return marshal_proof(BN254, proof)


def test_lm_quotient_proof_matches_jax_and_batch_major(reference, port_circuit, monkeypatch):
    """Prover(rng=False) through _quotient_lm: the JAX prover's
    _quotient_lm proof bytes, and the port's own _quotient proof bytes."""
    cc, TPyth = port_circuit
    want = reference["four_step"][0]
    for four_step in (True, False):
        assert port_prove(cc, TPyth, monkeypatch, four_step, True) == want


@pytest.mark.parametrize("max_c", [4, 2])
def test_split_quotient_proof_matches_jax(reference, port_circuit, monkeypatch, max_c):
    """Prover(rng=False) through _quotient_lm with ops/ntt_kernels.py's
    MAX_C set low, so that the four-step passes above it run their top
    stages over HBM (ntt_stage's plain version) before or after K9's: the
    JAX prover's _quotient_lm bytes.  On the 4n = 32 coset (n1 = 4, n2 = 8)
    MAX_C = 4 splits P2 and P2', MAX_C = 2 every pass."""
    cc, TPyth = port_circuit
    halves = []
    real = nk.plain_ntt_stage

    def counted(f, x, tw, C, h, *a, **kw):
        halves.append((C, h))
        return real(f, x, tw, C, h, *a, **kw)

    monkeypatch.setattr(nk, "plain_ntt_stage", counted)
    monkeypatch.setattr(nk, "MAX_C", max_c)
    assert port_prove(cc, TPyth, monkeypatch, True) == reference["four_step"][0]
    assert {C for C, _ in halves} == ({8} if max_c == 4 else {4, 8})
    assert all(h >= max_c for _, h in halves)


def test_evicting_quotient_matches_reference_and_no_eviction(reference, port_circuit,
                                                            monkeypatch):
    """The four-step prove with every table eviction taken (both drops, in
    the reference's order) gives the reference's bytes under the same
    variables, and the port's bytes without eviction."""
    cc, TPyth = port_circuit
    drops = []
    keep = nk.FourStepPlan.drop_tables

    def spy(plan, inverse=None):
        drops.append(inverse)
        keep(plan, inverse)

    monkeypatch.setattr(nk.FourStepPlan, "drop_tables", spy)
    evicting = port_prove(cc, TPyth, monkeypatch, True, evict_all=True)
    assert drops == [True, False]
    kept = port_prove(cc, TPyth, monkeypatch, True)
    assert drops == [True, False]   # the default threshold (a coset of 2^21) is not reached
    assert evicting == reference["four_step"][0]
    assert kept == evicting


@pytest.mark.parametrize("path", ["four_step", "batch_major"])
def test_profile_phase_names_match_reference(reference, port_circuit, monkeypatch, capfd, path):
    """Under AP_PROVE_PROFILE=1 the port prints the reference's phase names
    in its order (the seven r3 sub-phases on the four-step path only), and
    its bytes stay the reference's; unset, it prints nothing."""
    cc, TPyth = port_circuit
    four_step = path == "four_step"
    want_bytes, want_names = reference[path]
    assert len([n for n in want_names if n.startswith("r3.")]) == (8 if four_step else 1)
    capfd.readouterr()
    assert port_prove(cc, TPyth, monkeypatch, four_step, evict_all=four_step,
                      profile=True) == want_bytes
    assert PHASE.findall(capfd.readouterr().err) == want_names
    assert port_prove(cc, TPyth, monkeypatch, four_step, evict_all=four_step) == want_bytes
    assert capfd.readouterr().err == ""


def test_lm_quotient_path_rule(monkeypatch):
    """The reference's rule at its default: the four-step quotient from a
    coset of 2^LM_MIN_LOG (19) on, read at each call.  The reference's
    variables do not move the port."""
    cc = apt.compile(pythagorean(apt), BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    prover = Prover(cc.pk, cc.ccs, rng=False)
    log4 = cc.pk.log_n + 2
    assert prove_mod.LM_MIN_LOG == 19
    assert not prover._use_lm_quotient()
    monkeypatch.setattr(prove_mod, "LM_MIN_LOG", log4)
    assert prover._use_lm_quotient()
    monkeypatch.setattr(prove_mod, "LM_MIN_LOG", log4 + 1)
    assert not prover._use_lm_quotient()
    monkeypatch.undo()
    monkeypatch.setenv("AP_QUOTIENT_LM", "1")
    monkeypatch.setenv("AP_NTT_LM_MIN_LOG", "0")
    assert not Prover(cc.pk, cc.ccs, rng=False)._use_lm_quotient()


def test_bsb22_prove_verify_through_four_step(monkeypatch):
    monkeypatch.setattr(prove_mod, "LM_MIN_LOG", 0)
    TOne = one_commit(apt)
    cc = apt.compile(TOne, BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    vp = cc.verify(TOne(x=49, y=7))
    assert len(vp.proof.bsb_commitments) == 1
    assert V.verify(cc.vk, vp.proof, [49])
    assert not V.verify(cc.vk, vp.proof, [50])
