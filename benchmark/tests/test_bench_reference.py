"""The plain reference against the program on the CPU at tiny sizes: its
constants and keys equal the program's, it accepts the program's proofs
and rejects them with one byte flipped, and it sees a proof made without
blinding."""

import pytest

from benchmark.circuits import rangecommit, squarechain
from benchmark.reference import curves as RC
from benchmark.reference import frontend as RF
from benchmark.reference import plonk as RP

apt = pytest.importorskip("algoplonk_tpu_torch")

CASES = [
    ("squarechain", squarechain, {"log_n": 4}, "bn254"),
    ("rangecommit", rangecommit, {"amounts": 2, "bits": 4}, "bn254"),
    ("squarechain", squarechain, {"log_n": 4}, "bls12_381"),
]


def test_curve_constants_equal_the_programs():
    for name, ours in RC.CURVES.items():
        theirs = {"bn254": apt.BN254, "bls12_381": apt.BLS12_381}[name]
        assert (ours.p, ours.r, ours.b, ours.g1) == (
            theirs.fp.modulus, theirs.fr.modulus, theirs.b, tuple(theirs.g1))
        assert ours.coset_shift == theirs.coset_shift
        for log_n in (4, 10, 17, 20):
            from algoplonk_tpu_torch.fields.params import domain_generator

            assert ours.domain_generator(log_n) == domain_generator(name, log_n)
        from algoplonk_tpu_torch.setups.registry import _test_tau

        assert ours.test_tau() == _test_tau(theirs)


@pytest.fixture(scope="module", params=CASES, ids=[f"{c[0]}-{c[3]}" for c in CASES])
def proved(request):
    """A blinded and an unblinded proof of one assignment, made by the
    program on the CPU, with the reference's keys for the circuit."""
    import random

    from algoplonk_tpu_torch.frontend import witness as W
    from algoplonk_tpu_torch.plonk.marshal import marshal_proof
    from algoplonk_tpu_torch.plonk.prove import Prover

    _, mod, cfg, curve_name = request.param
    curve = {"bn254": apt.BN254, "bls12_381": apt.BLS12_381}[curve_name]
    rc = RC.CURVES[curve_name]
    P = mod.circuit(apt, cfg)
    cc = apt.compile(P, curve, apt.test_only_setup(curve), device="cpu")
    asg = mod.assignment(cfg, rc.r, random.Random(7))
    vp = cc.verify(P(**asg))
    prover = Prover(cc.pk, cc.ccs, rng=False)
    wit = W.solve(cc.ccs, P(**asg), commitment_solver=prover.bsb_solver)
    bare = marshal_proof(curve, prover.prove(wit))
    ccs = RF.compile_circuit(mod.circuit(RF, cfg), rc)
    keys = RP.keys(ccs, rc, rc.test_tau())
    return dict(mod=mod, cfg=cfg, rc=rc, cc=cc, ccs=ccs, keys=keys, asg=asg,
                proof=vp.marshal_proof(), publics=vp.marshal_public_inputs(), bare=bare)


def test_keys_equal_the_programs(proved):
    k, vk = proved["keys"], proved["cc"].vk
    assert (k.n, k.omega, k.k1, k.nb_public) == (vk.size, vk.generator, vk.coset_shift, vk.nb_public)
    for name in ("ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3"):
        assert k.coms[name] == getattr(vk, name), name
    assert k.qcp == list(vk.qcp) and k.commitment_indexes == list(vk.commitment_indexes)


def test_accepts_the_programs_proof_and_rejects_a_flipped_byte(proved):
    rc, keys, ncom = proved["rc"], proved["keys"], len(proved["ccs"].commitments)
    want = proved["mod"].publics(proved["cfg"], rc.r, proved["asg"])
    assert proved["publics"] == b"".join(x.to_bytes(32, "big") for x in want)
    assert RP.verify(keys, RP.parse_proof(rc, proved["proof"], ncom), want)
    assert not RP.verify(keys, RP.parse_proof(rc, proved["proof"], ncom), [(want[0] + 1) % rc.r])
    pt = 2 * rc.nb
    for at in (3, 9 * pt - 1, 6 * pt + 31, 6 * pt + 5 * 32 + 10):   # points and scalars
        bad = bytearray(proved["proof"])
        bad[at] ^= 0x01
        try:
            ok = RP.verify(keys, RP.parse_proof(rc, bytes(bad), ncom), want)
        except ValueError:
            ok = False
        assert not ok, at


def test_sees_a_proof_made_without_blinding(proved):
    rc, keys, ccs = proved["rc"], proved["keys"], proved["ccs"]
    ncom = len(ccs.commitments)
    for blob, unblinded in ((proved["proof"], False), (proved["bare"], True)):
        pf = RP.parse_proof(rc, blob, ncom)
        assert RP.verify(keys, pf, proved["mod"].publics(proved["cfg"], rc.r, proved["asg"]))
        bsb = iter(pf.bsb)
        values = RF.solve(ccs, proved["asg"], commitment_solver=lambda info, c:
                          RP.hash_to_fr(rc, RC.encode_g1(rc, next(bsb))))
        assert (RC.mul(rc, rc.g1, RP.wire_l_at_tau(keys, ccs, values)) == pf.L) is unblinded


def test_hash_to_fr_is_the_programs():
    from algoplonk_tpu_torch.plonk.transcript import hash_fr_bsb22

    for curve in (apt.BN254, apt.BLS12_381):
        rc = RC.CURVES[curve.name]
        for msg in (b"", b"\x01" * 64, bytes(range(96))):
            assert RP.hash_to_fr(rc, msg) == hash_fr_bsb22(curve, msg)


def test_g1_arithmetic():
    for rc in RC.CURVES.values():
        g = rc.g1
        assert RC.on_curve(rc, g) and RC.mul(rc, g, rc.r) is None
        assert RC.msm(rc, [(RC.mul(rc, g, 5), 1), (RC.mul(rc, g, 7), 1)]) == RC.mul(rc, g, 12)
        assert RC.msm(rc, [(g, 1), (g, -1)]) is None
        assert RC.msm(rc, [(g, 3), (g, -1)]) == RC.mul(rc, g, 2)
        assert RC.msm(rc, [(g, 2), (g, 2)]) == RC.mul(rc, g, 4)      # the doubling case
        assert RC.decode_g1(rc, RC.encode_g1(rc, g)) == g
        assert RC.decode_g1(rc, RC.encode_g1(rc, None)) is None
