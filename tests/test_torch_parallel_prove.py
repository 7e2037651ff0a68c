"""``Prover(mesh=...)`` against the JAX reference: on a mesh of four CPU
shards, every commit runs the sharded MSM and every size-n iNTT, quotient
lift and final coset iNTT the sharded NTT, and with blinding off the proof
is the reference's single-device proof byte for byte.  The reference's n =
16 SquareChain (tests/test_parallel.py) factors its n-point iNTTs as 4 x 4
and the 4n coset as 8 x 8, so all of them shard over four shards.  On the
CPU each shard's MSM runs the kernels' plain versions, about 20 s a
commit."""

import pytest

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu.frontend import witness as jax_witness
from algoplonk_tpu.plonk.marshal import marshal_proof as jax_marshal
from algoplonk_tpu.plonk.prove import Prover as JaxProver
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.parallel import Mesh
from algoplonk_tpu_torch.plonk import prove as prove_mod
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import one_torch_thread  # noqa: F401

CHAIN = 12   # 13 constraints + 1 public row -> n = 16
X = 0xBEEF


def square_chain(pkg):
    class SquareChain(pkg.Circuit):
        y = pkg.PublicInput()
        x = pkg.SecretInput()

        def define(self, api):
            t = self.x
            for _ in range(CHAIN):
                t = api.mul(t, t)
            api.assert_is_equal(t, self.y)

    return SquareChain


def assignment(pkg):
    r = pkg.BN254.fr.modulus
    return square_chain(pkg)(x=X % r, y=pow(X % r, 1 << CHAIN, r))


@pytest.fixture(scope="module")
def jax_bytes():
    cc = ap.compile(square_chain(ap), ap.BN254, ap.SetupName.TEST_ONLY_BN254)
    assert cc.pk.n == 16, cc.pk.n
    prover = JaxProver(cc.pk, cc.ccs, rng=False)
    wit = jax_witness.solve(cc.ccs, assignment(ap), commitment_solver=prover.bsb_solver)
    return jax_marshal(ap.BN254, prover.prove(wit))


@pytest.fixture(scope="module")
def sharded():
    cc = apt.compile(square_chain(apt), apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    prover = Prover(cc.pk, cc.ccs, rng=False, mesh=Mesh(["cpu"] * 4))
    wit = witness_mod.solve(cc.ccs, assignment(apt), commitment_solver=prover.bsb_solver)
    return cc, prover, wit, prover.prove(wit)


def test_sharded_prove_matches_reference(jax_bytes, sharded):
    cc, prover, wit, proof = sharded
    # 5 size-n iNTTs (l, r, o, z, qk), 13 lifts and the coset iNTT
    assert prover.sharding.ntt_hits == 19
    assert marshal_proof(apt.BN254, proof) == jax_bytes
    assert V.verify(cc.vk, proof, wit.public_values)
    r = apt.BN254.fr.modulus
    assert not V.verify(cc.vk, proof, [(wit.public_values[0] + 1) % r])


@pytest.mark.parametrize("mesh", [None, "cpu4"])
def test_mesh_takes_the_batch_major_quotient(monkeypatch, sharded, mesh):
    """With a mesh the size rule never picks the four-step quotient (its
    transforms do not shard), even with LM_MIN_LOG at 0; without one it
    does."""
    cc = sharded[0]
    prover = Prover(cc.pk, cc.ccs, rng=False, mesh=Mesh(["cpu"] * 4) if mesh else None)
    monkeypatch.setattr(prove_mod, "LM_MIN_LOG", 0)
    assert prover._use_lm_quotient() is (mesh is None)
