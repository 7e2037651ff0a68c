"""Test orchestration helpers (reference testutils/testutils.go).

`test_circuit_native` is the no-chain path (pure prove/verify, reference
TestCircuitWithGnark, testutils.go:29-57).  The on-chain helpers mirror the
reference flow: generate verifier -> puyapy -> deploy dummy app -> call the
logicsig verifier with 15 fee-pooling dummy transactions in simulate mode.
They require algokit + py-algorand-sdk + a running localnet and raise
ChainUnavailable otherwise.

Copied from ``algoplonk_tpu/chain/testutils.py`` and pointed at the port's
API (``test_circuit_native`` takes the device that ``compile`` takes) so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os

from .. import CompiledCircuit, VerifiedProof, compile as ap_compile
from ..utils import toolchain
from . import algosdk_wrapper as sdkw

# Dummy always-approving ARC4 app so logicsig verifiers have an app call to
# sign (reference testutils/testutils.go:155-183)
DUMMY_APP_SOURCE = '''\
import typing
from algopy import arc4
from algopy.arc4 import DynamicArray, StaticArray, Byte

Bytes32: typing.TypeAlias = StaticArray[Byte, typing.Literal[32]]


class DummyVerifiedApp(arc4.ARC4Contract):
    @arc4.abimethod(create="require")
    def create(self) -> None:
        pass

    @arc4.abimethod()
    def verify(
        self,
        proof: DynamicArray[Bytes32],
        public_inputs: DynamicArray[Bytes32],
    ) -> arc4.Bool:
        return arc4.Bool(True)
'''


def test_circuit_native(circuit_cls, curve, setup_name, assignment,
                        device="cuda") -> VerifiedProof:
    """Compile + prove + natively verify on ``device``, no chain (reference
    TestCircuitWithGnark, testutils/testutils.go:29-57)."""
    cc = ap_compile(circuit_cls, curve, setup_name, device=device)
    return cc.verify(assignment)


def call_logicsig_verifier(
    clients, lsig, app_id: int, method, proof: bytes, public_inputs: bytes,
    funded_addr: str, funded_signer,
):
    """Call an app with the logicsig verifier as signer, padding the group to
    16 transactions for the 320k logicsig budget
    (reference testutils/testutils.go:101-147)."""
    from algosdk.atomic_transaction_composer import LogicSigTransactionSigner

    args = toolchain.proof_and_public_inputs_for_atomic_composer(
        proof, public_inputs
    )
    dummies = sdkw.add_dummy_transactions(clients, funded_addr, funded_signer)
    return sdkw.execute_abi_call(
        clients, app_id, method, args,
        sender=lsig.address(),
        signer=LogicSigTransactionSigner(lsig),
        simulate=True,
        extra_txns=dummies,
    )


def write_dummy_app(directory: str) -> str:
    path = os.path.join(directory, "dummy_app.py")
    with open(path, "w") as fh:
        fh.write(DUMMY_APP_SOURCE)
    return path


# App with a verify method for logicsigs to sign (reference
# DeployAppWithVerifyMethod, testutils/testutils.go:152-202): stores its
# name at create so deploys are idempotent by name + bytecode
VERIFY_APP_NAME = "Arc4AppWithVerifyMethod"
VERIFY_APP_SOURCE = '''\
import typing
import algopy
from algopy.arc4 import (
    abimethod, DynamicArray, StaticArray, Bool, Byte, String
)

Bytes32: typing.TypeAlias = StaticArray[Byte, typing.Literal[32]]


class Arc4AppWithVerifyMethod(algopy.ARC4Contract):

    @abimethod(create="require")
    def create(self, name: String) -> None:
        """Create the application"""
        self.app_name = name

    @abimethod(allow_actions=["UpdateApplication", "DeleteApplication"])
    def update(self) -> None:
        """Update and delete the application"""
        return

    @abimethod
    def verify(
        self,
        proof: DynamicArray[Bytes32],
        public_inputs: DynamicArray[Bytes32],
    ) -> Bool:
        return Bool(True)
'''


def deploy_app_with_verify_method(clients, working_dir: str,
                                  creator_addr: str, creator_sk: str):
    """Write + puyapy-compile + idempotently deploy the always-true app with
    a verify method (reference testutils/testutils.go:152-202).  Returns
    (app_id, schema)."""
    path = os.path.join(working_dir, VERIFY_APP_NAME + ".py")
    with open(path, "w") as fh:
        fh.write(VERIFY_APP_SOURCE)
    toolchain.compile_with_puyapy(path, "")
    app_id = sdkw.deploy_arc4_app_if_needed(
        clients, VERIFY_APP_NAME, working_dir, creator_addr, creator_sk
    )
    schema = sdkw.read_arc56_schema(
        os.path.join(working_dir, VERIFY_APP_NAME + ".arc56.json")
    )
    return app_id, schema


def call_verify_method(clients, app_id: int, schema, proof_path: str,
                       public_inputs_path: str, sender: str, signer,
                       simulate: bool = True):
    """Call the smart-contract verifier's `verify` ABI method with the
    exported blobs (reference CallVerifyMethod, testutils/testutils.go:77-99)."""
    with open(proof_path, "rb") as fh:
        proof = fh.read()
    with open(public_inputs_path, "rb") as fh:
        public_inputs = fh.read()
    args = toolchain.proof_and_public_inputs_for_atomic_composer(
        proof, public_inputs
    )
    from algosdk.abi import Method as AbiMethod

    m = schema.method("verify")
    method = AbiMethod.from_signature(m.signature)
    return sdkw.execute_abi_call(
        clients, app_id, method, args, sender=sender, signer=signer,
        simulate=simulate,
    )


def call_logicsig_verifier_with_rekey(
    clients, lsig, app_id: int, method, proof: bytes, public_inputs: bytes,
    funded_addr: str, funded_signer, rekey_to: str,
):
    """Same as call_logicsig_verifier but with RekeyTo set — the generated
    logicsig must reject it (reference CallLogicSigVerifierWithRekey,
    testutils/testutils.go:110-116 + verifier_integration_test.go:232-256)."""
    from algosdk.atomic_transaction_composer import (
        AtomicTransactionComposer,
        LogicSigTransactionSigner,
    )
    from algosdk.v2client.models import SimulateRequest

    args = toolchain.proof_and_public_inputs_for_atomic_composer(
        proof, public_inputs
    )
    atc = AtomicTransactionComposer()
    sp = clients.algod.suggested_params()
    atc.add_method_call(
        app_id=app_id, method=method, sender=lsig.address(), sp=sp,
        signer=LogicSigTransactionSigner(lsig), method_args=args,
        rekey_to=rekey_to,
    )
    for t in sdkw.add_dummy_transactions(clients, funded_addr, funded_signer):
        atc.add_transaction(t)
    req = SimulateRequest(
        txn_groups=[], extra_opcode_budget=sdkw.EXTRA_OPCODE_BUDGET,
        allow_unnamed_resources=True,
    )
    return atc.simulate(clients.algod, req)
