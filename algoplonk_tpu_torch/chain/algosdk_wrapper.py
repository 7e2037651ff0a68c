"""Algorand localnet interaction layer (reference testutils/algosdkwrapper/:
setup.go + interact.go).

Wraps py-algorand-sdk with the same workflow the reference uses: localnet
clients with default algokit endpoints, kmd-funded accounts, idempotent app
deploys with on-chain bytecode-equality checks, ABI method calls executed in
simulate mode with ExtraOpcodeBudget, and logicsig helpers.

py-algorand-sdk is an external dependency (not bundled in this image); every
entry point is gated on its presence with a clear error, mirroring how the
toolchain shell-outs are gated.

Copied from ``algoplonk_tpu/chain/algosdk_wrapper.py`` so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import base64
import importlib.util
from dataclasses import dataclass

HAVE_ALGOSDK = importlib.util.find_spec("algosdk") is not None

# default algokit localnet endpoints (reference algosdkwrapper/setup.go:21-33)
ALGOD_URL = "http://localhost:4001"
KMD_URL = "http://localhost:4002"
INDEXER_URL = "http://localhost:8980"
LOCALNET_TOKEN = "a" * 64
EXTRA_OPCODE_BUDGET = 320_000  # reference algosdkwrapper/interact.go:337,551


class ChainUnavailable(RuntimeError):
    pass


def _require_sdk():
    if not HAVE_ALGOSDK:
        raise ChainUnavailable(
            "py-algorand-sdk is not installed; install it (and run "
            "`algokit localnet start`) to exercise on-chain verification"
        )


@dataclass
class Clients:
    algod: object
    kmd: object


def get_clients(algod_url: str = ALGOD_URL, kmd_url: str = KMD_URL,
                token: str = LOCALNET_TOKEN) -> Clients:
    _require_sdk()
    from algosdk.kmd import KMDClient
    from algosdk.v2client.algod import AlgodClient

    return Clients(
        algod=AlgodClient(token, algod_url),
        kmd=KMDClient(token, kmd_url),
    )


def get_funded_account(clients: Clients):
    """A funded localnet account from the default kmd wallet
    (reference algosdkwrapper/setup.go:108-153)."""
    _require_sdk()
    from algosdk import account  # noqa: F401

    kmd = clients.kmd
    wallets = kmd.list_wallets()
    wallet = next(w for w in wallets if w["name"] == "unencrypted-default-wallet")
    handle = kmd.init_wallet_handle(wallet["id"], "")
    try:
        addrs = kmd.list_keys(handle)
        for addr in addrs:
            info = clients.algod.account_info(addr)
            if info.get("amount", 0) > 10_000_000:
                sk = kmd.export_key(handle, "", addr)
                return addr, sk
    finally:
        kmd.release_wallet_handle(handle)
    raise ChainUnavailable("no funded account in the default kmd wallet")


def compile_teal(clients: Clients, teal_source: str) -> bytes:
    """Remote TEAL compile via algod (reference algosdkwrapper/interact.go:188-206)."""
    _require_sdk()
    res = clients.algod.compile(teal_source)
    return base64.b64decode(res["result"])


def logic_sig_from_file(clients: Clients, teal_path: str):
    """LogicSig account from a TEAL file (reference interact.go:489-506)."""
    _require_sdk()
    from algosdk.transaction import LogicSigAccount

    with open(teal_path) as fh:
        prog = compile_teal(clients, fh.read())
    return LogicSigAccount(prog)


def execute_abi_call(
    clients: Clients,
    app_id: int,
    method,
    args,
    sender: str,
    signer,
    simulate: bool = True,
    extra_txns=(),
):
    """ABI method call via AtomicTransactionComposer, in simulate mode with
    the max extra opcode budget, printing consumed budgets
    (reference algosdkwrapper/interact.go:318-356)."""
    _require_sdk()
    from algosdk.atomic_transaction_composer import AtomicTransactionComposer
    from algosdk.v2client.models import SimulateRequest

    atc = AtomicTransactionComposer()
    sp = clients.algod.suggested_params()
    atc.add_method_call(
        app_id=app_id, method=method, sender=sender, sp=sp,
        signer=signer, method_args=args,
    )
    for t in extra_txns:
        atc.add_transaction(t)
    if simulate:
        req = SimulateRequest(
            txn_groups=[], extra_opcode_budget=EXTRA_OPCODE_BUDGET,
            allow_unnamed_resources=True,
        )
        res = atc.simulate(clients.algod, req)
        group = res.simulate_response["txn-groups"][0]
        budget = group.get("app-budget-consumed")
        if budget is not None:
            print(f"app budget consumed: {budget}")
        if group.get("failure-message"):
            raise RuntimeError(
                f"simulation failed: {group['failure-message']}"
            )
        return res
    return atc.execute(clients.algod, 4)


def add_dummy_transactions(clients: Clients, sender: str, signer, n: int = 15):
    """n self-payment transactions to pool fees / raise the group's logicsig
    budget to 16 x 20k (reference algosdkwrapper/interact.go:511-542: the
    last txn carries a 1-algo fee for pooling)."""
    _require_sdk()
    from algosdk.atomic_transaction_composer import TransactionWithSigner
    from algosdk.transaction import PaymentTxn

    sp = clients.algod.suggested_params()
    txns = []
    for i in range(n):
        p = PaymentTxn(sender=sender, sp=sp, receiver=sender, amt=0)
        if i == n - 1:
            p.fee = 1_000_000
        txns.append(TransactionWithSigner(p, signer))
    return txns


# --------------------------------------------------------------- ARC56

@dataclass
class Arc56Method:
    """One ABI method from an ARC56 app spec (reference Arc56Schema.Methods,
    algosdkwrapper/interact.go:147-166)."""

    name: str
    arg_types: list
    return_type: str

    @property
    def signature(self) -> str:
        return f"{self.name}({','.join(self.arg_types)}){self.return_type}"

    @property
    def selector(self) -> bytes:
        import hashlib

        return hashlib.new(
            "sha512_256", self.signature.encode()
        ).digest()[:4]


@dataclass
class Arc56Schema:
    """Partial ARC56 app spec — the fields the deploy/call flow consumes
    (reference algosdkwrapper/interact.go:147-184)."""

    name: str
    methods: list
    global_ints: int
    global_bytes: int
    local_ints: int
    local_bytes: int
    approval_b64: str
    clear_b64: str

    def method(self, name: str) -> Arc56Method:
        for m in self.methods:
            if m.name == name:
                return m
        raise KeyError(f"method {name!r} not in ARC56 schema")


def read_arc56_schema(path: str) -> Arc56Schema:
    """Parse an ARC56 JSON app spec (pure — no SDK needed)."""
    import json

    with open(path) as fh:
        doc = json.load(fh)
    schema = doc.get("state", {}).get("schema", {})
    g = schema.get("global", {})
    l = schema.get("local", {})
    methods = [
        Arc56Method(
            name=m["name"],
            arg_types=[a["type"] for a in m.get("args", [])],
            return_type=m.get("returns", {}).get("type", "void"),
        )
        for m in doc.get("methods", [])
    ]
    src = doc.get("source", {})
    return Arc56Schema(
        name=doc.get("name", ""),
        methods=methods,
        global_ints=g.get("ints", 0),
        global_bytes=g.get("bytes", 0),
        local_ints=l.get("ints", 0),
        local_bytes=l.get("bytes", 0),
        approval_b64=src.get("approval", ""),
        clear_b64=src.get("clear", ""),
    )


# ------------------------------------------------------- indexer / devnet

def get_indexer_client(url: str = INDEXER_URL, token: str = LOCALNET_TOKEN):
    """Indexer client (reference algosdkwrapper/setup.go:95-106)."""
    _require_sdk()
    from algosdk.v2client.indexer import IndexerClient

    return IndexerClient(token, url)


def set_devnet(data_dir: str):
    """Point the module defaults at a custom devnet node directory, reading
    algod/kmd tokens and endpoints from its files and starting kmd
    (reference SetDevNet, algosdkwrapper/setup.go:42-73)."""
    import os
    import subprocess

    global ALGOD_URL, KMD_URL, LOCALNET_TOKEN

    def read(p):
        with open(p) as fh:
            return fh.read().strip()

    LOCALNET_TOKEN = read(os.path.join(data_dir, "algod.token"))
    ALGOD_URL = "http://" + read(os.path.join(data_dir, "algod.net"))
    try:
        KMD_URL = "http://" + read(os.path.join(data_dir, "kmd.net"))
    except OSError:
        KMD_URL = "http://localhost:7833"
    subprocess.run(["goal", "kmd", "start", "-d", data_dir], check=True)


# ----------------------------------------------------------------- deploy

def send_txn(clients: Clients, txn, private_key):
    """Sign, send, and wait for confirmation."""
    _require_sdk()
    from algosdk.transaction import wait_for_confirmation

    signed = txn.sign(private_key)
    txid = clients.algod.send_transaction(signed)
    return wait_for_confirmation(clients.algod, txid, 4)


def get_app_by_name(clients: Clients, app_name: str, creator_addr: str):
    """Find an app created by `creator_addr` whose create call stored this
    name (reference GetAppByName: match on the creator's created apps)."""
    _require_sdk()
    info = clients.algod.account_info(creator_addr)
    for app in info.get("created-apps", []):
        for kv in app.get("params", {}).get("global-state", []):
            key = base64.b64decode(kv["key"])
            if key in (b"app_name", b"name"):
                val = base64.b64decode(kv["value"].get("bytes", ""))
                # skip a 2-byte ABI string length prefix if present
                if val == app_name.encode() or val[2:] == app_name.encode():
                    return app
    return None


def deploy_arc4_app_if_needed(
    clients: Clients, app_name: str, directory: str,
    creator_addr: str, creator_sk: str,
) -> int:
    """Idempotent ARC4 app deploy: reuse when the on-chain bytecode equals
    the locally compiled programs, delete + redeploy otherwise
    (reference DeployArc4AppIfNeeded, algosdkwrapper/interact.go:42-144)."""
    _require_sdk()
    import os

    from algosdk import abi as sdk_abi
    from algosdk import transaction as sdk_txn

    with open(os.path.join(directory, app_name + ".approval.teal")) as fh:
        approval_bin = compile_teal(clients, fh.read())
    with open(os.path.join(directory, app_name + ".clear.teal")) as fh:
        clear_bin = compile_teal(clients, fh.read())
    schema = read_arc56_schema(os.path.join(directory, app_name + ".arc56.json"))

    app = get_app_by_name(clients, app_name, creator_addr)
    if app is not None:
        params = app.get("params", {})
        onchain_approval = base64.b64decode(params.get("approval-program", ""))
        onchain_clear = base64.b64decode(params.get("clear-state-program", ""))
        if onchain_approval == approval_bin and onchain_clear == clear_bin:
            print(f"App {app_name} already exists with id {app['id']} "
                  "and is up to date")
            return app["id"]
        print(f"App {app_name} exists but has been modified, deleting it...")
        sp = clients.algod.suggested_params()
        delete_txn = sdk_txn.ApplicationDeleteTxn(
            creator_addr, sp, app["id"],
            app_args=[schema.method("update").selector],
        )
        send_txn(clients, delete_txn, creator_sk)

    sp = clients.algod.suggested_params()
    extra_pages = (len(approval_bin) + len(clear_bin)) // 2048
    if extra_pages > 3:
        raise ValueError(
            f"approval program too large even for extra pages: "
            f"{len(approval_bin)} bytes"
        )
    create_args = [schema.method("create").selector]
    create_method = schema.method("create")
    if create_method.arg_types == ["string"]:
        create_args.append(
            len(app_name).to_bytes(2, "big") + app_name.encode()
        )
    create_txn = sdk_txn.ApplicationCreateTxn(
        creator_addr, sp, sdk_txn.OnComplete.NoOpOC,
        approval_bin, clear_bin,
        sdk_txn.StateSchema(schema.global_ints, schema.global_bytes),
        sdk_txn.StateSchema(schema.local_ints, schema.local_bytes),
        app_args=create_args,
        extra_pages=extra_pages,
    )
    res = send_txn(clients, create_txn, creator_sk)
    app_id = res["application-index"]
    print(f"App {app_name} created with id {app_id}")
    return app_id
