"""Offline algopy (PuyaPy) runtime mock: EXECUTE emitted verifiers as Python.

The reference proves its codegen by running the compiled TEAL on a localnet
(testutils/verifier_integration_test.go:188-256).  algokit /
a localnet are unavailable in this environment, so this module implements
the slice of the `algopy` API the four emitted verifier programs use —
BigUInt / Bytes / UInt64 / arc4 containers / Txn / Global / op.sha256 /
op.EllipticCurve — with AVM-faithful semantics (byte-array bitwise ops
zero-extend on the left, setbit bit 0 is the MSB of byte 0, EC points are
big-endian uncompressed with all-zero = infinity).  NOTE on the G2 wire
order: the AVM/template layout is X.A0 || X.A1 || Y.A0 || Y.A1 — REAL part
first (the template emits G2_SRS_X_1, holding A0, concatenated first;
templateLogicSigBN254.go:22-23,350-353) — which is the OPPOSITE of
gnark-crypto's imaginary-part-first marshal order; pairing_check below
decodes accordingly.  Executing the emitted source against real marshalled
proof blobs turns "our prover and verifier agree" into "the emitted
on-chain program accepts our bytes".

The mock also meters an approximate AVM opcode budget (OpBudget below):
every expensive op charges its published-cost-class amount, so the
emitted-verifier tests can catch a budget-busting codegen regression
offline against the reference's published totals (~145k-261k,
README.md:27-30).

Usage (tests/test_emitted_verifier.py):

    ns = exec_verifier_source(source)
    ok = run_logicsig(ns, proof_blob, publics_blob)
    ok = run_contract_verify(ns, proof_blob, publics_blob)
    budget.consumed()  # approximate opcodes charged by the run

Copied from ``algoplonk_tpu/chain/algopy_mock.py`` so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import operator
import sys
import types

from ..fields.params import BLS12_381, BN254
from ..host import fp as hfp
from ..host.pairing import pairing_engine


def _idx(i):
    return operator.index(i) if not isinstance(i, slice) else slice(
        None if i.start is None else operator.index(i.start),
        None if i.stop is None else operator.index(i.stop),
        None if i.step is None else operator.index(i.step),
    )


class OpBudget:
    """Approximate AVM opcode-budget meter.

    Charges the AVM cost CLASS of every expensive operation the mock
    executes (byte math, sha256, ec ops), using the go-algorand langspec
    cost tiers (byte-math 6-20, sha256 35, ec_add ~10^2, ec_scalar_mul
    ~2*10^3, ec_pairing_check ~10^4 per pair).  Cheap stack/scratch TEAL
    opcodes around them are NOT modeled, so totals UNDERSTATE the on-chain
    figure by the linear program overhead; the value of the meter is
    regression detection against recorded baselines and the reference's
    published budgets (README.md:27-30), not exactness.
    """

    COSTS = {
        "b_add": 10, "b_sub": 10, "b_mul": 20, "b_divmod": 20, "b_cmp": 1,
        "b_bitwise": 6, "setbit": 1, "sha256": 35, "cheap": 1,
        "ec_add_bn_g1": 125, "ec_add_bls_g1": 205,
        "ec_mul_bn_g1": 1810, "ec_mul_bls_g1": 2340,
        # pairing: base for the first pair + increment per extra pair
        "ec_pair_bn": 8700, "ec_pair_bn_extra": 7400,
        "ec_pair_bls": 10000, "ec_pair_bls_extra": 8500,
    }

    def __init__(self):
        self.total = 0
        self.by_kind = {}

    # Per-operation linear TEAL overhead: every metered operation sits
    # amid ~a handful of 1-cost opcodes in the puyapy-compiled program
    # (operand loads from scratch/frame, dup/swap/store, the branch of the
    # enclosing if/while, subroutine frames amortized).  The constant is
    # calibrated so the modeled 0-commitment BN254 logicsig total matches
    # its published on-chain budget (~145k, reference README.md:27-30) and
    # VALIDATED against the other five published variants, which must land
    # inside the +-15% assertion band without per-variant tuning
    # (tests/test_emitted_verifier.py, PARITY.md).
    OP_OVERHEAD = 9

    def charge(self, kind, times=1):
        c = (self.COSTS[kind] + (self.OP_OVERHEAD if kind != "cheap" else 0)) * times
        self.total += c
        self.by_kind[kind] = self.by_kind.get(kind, 0) + c

    def cheap(self, times=1):
        """Linear TEAL overhead around a mock-level operation: operand
        loads/dups, the 1-cost opcode itself, stores.  ``times`` estimates
        the TEAL op count puyapy emits for the construct (slice ~3, concat
        ~3, compare ~3, loop step ~4 [increment+cmp+branch+index]), each at
        langspec cost 1.  Calibrated against the published on-chain totals:
        with these structural counts the modeled budgets land within the
        +-15%% assertion band for every published variant (PARITY.md)."""
        self.charge("cheap", times)

    def reset(self):
        self.total = 0
        self.by_kind = {}

    def consumed(self) -> int:
        return self.total


budget = OpBudget()


class UInt64(int):
    def __add__(self, o):
        budget.cheap(3)
        return UInt64(int(self) + int(o))

    def __radd__(self, o):
        budget.cheap(3)
        return UInt64(int(o) + int(self))

    def __sub__(self, o):
        budget.cheap(3)
        return UInt64(int(self) - int(o))

    def __mul__(self, o):
        budget.cheap(3)
        return UInt64(int(self) * int(o))

    def __rmul__(self, o):
        budget.cheap(3)
        return UInt64(int(o) * int(self))


class Bytes:
    __slots__ = ("b",)

    def __init__(self, b=b""):
        self.b = bytes(b.b if isinstance(b, Bytes) else b)

    @classmethod
    def from_hex(cls, h):
        return cls(bytes.fromhex(h))

    @property
    def length(self):
        budget.cheap(2)  # len + load
        return UInt64(len(self.b))

    def __len__(self):
        return len(self.b)

    def __getitem__(self, i):
        budget.cheap(3)  # extract3 + index loads
        r = self.b[_idx(i)]
        return Bytes(r if isinstance(r, bytes) else bytes([r]))

    def __add__(self, o):
        budget.cheap(3)  # concat + loads
        return Bytes(self.b + (o.b if isinstance(o, Bytes) else bytes(o)))

    def __radd__(self, o):
        budget.cheap(3)
        return Bytes((o.b if isinstance(o, Bytes) else bytes(o)) + self.b)

    def _pairwise(self, o, fn):
        ob = o.b if isinstance(o, Bytes) else bytes(o)
        n = max(len(self.b), len(ob))
        # AVM b|/b&/b^: the shorter operand is zero-extended on the left
        a = self.b.rjust(n, b"\x00")
        c = ob.rjust(n, b"\x00")
        return Bytes(bytes(fn(x, y) for x, y in zip(a, c)))

    def __or__(self, o):
        budget.charge("b_bitwise")
        return self._pairwise(o, operator.or_)

    def __xor__(self, o):
        budget.charge("b_bitwise")
        return self._pairwise(o, operator.xor)

    def __eq__(self, o):
        budget.cheap(3)  # == + loads
        return self.b == (o.b if isinstance(o, Bytes) else bytes(o))

    def __hash__(self):
        return hash(self.b)

    def __repr__(self):
        return f"Bytes({self.b.hex()})"


class BigUInt:
    __slots__ = ("v",)

    def __init__(self, v=0):
        self.v = int(v.v if isinstance(v, BigUInt) else v)
        if self.v < 0:
            raise ValueError("BigUInt underflow")

    @classmethod
    def from_bytes(cls, b):
        budget.cheap(1)  # reinterpret + load
        return cls(int.from_bytes(
            b.b if isinstance(b, Bytes) else bytes(b), "big"
        ))

    @property
    def bytes(self):
        budget.cheap(1)
        # AVM byte-math results carry no leading zero bytes; zero is empty
        if self.v == 0:
            return Bytes(b"")
        return Bytes(self.v.to_bytes((self.v.bit_length() + 7) // 8, "big"))

    def _v(self, o):
        return o.v if isinstance(o, BigUInt) else int(o)

    def __add__(self, o):
        budget.charge("b_add")
        return BigUInt(self.v + self._v(o))

    __radd__ = __add__

    def __sub__(self, o):
        budget.charge("b_sub")
        return BigUInt(self.v - self._v(o))

    def __rsub__(self, o):
        budget.charge("b_sub")
        return BigUInt(self._v(o) - self.v)

    def __mul__(self, o):
        budget.charge("b_mul")
        return BigUInt(self.v * self._v(o))

    __rmul__ = __mul__

    def __mod__(self, o):
        budget.charge("b_divmod")
        return BigUInt(self.v % self._v(o))

    def __floordiv__(self, o):
        budget.charge("b_divmod")
        return BigUInt(self.v // self._v(o))

    def __eq__(self, o):
        budget.charge("b_cmp")
        return self.v == self._v(o)

    def __hash__(self):
        return hash(self.v)

    def __lt__(self, o):
        budget.charge("b_cmp")
        return self.v < self._v(o)

    def __le__(self, o):
        budget.charge("b_cmp")
        return self.v <= self._v(o)

    def __gt__(self, o):
        budget.charge("b_cmp")
        return self.v > self._v(o)

    def __ge__(self, o):
        budget.charge("b_cmp")
        return self.v >= self._v(o)

    def __index__(self):
        return self.v

    def __bool__(self):
        return self.v != 0

    def __repr__(self):
        return f"BigUInt({self.v})"


def urange(*args):
    # per-iteration TEAL loop overhead: increment + compare + branch + index
    for v in range(*map(int, args)):
        budget.cheap(4)
        yield UInt64(v)


def _urange_unmetered(*args):
    return range(*(operator.index(a) for a in args))


def subroutine(fn):
    return fn


class _LogicSig:
    def __init__(self, fn, name):
        self.fn = fn
        self.name = name

    def __call__(self):
        return self.fn()


def logicsig(fn=None, *, name=None):
    if fn is None:
        return lambda f: _LogicSig(f, name)
    return _LogicSig(fn, name)


# --------------------------------------------------------------------- arc4

class _UInt256:
    __slots__ = ("v",)

    def __init__(self, v=0):
        self.v = int(v.v if isinstance(v, BigUInt) else v)
        if not 0 <= self.v < 1 << 256:
            raise ValueError("UInt256 out of range")

    @property
    def bytes(self):
        return Bytes(self.v.to_bytes(32, "big"))


class _Byte:
    pass


class _Bool:
    def __init__(self, v=False):
        self.v = bool(v)

    @property
    def native(self):
        return self.v

    def __bool__(self):
        return self.v


class _StaticArrayMeta(type):
    def __getitem__(cls, params):
        return cls


class _StaticArray(metaclass=_StaticArrayMeta):
    """Only used as DynamicArray element type annotation + raw chunks."""

    def __init__(self, raw=b""):
        self.raw = bytes(raw.b if isinstance(raw, Bytes) else raw)

    @property
    def bytes(self):
        return Bytes(self.raw)


class _DynamicArrayMeta(type):
    def __getitem__(cls, params):
        return cls


class _DynamicArray(metaclass=_DynamicArrayMeta):
    def __init__(self, *items):
        self.items = list(items)

    def append(self, x):
        self.items.append(x)

    def __getitem__(self, i):
        return self.items[operator.index(i)]

    def __setitem__(self, i, v):
        self.items[operator.index(i)] = v

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    @property
    def bytes(self):
        body = b"".join(bytes(x.bytes.b) for x in self.items)
        return Bytes(len(self.items).to_bytes(2, "big") + body)


def abimethod(fn=None, **_kw):
    if fn is None:
        return lambda f: f
    return fn


class ARC4Contract:
    pass


arc4 = types.SimpleNamespace(
    UInt256=_UInt256,
    DynamicArray=_DynamicArray,
    StaticArray=_StaticArray,
    Byte=_Byte,
    Bool=_Bool,
    abimethod=abimethod,
    ARC4Contract=ARC4Contract,
)


# ------------------------------------------------------------- txn context

ZERO_ADDRESS = Bytes(b"\x00" * 32)


class _Txn:
    def __init__(self):
        self.rekey_to = ZERO_ADDRESS
        self.sender = Bytes(b"\x01" * 32)
        self._args: list[Bytes] = []

    def application_args(self, i):
        return self._args[operator.index(i)]


class _Global:
    zero_address = ZERO_ADDRESS
    creator_address = Bytes(b"\x01" * 32)


Txn = _Txn()
Global = _Global()


# ------------------------------------------------------------------ op ops

def bzero(n):
    return Bytes(b"\x00" * operator.index(n))


def sha256(x):
    budget.charge("sha256")
    return Bytes(hashlib.sha256(
        x.b if isinstance(x, Bytes) else bytes(x)
    ).digest())


def setbit_bytes(b, i, v):
    """AVM setbit on byte arrays: bit 0 is the MSB of the first byte."""
    budget.charge("setbit")
    raw = bytearray(b.b if isinstance(b, Bytes) else bytes(b))
    i = operator.index(i)
    byte, bit = divmod(i, 8)
    mask = 0x80 >> bit
    if v:
        raw[byte] |= mask
    else:
        raw[byte] &= ~mask
    return Bytes(bytes(raw))


class EC:
    BN254g1 = "BN254g1"
    BLS12_381g1 = "BLS12_381g1"


_CURVE = {EC.BN254g1: BN254, EC.BLS12_381g1: BLS12_381}
_NB = {EC.BN254g1: 32, EC.BLS12_381g1: 48}


def _decode_g1(group, b):
    nb = _NB[group]
    raw = b.b if isinstance(b, Bytes) else bytes(b)
    assert len(raw) == 2 * nb, (len(raw), group)
    x = int.from_bytes(raw[:nb], "big")
    y = int.from_bytes(raw[nb:], "big")
    return None if x == 0 and y == 0 else (x, y)


def _encode_g1(group, p):
    nb = _NB[group]
    if p is None:
        return Bytes(b"\x00" * 2 * nb)
    return Bytes(p[0].to_bytes(nb, "big") + p[1].to_bytes(nb, "big"))


class EllipticCurve:
    @staticmethod
    def scalar_mul(group, point, scalar):
        budget.charge(
            "ec_mul_bn_g1" if group == EC.BN254g1 else "ec_mul_bls_g1"
        )
        curve = _CURVE[group]
        F = hfp.GF(curve.fp.modulus)
        k = int.from_bytes(
            scalar.b if isinstance(scalar, Bytes) else bytes(scalar), "big"
        )
        return _encode_g1(group, hfp.ec_mul(F, _decode_g1(group, point), k))

    @staticmethod
    def add(group, a, b):
        budget.charge(
            "ec_add_bn_g1" if group == EC.BN254g1 else "ec_add_bls_g1"
        )
        curve = _CURVE[group]
        F = hfp.GF(curve.fp.modulus)
        return _encode_g1(
            group, hfp.ec_add(F, _decode_g1(group, a), _decode_g1(group, b))
        )

    @staticmethod
    def pairing_check(group, g1blob, g2blob):
        curve = _CURVE[group]
        nb = _NB[group]
        raw1 = g1blob.b if isinstance(g1blob, Bytes) else bytes(g1blob)
        raw2 = g2blob.b if isinstance(g2blob, Bytes) else bytes(g2blob)
        assert len(raw1) % (2 * nb) == 0 and len(raw2) % (4 * nb) == 0
        n = len(raw1) // (2 * nb)
        assert len(raw2) // (4 * nb) == n
        bn = group == EC.BN254g1
        budget.charge("ec_pair_bn" if bn else "ec_pair_bls")
        if n > 1:
            budget.charge(
                "ec_pair_bn_extra" if bn else "ec_pair_bls_extra", n - 1
            )
        pairs = []
        for i in range(n):
            P = _decode_g1(group, raw1[i * 2 * nb : (i + 1) * 2 * nb])
            q = raw2[i * 4 * nb : (i + 1) * 4 * nb]
            # AVM G2 layout: X.A0 || X.A1 || Y.A0 || Y.A1 — REAL part
            # first (the reference template emits X_1||X_0 where X_1 holds
            # A0, templateLogicSigBN254.go:22-23,350-353)
            x0, x1, y0, y1 = (
                int.from_bytes(q[j * nb : (j + 1) * nb], "big")
                for j in range(4)
            )
            if all(v == 0 for v in (x0, x1, y0, y1)):
                Q = None
            else:
                Q = ((x0, x1), (y0, y1))
            if P is None or Q is None:
                continue  # e(0, Q) = e(P, 0) = 1
            pairs.append((P, Q))
        return pairing_engine(curve.name).pairing_check(pairs)


# ------------------------------------------------------------ module setup

def _build_modules():
    algopy = types.ModuleType("algopy")
    algopy.BigUInt = BigUInt
    algopy.Bytes = Bytes
    algopy.UInt64 = UInt64
    algopy.urange = urange
    algopy.subroutine = subroutine
    algopy.logicsig = logicsig
    algopy.arc4 = arc4
    algopy.Txn = Txn
    algopy.Global = Global

    op = types.ModuleType("algopy.op")
    op.bzero = bzero
    op.sha256 = sha256
    op.setbit_bytes = setbit_bytes
    op.EllipticCurve = EllipticCurve
    op.EC = EC

    arc4_mod = types.ModuleType("algopy.arc4")
    for k, v in vars(arc4).items():
        setattr(arc4_mod, k, v)

    algopy.op = op
    return {"algopy": algopy, "algopy.op": op, "algopy.arc4": arc4_mod}


def exec_verifier_source(source: str) -> dict:
    """Execute emitted PuyaPy verifier source under the mock and return its
    namespace.  Installs the mock algopy modules for the exec only."""
    mods = _build_modules()
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        ns: dict = {}
        exec(compile(source, "<emitted-verifier>", "exec"), ns)
        return ns
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def run_logicsig(ns: dict, proof: bytes, publics: bytes,
                 rekey: bool = False) -> bool:
    """Drive the logicsig verifier with ABI-prefixed app args (mirrors the
    reference's on-chain call layout: args 1, 2 with u16 length prefixes)."""
    lsig = next(v for v in ns.values() if isinstance(v, _LogicSig))
    Txn._args = [
        Bytes(b"\x00" * 4),  # method selector (unused)
        Bytes(len(proof).to_bytes(2, "big") + proof),
        Bytes(len(publics).to_bytes(2, "big") + publics),
    ]
    Txn.rekey_to = Bytes(b"\x02" * 32) if rekey else ZERO_ADDRESS
    try:
        return bool(lsig())
    finally:
        Txn.rekey_to = ZERO_ADDRESS


def _chunks32(blob: bytes):
    assert len(blob) % 32 == 0
    return [_StaticArray(blob[i : i + 32]) for i in range(0, len(blob), 32)]


def run_contract_verify(ns: dict, proof: bytes, publics: bytes) -> bool:
    """Deploy-and-call the ARC4 contract verifier."""
    cls = ns["Verifier"]
    inst = cls()
    inst.create()
    ok = inst.verify(
        _DynamicArray(*_chunks32(proof)), _DynamicArray(*_chunks32(publics))
    )
    return bool(ok)
