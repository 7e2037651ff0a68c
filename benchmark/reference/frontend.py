"""Circuit frontend and witness solver of the reference: a frozen copy.

The circuit-definition API and the sparse constraint system builder are
copied from ``algoplonk_tpu_torch/frontend/api.py`` (itself a copy of the
JAX package's ``frontend/api.py``), and ``solve`` with ``_flatten_assignment``
and ``_check`` from ``algoplonk_tpu_torch/frontend/witness.py``, as they
stood when the benchmark was written.  The only edits: a curve is a
``reference.curves.Curve`` (its scalar field is ``curve.r``), and ``solve``
returns the list of values.  The reference compiles each circuit with this
copy, so the constraint system it derives its keys from is its own, and a
later change to the program's frontend shows as proofs its keys reject.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass


class Variable:
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __repr__(self):
        return f"v{self.idx}"


class _Input:
    """Descriptor marking a circuit input; shape=None scalar, int for vectors."""

    _counter = itertools.count()

    def __init__(self, shape: int | None = None):
        self.shape = shape
        self.order = next(_Input._counter)
        self.name = None

    def __set_name__(self, owner, name):
        self.name = name


class PublicInput(_Input):
    public = True


class SecretInput(_Input):
    public = False


class Circuit:
    """Base class for circuit definitions.

    Subclass with PublicInput()/SecretInput() class attributes and a
    ``define(self, api)`` method.  Instantiate with keyword values to build an
    assignment: ``MyCircuit(a=3, b=4, c=5)``.
    """

    def __init__(self, **values):
        self._values = values

    def define(self, api: "API"):  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def inputs(cls):
        ins = []
        for klass in reversed(cls.__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, _Input):
                    ins.append(attr)
        ins.sort(key=lambda d: d.order)
        return ins


@dataclass
class Gate:
    """One PLONK row: qL*l + qR*r + qM*l*r + qO*o + qC = 0."""

    ql: int = 0
    qr: int = 0
    qm: int = 0
    qo: int = 0
    qc: int = 0
    l: int = 0   # variable ids of wire slots
    r: int = 0
    o: int = 0


@dataclass
class CommitmentInfo:
    """BSB22 commitment: committed wire variables + the commitment variable.

    constraint_index: row of the commitment-variable constraint within the
    internal gate list (matches vk.CommitmentConstraintIndexes semantics of
    the generated verifiers, reference templateLogicSigBN254.go:187-194).
    linking_rows: rows where qcp_i = 1 and the committed polynomial c_i
    carries each committed wire's value (gate: -w + qcp_i * c_i = 0).
    """

    committed_vars: list
    commitment_var: int
    constraint_index: int
    linking_rows: list


@dataclass
class CompiledConstraintSystem:
    curve: object
    nb_public: int
    nb_secret: int
    nb_vars: int
    gates: list
    program: list            # eval instructions for witness solving
    commitments: list        # list[CommitmentInfo]
    input_names: list        # flattened input order (for witness packing)

    @property
    def nb_constraints(self) -> int:
        return len(self.gates)


class API:
    """Builder handed to Circuit.define()."""

    def __init__(self, curve):
        self.curve = curve
        self.r = curve.r
        self.gates: list[Gate] = []
        self.program: list = []
        self.commitments: list[CommitmentInfo] = []
        self.nb_vars = 0

    # ------------------------------------------------------------- plumbing

    def _new_var(self) -> Variable:
        v = Variable(self.nb_vars)
        self.nb_vars += 1
        return v

    def _const(self, x) -> int:
        return int(x) % self.r

    def _is_const(self, x) -> bool:
        return not isinstance(x, Variable)

    # --------------------------------------------------------------- gates

    def add(self, *terms):
        """Sum of variables and constants; constants fold into the first gate
        so a k-term sum costs max(k_vars - 1, 1) gates."""
        const = 0
        vs = []
        for t in terms:
            if self._is_const(t):
                const = (const + int(t)) % self.r
            else:
                vs.append(t)
        if not vs:
            return const
        if len(vs) == 1:
            if const == 0:
                return vs[0]
            a = vs[0]
            out = self._new_var()
            self.gates.append(
                Gate(ql=1, qo=self.r - 1, qc=const, l=a.idx, r=a.idx, o=out.idx)
            )
            self.program.append(("affine", out.idx, 1, a.idx, 0, 0, const))
            return out
        cur = vs[0]
        for i, nxt in enumerate(vs[1:]):
            c = const if i == 0 else 0
            out = self._new_var()
            self.gates.append(
                Gate(ql=1, qr=1, qo=self.r - 1, qc=c, l=cur.idx, r=nxt.idx, o=out.idx)
            )
            self.program.append(("affine", out.idx, 1, cur.idx, 1, nxt.idx, c))
            cur = out
        return cur

    def sub(self, a, b):
        if self._is_const(b):
            return self.add(a, -int(b))
        if self._is_const(a):
            # const - var: one gate  -v + c - out = 0
            c = self._const(a)
            out = self._new_var()
            self.gates.append(
                Gate(ql=self.r - 1, qo=self.r - 1, qc=c, l=b.idx, r=b.idx, o=out.idx)
            )
            self.program.append(("affine", out.idx, self.r - 1, b.idx, 0, 0, c))
            return out
        out = self._new_var()
        self.gates.append(
            Gate(ql=1, qr=self.r - 1, qo=self.r - 1, l=a.idx, r=b.idx, o=out.idx)
        )
        self.program.append(("affine", out.idx, 1, a.idx, self.r - 1, b.idx, 0))
        return out

    def neg(self, a):
        if self._is_const(a):
            return self._const(-int(a))
        return self.mul_const(a, self.r - 1)

    def mul_const(self, a, k):
        k = self._const(k)
        if self._is_const(a):
            return self._const(int(a) * k)
        out = self._new_var()
        self.gates.append(Gate(ql=k, qo=self.r - 1, l=a.idx, r=a.idx, o=out.idx))
        self.program.append(("affine", out.idx, k, a.idx, 0, 0, 0))
        return out

    def mul(self, a, b, *rest):
        if rest:
            return self.mul(self.mul(a, b), *rest)
        if self._is_const(a) and self._is_const(b):
            return self._const(int(a) * int(b))
        if self._is_const(a):
            a, b = b, a
        if self._is_const(b):
            return self.mul_const(a, b)
        out = self._new_var()
        self.gates.append(
            Gate(qm=1, qo=self.r - 1, l=a.idx, r=b.idx, o=out.idx)
        )
        self.program.append(("mul", out.idx, a.idx, b.idx))
        return out

    def mul_acc(self, a, b, c):
        """a + b*c (gnark api.MulAcc), fused into one gate when possible."""
        if self._is_const(b) or self._is_const(c):
            return self.add(a, self.mul(b, c))
        if self._is_const(a):
            # qM*b*c + qC - out = 0
            out = self._new_var()
            k = self._const(a)
            self.gates.append(
                Gate(qm=1, qo=self.r - 1, qc=k, l=b.idx, r=c.idx, o=out.idx)
            )
            self.program.append(("mulacc_c", out.idx, k, b.idx, c.idx))
            return out
        # can't place three inputs on one row (a needs its own slot and the
        # row only has l,r,o with o taken by the output) — two gates
        return self.add(a, self.mul(b, c))

    def div(self, a, b):
        """a / b, with b asserted nonzero by construction (b * out = a)."""
        if self._is_const(b):
            return self.mul_const(a, pow(self._const(b), -1, self.r))
        out = self._new_var()
        if self._is_const(a):
            self.program.append(("div_const_num", out.idx, self._const(a), b.idx))
            self.gates.append(
                Gate(qm=1, qc=self.r - self._const(a) if self._const(a) else 0,
                     l=b.idx, r=out.idx, o=b.idx)
            )
        else:
            self.program.append(("div", out.idx, a.idx, b.idx))
            self.gates.append(
                Gate(qm=1, qo=self.r - 1, l=b.idx, r=out.idx, o=a.idx)
            )
        return out

    def inverse(self, a):
        return self.div(1, a)

    def assert_is_equal(self, a, b):
        if self._is_const(a) and self._is_const(b):
            if self._const(a) != self._const(b):
                raise ValueError("constant constraint violated at compile time")
            return
        if self._is_const(a):
            a, b = b, a
        if self._is_const(b):
            c = self._const(b)
            self.gates.append(
                Gate(ql=1, qc=self.r - c if c else 0, l=a.idx, r=a.idx, o=a.idx)
            )
        else:
            self.gates.append(
                Gate(ql=1, qr=self.r - 1, l=a.idx, r=b.idx, o=a.idx)
            )

    def assert_is_different(self, a, b):
        d = self.sub(a, b)
        self.inverse(d)

    def assert_is_boolean(self, a):
        if self._is_const(a):
            if self._const(a) not in (0, 1):
                raise ValueError("constant not boolean")
            return
        # a * a - a = 0
        self.gates.append(
            Gate(qm=1, ql=self.r - 1, l=a.idx, r=a.idx, o=a.idx)
        )

    def is_zero(self, a):
        """Returns z with z = 1 if a == 0 else 0 (gnark api.IsZero)."""
        if self._is_const(a):
            return 1 if self._const(a) == 0 else 0
        m = self._new_var()  # pseudo-inverse hint
        self.program.append(("pinv", m.idx, a.idx))
        z = self._new_var()
        self.program.append(("iszero", z.idx, a.idx))
        # z = 1 - a*m  ->  a*m + z - 1 = 0
        self.gates.append(
            Gate(qm=1, qo=1, qc=self.r - 1, l=a.idx, r=m.idx, o=z.idx)
        )
        # a * z = 0
        self.gates.append(Gate(qm=1, l=a.idx, r=z.idx, o=a.idx))
        return z

    def select(self, cond, a, b):
        """cond ? a : b  =  b + cond * (a - b)."""
        d = self.sub(a, b)
        return self.add(b, self.mul(cond, d))

    def xor(self, a, b):
        # a + b - 2ab
        return self.sub(self.add(a, b), self.mul_const(self.mul(a, b), 2))

    def and_(self, a, b):
        return self.mul(a, b)

    def or_(self, a, b):
        return self.sub(self.add(a, b), self.mul(a, b))

    def lookup2(self, b0, b1, i0, i1, i2, i3):
        """2-bit lookup (gnark api.Lookup2): selects i_{b1b0} from four values.

        out = i0 + b0*(i1-i0) + b1*(i2-i0) + b0*b1*(i3-i2-i1+i0); b0,b1 must
        be boolean (asserted by the caller or produced by to_binary)."""
        t01 = self.mul(b0, b1)
        out = self.add(
            i0,
            self.mul(b0, self.sub(i1, i0)),
            self.mul(b1, self.sub(i2, i0)),
            self.mul(t01, self.add(self.sub(i3, i2), self.sub(i0, i1))),
        )
        return out

    def cmp(self, a, b, nbits: int | None = None):
        """Three-way compare (gnark api.Cmp): 1 if a>b, 0 if a==b, -1 (mod r)
        if a<b, comparing as integers in [0, r).  Cost: 2 bit decompositions
        plus O(nbits) select rows."""
        if self._is_const(a) and self._is_const(b):
            ca, cb = self._const(a), self._const(b)
            return 1 if ca > cb else (0 if ca == cb else self.r - 1)
        if nbits is None:
            nbits = self.r.bit_length()
        abits = self.to_binary(a, nbits)
        bbits = self.to_binary(b, nbits)
        res = 0
        for ai, bi in zip(abits, bbits):  # LSB→MSB; later (higher) bits win
            d = self.sub(ai, bi)  # in {-1, 0, 1}
            res = self.select(self.is_zero(d), res, d)
        return res

    def assert_is_less_or_equal(self, v, bound):
        """Assert v <= bound as integers (gnark api.AssertIsLessOrEqual)."""
        if self._is_const(v) and self._is_const(bound):
            if self._const(v) > self._const(bound):
                raise ValueError("constant bound violated at compile time")
            return
        if self._is_const(bound):
            nbits = max(self._const(bound).bit_length(), 1)
            # decompose v into exactly nbits bits: forces v < 2^nbits and
            # cmp over the short width settles v <= bound
            c = self.cmp(v, bound, nbits=nbits)
        else:
            c = self.cmp(v, bound)
        # c ∈ {-1,0,1}; forbid c == 1 via c*(c+1) == 0: c=-1→0, c=0→0, c=1→2
        self.assert_is_equal(self.mul(c, self.add(c, 1)), 0)

    def to_binary(self, a, nbits: int):
        """Decompose into nbits little-endian bits (range-checks included)."""
        if self._is_const(a):
            c = self._const(a)
            if c >= 1 << nbits:
                raise ValueError("constant does not fit in nbits")
            return [(c >> i) & 1 for i in range(nbits)]
        bits = []
        for i in range(nbits):
            bv = self._new_var()
            self.program.append(("bit", bv.idx, a.idx, i))
            self.assert_is_boolean(bv)
            bits.append(bv)
        acc = 0
        for i, bv in enumerate(bits):
            acc = self.add(acc, self.mul_const(bv, pow(2, i, self.r)))
        self.assert_is_equal(acc, a)
        return bits

    def from_binary(self, bits):
        acc = 0
        for i, bv in enumerate(bits):
            acc = self.add(acc, self.mul_const(bv, pow(2, i, self.r)))
        return acc

    def commit(self, *vars_) -> Variable:
        """BSB22 commitment (gnark frontend.Committer.Commit).

        Scheme (satisfies the generated verifiers' equation exactly):
        * one linking row per committed wire w:  -w + qcp_i * c_i = 0,
          where qcp_i is the per-commitment selector (1 at linking rows) and
          c_i is the committed polynomial carrying w's value there;
        * one commitment-variable row: -v + hash = 0, the hash entering like
          a public input (prover: qk_complete at this row; verifier:
          hash_fr(BSB_i) * L_row(zeta) added to PI —
          reference templateLogicSigBN254.go:187-194).
        Returns v = hash_fr(Com(c_i)), solved during proving."""
        committed = [v.idx for v in vars_ if isinstance(v, Variable)]
        linking_rows = []
        for w in committed:
            linking_rows.append(len(self.gates))
            self.gates.append(Gate(ql=self.r - 1, l=w, r=w, o=w))
        out = self._new_var()
        constraint_index = len(self.gates)
        self.gates.append(
            Gate(ql=self.r - 1, l=out.idx, r=out.idx, o=out.idx)
        )
        self.program.append(
            ("commit", out.idx, tuple(committed), len(self.commitments))
        )
        self.commitments.append(
            CommitmentInfo(
                committed_vars=committed,
                commitment_var=out.idx,
                constraint_index=constraint_index,
                linking_rows=linking_rows,
            )
        )
        return out


def compile_circuit(circuit_cls, curve) -> CompiledConstraintSystem:
    """Run define() symbolically and freeze the constraint system."""
    api = API(curve)
    inputs = circuit_cls.inputs()
    # allocate ids: public first (flattened in declaration order), then secret
    proto = circuit_cls.__new__(circuit_cls)
    input_names = []
    for inp in sorted(inputs, key=lambda d: (not d.public, d.order)):
        if inp.shape is None:
            v = api._new_var()
            setattr(proto, inp.name, v)
            input_names.append((inp.name, None, inp.public))
        else:
            vs = [api._new_var() for _ in range(inp.shape)]
            setattr(proto, inp.name, vs)
            input_names.append((inp.name, inp.shape, inp.public))
    nb_public = sum(
        (1 if s is None else s) for _, s, pub in input_names if pub
    )
    nb_secret = sum(
        (1 if s is None else s) for _, s, pub in input_names if not pub
    )
    proto.define(api)
    return CompiledConstraintSystem(
        curve=curve,
        nb_public=nb_public,
        nb_secret=nb_secret,
        nb_vars=api.nb_vars,
        gates=api.gates,
        program=api.program,
        commitments=api.commitments,
        input_names=input_names,
    )


# ------------------------------------------------------------ witness

def _flatten_assignment(ccs: CompiledConstraintSystem, assignment) -> list:
    """Assignment (circuit instance or dict) -> flat input value list in
    variable-id order (public first)."""
    if hasattr(assignment, "_values"):
        values = assignment._values
    else:
        values = dict(assignment)
    r = ccs.curve.r
    flat = []
    for name, shape, _pub in ccs.input_names:
        if name not in values:
            raise ValueError(f"missing assignment for input '{name}'")
        v = values[name]
        if shape is None:
            flat.append(int(v) % r)
        else:
            if len(v) != shape:
                raise ValueError(
                    f"input '{name}' expects {shape} values, got {len(v)}"
                )
            flat.extend(int(x) % r for x in v)
    return flat


def solve(ccs: CompiledConstraintSystem, assignment,
          commitment_solver=None) -> list:
    """Solve all variables.  commitment_solver(info, values) -> field int is
    invoked for BSB22 commitment variables (wired up by the prover)."""
    r = ccs.curve.r
    values = [0] * ccs.nb_vars
    flat = _flatten_assignment(ccs, assignment)
    values[: len(flat)] = flat

    for ins in ccs.program:
        kind = ins[0]
        if kind == "affine":
            _, out, ca, a, cb, b, c = ins
            values[out] = (ca * values[a] + cb * values[b] + c) % r
        elif kind == "mul":
            _, out, a, b = ins
            values[out] = values[a] * values[b] % r
        elif kind == "mulacc_c":
            _, out, k, a, b = ins
            values[out] = (k + values[a] * values[b]) % r
        elif kind == "div":
            _, out, a, b = ins
            values[out] = values[a] * pow(values[b], -1, r) % r
        elif kind == "div_const_num":
            _, out, anum, b = ins
            values[out] = anum * pow(values[b], -1, r) % r
        elif kind == "pinv":
            _, out, a = ins
            values[out] = pow(values[a], -1, r) if values[a] else 0
        elif kind == "iszero":
            _, out, a = ins
            values[out] = 1 if values[a] == 0 else 0
        elif kind == "bit":
            _, out, a, i = ins
            values[out] = (values[a] >> i) & 1
        elif kind == "commit":
            _, out, committed, cidx = ins
            if commitment_solver is None:
                raise NotImplementedError(
                    "circuit uses BSB22 commitments; solve via the prover"
                )
            values[out] = commitment_solver(
                ccs.commitments[cidx], [values[v] for v in committed]
            ) % r
        else:  # pragma: no cover
            raise ValueError(f"unknown instruction {kind}")
    _check(ccs, values)
    return values


def _check(ccs: CompiledConstraintSystem, values) -> None:
    r = ccs.curve.r
    commitment_rows = set()
    for c in ccs.commitments:
        commitment_rows.add(c.constraint_index)
        commitment_rows.update(c.linking_rows)
    for i, g in enumerate(ccs.gates):
        if i in commitment_rows:
            continue  # checked via the commitment mechanism during proving
        l, rr, o = values[g.l], values[g.r], values[g.o]
        v = (g.ql * l + g.qr * rr + g.qm * l * rr + g.qo * o + g.qc) % r
        if v != 0:
            raise ValueError(f"constraint {i} not satisfied")
