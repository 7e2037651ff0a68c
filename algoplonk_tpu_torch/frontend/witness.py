"""Witness solving (host) and the gnark-compatible witness binary layout.

Solving replays the straight-line eval program recorded at compile time —
no re-tracing of user circuit code (reference equivalent:
frontend.NewWitness + the gnark solver, algoplonk.go:81-85).

Binary layout (reference helper.go:96-109, all big-endian):
  u32 nb_public | u32 nb_secret | u32 nb_total | 32-byte field elements,
  public inputs first, in declaration order.

Copied from ``algoplonk_tpu/frontend/witness.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..utils import profiling
from .api import CompiledConstraintSystem


@dataclass
class Witness:
    """Solved witness: values[i] = value of variable i (canonical ints)."""

    ccs: CompiledConstraintSystem
    values: list

    @property
    def public_values(self) -> list:
        return self.values[: self.ccs.nb_public]

    @property
    def secret_values(self) -> list:
        n = self.ccs.nb_public
        return self.values[n : n + self.ccs.nb_secret]

    def marshal_full(self) -> bytes:
        vals = self.public_values + self.secret_values
        head = struct.pack(
            ">III", self.ccs.nb_public, self.ccs.nb_secret, len(vals)
        )
        return head + b"".join(v.to_bytes(32, "big") for v in vals)

    def marshal_public(self) -> bytes:
        """gnark public-witness blob (with header)."""
        head = struct.pack(
            ">III", self.ccs.nb_public, 0, self.ccs.nb_public
        )
        return head + b"".join(v.to_bytes(32, "big") for v in self.public_values)

    def public_inputs_blob(self) -> bytes:
        """The AVM export: public blob minus the 12-byte header
        (reference helper.go:91-110)."""
        return self.marshal_public()[12:]


def _flatten_assignment(ccs: CompiledConstraintSystem, assignment) -> list:
    """Assignment (circuit instance or dict) -> flat input value list in
    variable-id order (public first)."""
    if hasattr(assignment, "_values"):
        values = assignment._values
    else:
        values = dict(assignment)
    r = ccs.curve.fr.modulus
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
          commitment_solver=None) -> Witness:
    """Solve all variables.  commitment_solver(info, values) -> field int is
    invoked for BSB22 commitment variables (wired up by the prover).
    Span: ``solve``."""
    with profiling.span("solve"):
        return _solve(ccs, assignment, commitment_solver)


def _solve(ccs: CompiledConstraintSystem, assignment, commitment_solver) -> Witness:
    r = ccs.curve.fr.modulus
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
    return Witness(ccs, values)


def _check(ccs: CompiledConstraintSystem, values) -> None:
    r = ccs.curve.fr.modulus
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


def wire_values(ccs: CompiledConstraintSystem, witness: Witness, n: int):
    """Build the three wire columns over the padded domain of size n.

    Row layout (gnark plonk convention): nb_public public-input rows first
    (l = the public value), then the internal gates, then zero padding."""
    vals = witness.values
    npub = ccs.nb_public
    l = [0] * n
    r_ = [0] * n
    o = [0] * n
    for i in range(npub):
        l[i] = vals[i]
        r_[i] = vals[i]
        o[i] = vals[i]
    for j, g in enumerate(ccs.gates):
        row = npub + j
        l[row] = vals[g.l]
        r_[row] = vals[g.r]
        o[row] = vals[g.o]
    return l, r_, o
