"""The reference's PLONK keys and verifier, in plain Python integers.

``keys`` works the verifying key out again from a circuit's constraint
system (compiled by the reference's own frontend) and the test setup's
public tau, on gnark's conventions as AlgoPlonk's verifiers read them:
domain n = the power of two at or above constraints + public inputs;
public-input rows first (ql = -1), then the gates, then zero rows; the
qk committed without the public inputs and without the commitment rows'
constants; sigma over the 3n wire slots, each variable's slots in one
cycle in slot order, with coset ids 1, k1, k1^2.  With tau known, the KZG
commitment of a polynomial f is [f(tau)] G1, and f(tau) comes from f's
values on the domain through the Lagrange basis at tau, so no point of
the program's SRS is read.

``verify`` checks a proof as the on-chain verifiers do (SHA-256
Fiat-Shamir over gnark's encodings, the BSB22 commitments hashed into the
public-input polynomial, the linearisation and the batched opening of
AlgoPlonk's templateLogicSigBN254.go), on the proof's AVM bytes.  Its last
step is the pairing check e(D, [1]_2) e(-Q, [tau]_2) = 1, which for a
known tau is D = tau Q in G1: the same equation, checked without a
pairing.  ``wire_l_at_tau`` gives the left wire polynomial's value at tau
unblinded, so that a proof whose [L] equals it is known to be unblinded.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from . import curves as C


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class Keys:
    curve: C.Curve
    n: int
    omega: int
    k1: int
    nb_public: int
    tau: int
    lag: list             # omega^i / (tau - omega^i): L_i(tau) / scale
    scale: int            # (tau^n - 1) / n
    coms: dict            # name -> G1 point: ql qr qm qo qk s1 s2 s3
    qcp: list             # G1 points, one per commitment
    commitment_indexes: list


def lagrange_at(tau: int, n: int, omega: int, r: int):
    """(lag, scale) with L_i(tau) = scale * lag[i] on the domain of n
    points: L_i(X) = (omega^i / n) (X^n - 1) / (X - omega^i)."""
    wp = [1] * n
    for i in range(1, n):
        wp[i] = wp[i - 1] * omega % r
    d = [(tau - w) % r for w in wp]
    if 0 in d:
        raise ValueError("tau lies on the domain")
    pre = [0] * n
    acc = 1
    for i, x in enumerate(d):
        acc = acc * x % r
        pre[i] = acc
    inv = pow(acc, -1, r)
    lag = [0] * n
    for i in range(n - 1, 0, -1):
        lag[i] = inv * pre[i - 1] % r * wp[i] % r
        inv = inv * d[i] % r
    lag[0] = inv
    scale = (pow(tau, n, r) - 1) * pow(n, -1, r) % r
    return lag, scale, wp


def _sigma(ccs, n: int) -> np.ndarray:
    """sigma over the 3n slots (slot = column * n + row): each variable's
    slots, in slot order, form one cycle; a slot with no variable maps to
    itself."""
    npub = ccs.nb_public
    slots = np.full((3, n), -1, dtype=np.int64)
    slots[:, :npub] = np.arange(npub)
    if ccs.gates:
        g = np.array([(x.l, x.r, x.o) for x in ccs.gates], dtype=np.int64)
        slots[:, npub : npub + len(ccs.gates)] = g.T
    flat = slots.reshape(-1)
    pos = np.nonzero(flat >= 0)[0]
    order = np.argsort(flat[pos], kind="stable")
    sp, sid = pos[order], flat[pos][order]
    idx = np.arange(len(sp))
    first = np.ones(len(sp), dtype=bool)
    first[1:] = sid[1:] != sid[:-1]
    last = np.ones(len(sp), dtype=bool)
    last[:-1] = sid[1:] != sid[:-1]
    start = np.maximum.accumulate(np.where(first, idx, 0))
    nxt = np.empty_like(sp)
    nxt[:-1] = sp[1:]
    nxt[last] = sp[start[last]]
    sigma = np.arange(3 * n, dtype=np.int64)
    sigma[sp] = nxt
    return sigma


def keys(ccs, curve: C.Curve, tau: int) -> Keys:
    r = curve.r
    npub = ccs.nb_public
    n = next_pow2(ccs.nb_constraints + npub)
    omega = curve.domain_generator(n.bit_length() - 1)
    k1 = curve.coset_shift
    ks = [1, k1, k1 * k1 % r]
    lag, scale, wp = lagrange_at(tau, n, omega, r)

    gates = ccs.gates
    commit_rows = {c.constraint_index for c in ccs.commitments}
    ev = {
        "ql": sum(lag[:npub]) * (r - 1)
        + sum(g.ql * lag[npub + j] for j, g in enumerate(gates) if g.ql),
        "qr": sum(g.qr * lag[npub + j] for j, g in enumerate(gates) if g.qr),
        "qm": sum(g.qm * lag[npub + j] for j, g in enumerate(gates) if g.qm),
        "qo": sum(g.qo * lag[npub + j] for j, g in enumerate(gates) if g.qo),
        "qk": sum(g.qc * lag[npub + j] for j, g in enumerate(gates)
                  if g.qc and j not in commit_rows),
    }
    sigma = _sigma(ccs, n)
    for col, name in enumerate(("s1", "s2", "s3")):
        sig = sigma[col * n : (col + 1) * n]
        tcol, trow = (sig // n).tolist(), (sig % n).tolist()
        part = [0, 0, 0]
        for row in range(n):
            part[tcol[row]] += wp[trow[row]] * lag[row]
        ev[name] = sum(k * s for k, s in zip(ks, part))
    g1 = curve.g1
    coms = {name: C.mul(curve, g1, v % r * scale) for name, v in ev.items()}
    qcp = [C.mul(curve, g1, sum(lag[npub + row] for row in c.linking_rows) * scale)
           for c in ccs.commitments]
    return Keys(curve=curve, n=n, omega=omega, k1=k1, nb_public=npub, tau=tau,
                lag=lag, scale=scale, coms=coms, qcp=qcp,
                commitment_indexes=[c.constraint_index for c in ccs.commitments])


def wire_l_at_tau(k: Keys, ccs, values: list) -> int:
    """The unblinded left wire polynomial at tau, from a solved witness:
    the public rows carry the public values, gate j's row its l slot."""
    npub = ccs.nb_public
    lag = k.lag
    acc = sum(values[i] * lag[i] for i in range(npub))
    acc += sum(values[g.l] * lag[npub + j] for j, g in enumerate(ccs.gates))
    return acc % k.curve.r * k.scale % k.curve.r


# ---------------------------------------------------------------- proof

@dataclass
class Proof:
    L: tuple
    R: tuple
    O: tuple
    H: list
    l_z: int
    r_z: int
    o_z: int
    s1_z: int
    s2_z: int
    Z: tuple
    z_wz: int
    W: tuple              # batch opening at zeta
    Wz: tuple             # opening at zeta omega
    qcp_z: list
    bsb: list


def parse_proof(curve: C.Curve, blob: bytes, nb_commitments: int) -> Proof:
    """The AVM proof layout: L R O H0 H1 H2 | l r o s1 s2 at zeta | Z |
    z(zeta omega) | W | Wz | qcp_i(zeta)... | BSB22_i... (points 2 nb
    bytes, scalars 32)."""
    pt_len = 2 * curve.nb
    want = 9 * pt_len + 6 * 32 + nb_commitments * (32 + pt_len)
    if len(blob) != want:
        raise ValueError(f"proof of {len(blob)} bytes, expected {want}")
    pos = 0

    def pt():
        nonlocal pos
        P = C.decode_g1(curve, blob[pos : pos + pt_len])
        pos += pt_len
        return P

    def sc():
        nonlocal pos
        v = int.from_bytes(blob[pos : pos + 32], "big")
        pos += 32
        if v >= curve.r:
            raise ValueError("scalar not below r")
        return v

    L, R, O, H0, H1, H2 = (pt() for _ in range(6))
    l_z, r_z, o_z, s1_z, s2_z = (sc() for _ in range(5))
    Z = pt()
    z_wz = sc()
    W, Wz = pt(), pt()
    qcp_z = [sc() for _ in range(nb_commitments)]
    bsb = [pt() for _ in range(nb_commitments)]
    return Proof(L, R, O, [H0, H1, H2], l_z, r_z, o_z, s1_z, s2_z, Z, z_wz, W, Wz,
                 qcp_z, bsb)


def hash_to_fr(curve: C.Curve, msg: bytes, dst: bytes = b"BSB22-Plonk") -> int:
    """gnark's fr.Hash: expand_message_xmd (RFC 9380, SHA-256) to 48 bytes,
    read big-endian mod r."""
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + (48).to_bytes(2, "big") + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    b2 = hashlib.sha256(bytes(x ^ y for x, y in zip(b0, b1)) + b"\x02" + dst_prime).digest()
    return int.from_bytes((b1 + b2)[:48], "big") % curve.r


def _challenge(r: int, name: bytes, *chunks: bytes):
    d = hashlib.sha256(name + b"".join(chunks)).digest()
    return d, int.from_bytes(d, "big") % r


def verify(k: Keys, pf: Proof, publics: list) -> bool:
    c = k.curve
    r, n, omega = c.r, k.n, k.omega
    k2 = k.k1 * k.k1 % r
    enc = lambda P: C.encode_g1(c, P)            # noqa: E731
    fr = lambda v: (v % r).to_bytes(32, "big")   # noqa: E731
    if len(publics) != k.nb_public or any(not 0 <= x < r for x in publics):
        return False
    vk = k.coms
    vk_pts = b"".join(enc(vk[x]) for x in ("s1", "s2", "s3", "ql", "qr", "qm", "qo", "qk"))
    qcp_pts = b"".join(enc(q) for q in k.qcp)

    gamma_d, gamma = _challenge(r, b"gamma", vk_pts, qcp_pts, *(fr(x) for x in publics),
                                enc(pf.L), enc(pf.R), enc(pf.O))
    beta_d, beta = _challenge(r, b"beta", gamma_d)
    alpha_d, alpha = _challenge(r, b"alpha", beta_d, *(enc(P) for P in pf.bsb), enc(pf.Z))
    _, zeta = _challenge(r, b"zeta", alpha_d, *(enc(P) for P in pf.H))

    zh = (pow(zeta, n, r) - 1) % r
    zn = zh * pow(n, -1, r) % r

    def lag_at_zeta(i):      # L_i(zeta)
        w = pow(omega, i, r)
        return w * zn % r * pow((zeta - w) % r, -1, r) % r

    pi = sum(x * lag_at_zeta(i) for i, x in enumerate(publics))
    for idx, com in zip(k.commitment_indexes, pf.bsb):
        pi += hash_to_fr(c, enc(com)) * lag_at_zeta(k.nb_public + idx)
    pi %= r
    alpha2_l1 = lag_at_zeta(0) * alpha % r * alpha % r

    # the linearisation's constant part, which the opening must match
    perm = ((pf.s1_z * beta + gamma + pf.l_z) * (pf.s2_z * beta + gamma + pf.r_z)
            * (pf.o_z + gamma) % r * alpha % r * pf.z_wz % r)
    lin_z = (alpha2_l1 - perm - pi) % r

    # [H] folded: -(H0 + zeta^(n+2) H1 + zeta^(2(n+2)) H2) Z_H(zeta)
    zn2 = pow(zeta, n + 2, r)
    pairs = [(pf.H[0], -zh), (pf.H[1], -zh * zn2), (pf.H[2], -zh * zn2 * zn2)]
    # the linearised polynomial's commitment
    s1c = (pf.z_wz * beta % r * (pf.s1_z * beta + pf.l_z + gamma) % r
           * (pf.s2_z * beta + pf.r_z + gamma) % r * alpha % r)
    bz = beta * zeta % r
    s2c = (alpha2_l1 - (bz + pf.l_z + gamma) * (bz * k.k1 + pf.r_z + gamma) % r
           * (bz * k2 + pf.o_z + gamma) % r * alpha) % r
    pairs += [(vk["ql"], pf.l_z), (vk["qr"], pf.r_z), (vk["qo"], pf.o_z),
              (vk["qm"], pf.l_z * pf.r_z), (vk["qk"], 1),
              *zip(pf.bsb, pf.qcp_z), (vk["s3"], s1c), (pf.Z, s2c)]
    lin = C.msm(c, pairs)

    fold_d, v = _challenge(
        r, b"gamma", fr(zeta), enc(lin), enc(pf.L), enc(pf.R), enc(pf.O),
        enc(vk["s1"]), enc(vk["s2"]), qcp_pts,
        *(fr(x) for x in (lin_z, pf.l_z, pf.r_z, pf.o_z, pf.s1_z, pf.s2_z)),
        *(fr(x) for x in pf.qcp_z), fr(pf.z_wz))
    items = [(lin, lin_z), (pf.L, pf.l_z), (pf.R, pf.r_z), (pf.O, pf.o_z),
             (vk["s1"], pf.s1_z), (vk["s2"], pf.s2_z), *zip(k.qcp, pf.qcp_z)]
    digest_pairs, claims, vi = [], 0, 1
    for P, val in items:
        digest_pairs.append((P, vi))
        claims += val * vi
        vi = vi * v % r
    digest = C.msm(c, digest_pairs)
    _, u = _challenge(r, b"", enc(digest), enc(pf.W), enc(pf.Z), enc(pf.Wz), fr(zeta), fr(v))
    claims = (claims + pf.z_wz * u) % r
    # D = digest + u Z - claims G1 + zeta W + u zeta omega Wz;  Q = W + u Wz
    D = C.msm(c, [(digest, 1), (pf.Z, u), (c.g1, -claims), (pf.W, zeta),
                  (pf.Wz, u * zeta % r * omega)])
    Q = C.msm(c, [(pf.W, 1), (pf.Wz, u)])
    return D == C.mul(c, Q, k.tau)
