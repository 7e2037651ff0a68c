"""The single-device PLONK prover, in PyTorch over the port's kernels.

Counterpart of the reference ``plonk/prove.py`` (Proof and Prover, :39-845):

  wire vectors -> iNTT -> 3 MSM commits -> grand product (blocked prefix
  products + tree batch inversion) -> MSM -> quotient on the 4n coset
  (coset NTTs, pointwise combination, division by Z_H) -> 3 MSM commits ->
  evaluations and linearization -> openings (blocked Horner) -> 2 MSM commits.

Round 3 takes one of the reference's two quotient paths, chosen by the
same rule (``_use_lm_quotient``): the batch-major ``_quotient`` (the
reference's ``_quotient_xla``) or, from a coset of 2^19 on, the four-step
``_quotient_lm`` over the NTT pass kernel K9 (ops/ntt_kernels.py).  Both
give the same proof.  Fiat-Shamir runs on host through the reference
transcript, so the proof bytes equal the reference's for the same blinding
(``rng=False``: none).

Spans (``utils/profiling.py``): ``prove``, with one child a round,
``r1``..``r5``, each ending after the prover's stream has drained (the
commits already wait on it, so the marks cost nothing); ``wires`` in r1
(the witness encoded once and the three wire columns gathered from it on
the key's device); round 3's sub-phases
``r3.qk`` .. ``r3.intt`` on either quotient path and ``r3.commits``;
``transcript`` around each Fiat-Shamir step; ``bsb_commit`` around
``bsb_solver``.  ``phase_seconds`` holds the rounds' durations on the
spans' clock, recorded or not.  ``AP_PROVE_PROFILE=1`` prints the
reference's profile on stderr from the spans (``PROFILE_LABELS``): each
round's seconds and, on the four-step path, round 3's seven sub-phases,
with the card's memory in use and its peak, after draining the prover's
stream at each printed span's end.

With a mesh (``parallel/mesh.py``), as in the reference, every commit runs
the sharded MSM and every size-n iNTT, quotient lift and final coset iNTT
the sharded four-step NTT (``parallel/``), whenever the transform's factors
divide over the shards; results gather back to the key's device.  The
proof bytes equal the single-device prove's.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import torch

from ..fields.params import domain_generator, gnark_compat_enabled
from ..frontend.api import CompiledConstraintSystem
from ..frontend.witness import Witness, wire_index
from ..plonk.transcript import Transcript, hash_fr_bsb22
from ..ops import poly as polyops
from ..ops.field import field_ops
from ..ops.msm import msm_ctx
from ..ops.ntt import ntt_plan
from ..ops.ntt_kernels import four_step_plan
from ..parallel.msm_sharded import sharded_commit
from ..parallel.mesh import all_gather
from ..parallel.ntt_sharded import sharded_ntt_fn
from ..utils import profiling
from ..utils.compile_cache import enable_persistent_cache
from .keys import ProvingKey

# Round 3's four-step quotient evicts the tables of the direction it is not
# about to run from a coset of 2^EVICT_MIN_LOG on: the reference's default
# (its AP_QUOTIENT_SYNC_MIN_LOG, prove.py:511-513).  A constant here: on an
# 80 GB card no size the port runs needs another value.
EVICT_MIN_LOG = 21

# The spans AP_PROVE_PROFILE=1 prints, by the reference's labels
# (prove.py:612-641), in the order they end.
PROFILE_LABELS = {
    "r1": "r1 wires+commits",
    "r2": "r2 grand product",
    "r3.qk": "r3.qk+tables",
    "r3.lifts": "r3.wire-lifts",
    "r3.gate": "r3.gate(5 lifts+mul)",
    "r3.inv": "r3.A+inversion",
    "r3.perm": "r3.perm(5 lifts)",
    "r3.combine": "r3.L1+combine",
    "r3.intt": "r3.4n-iNTT",
    "r3.commits": "r3.H-commits x3",
    "r3": "r3 quotient",
    "r4": "r4 evals+linearization",
    "r5": "r5 openings",
}

@dataclass
class Proof:
    """gnark-shaped PLONK proof (host affine points / canonical scalars)."""

    l_com: tuple
    r_com: tuple
    o_com: tuple
    h0: tuple
    h1: tuple
    h2: tuple
    l_at_z: int
    r_at_z: int
    o_at_z: int
    s1_at_z: int
    s2_at_z: int
    z_com: tuple
    z_omega_at_z: int
    batch_opening: tuple
    opening_z_omega: tuple
    qcp_at_z: list = field(default_factory=list)
    bsb_commitments: list = field(default_factory=list)


def _scatter_rows(base, rows: list[int], values):
    """base with ``rows`` replaced by ``values``.  The rows must be unique:
    ``index_put_`` with repeated indices keeps an unspecified one."""
    if len(set(rows)) != len(rows):
        raise ValueError(f"scatter rows are not unique: {rows}")
    out = base.clone()
    out[torch.tensor(rows, dtype=torch.long, device=base.device)] = values
    return out


def wire_columns(f, values: list, wire_rows) -> tuple:
    """The l, r and o columns [n, W] of a solved witness's ``values``:
    encoded once, with a zero row appended for the padding rows, and
    gathered by ``wire_rows`` [3, n] (frontend/witness.py: ``wire_index``).
    Word for word ``f.encode`` of ``wire_values``' columns."""
    vals = polyops.pad_rows(f.encode(values), len(values) + 1)
    return tuple(vals.index_select(0, rows) for rows in wire_rows)


class Prover:
    """PLONK prover on the proving key's device.

    ``rng``: source of blinding randomness.  None uses ``secrets`` (hiding,
    as gnark blinds its wire and Z polynomials); a ``random.Random`` gives
    deterministic test proofs; False disables blinding.

    ``mesh``: a ``parallel.Mesh`` to shard the commits and NTTs over, along
    ``mesh_axis``; ``sharded_ntt_hits`` counts the sharded transforms."""

    def __init__(self, pk: ProvingKey, ccs: CompiledConstraintSystem, rng=None,
                 mesh=None, mesh_axis: str = "x"):
        self.pk = pk
        self.ccs = ccs
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._sharded_msm_cache: dict = {}
        self._sh_ntt_cache: dict = {}
        self.sharded_ntt_hits = 0
        if rng is None:
            import secrets

            self._rand = lambda r: secrets.randbelow(r)
        elif rng is False:
            self._rand = lambda r: 0
        else:
            self._rand = lambda r: rng.randrange(r)
        self.curve = pk.curve
        self.device = pk.device
        if pk.wire_rows is None:    # built once per key, where setup did not
            pk.wire_rows = torch.from_numpy(wire_index(ccs, pk.n)).to(self.device)
        # the prover derives its domains from the current constants mode,
        # while pk bakes the mode it was built under: refuse a mismatch
        exp_omega = domain_generator(self.curve.name, pk.log_n)
        if pk.omega != exp_omega or pk.coset_shift != self.curve.coset_shift:
            raise ValueError(
                "proving key domain constants do not match the current "
                f"constants mode (gnark_compat={gnark_compat_enabled()}); "
                "call set_gnark_compat(...) to the mode the circuit was "
                "compiled under before constructing the Prover"
            )
        # build or load the kernel library now, not inside the first prove
        if self.device.type == "cuda":
            enable_persistent_cache()
        self.f = field_ops(self.curve.fr, self.device)
        self.msm = msm_ctx(self.curve, self.device)
        self.plan = ntt_plan(self.curve.name, pk.log_n, self.device)
        self.tr = Transcript(self.curve)
        r = self.curve.fr.modulus
        self.r = r
        n = pk.n
        self.coset_g = self.curve.coset_shift
        # Z_H on the 4n coset is a 4-periodic pattern
        self.w4 = domain_generator(self.curve.name, pk.log_n + 2)
        gn = pow(self.coset_g, n, r)
        w4n = pow(self.w4, n, r)
        self.zh_pat_ints = [(gn * pow(w4n, i, r) - 1) % r for i in range(4)]
        self.inv_zh_pat_ints = [pow(v, -1, r) for v in self.zh_pat_ints]
        self.zh_pattern = self.f.encode(self.zh_pat_ints)
        self.inv_zh_pattern = self.f.encode(self.inv_zh_pat_ints)
        self._bsb = []  # per-proof BSB22 state, filled by bsb_solver
        self.phase_seconds: dict[str, float] = {}
        self._prof = False   # AP_PROVE_PROFILE=1, read at each prove
        self._round = None   # the open round's span
        self._sub = None     # the open round-3 sub-phase's span
        self._sub_printed = True    # and whether the profile prints it

    # ---------------------------------------------------------------- utils

    def _const(self, v: int):
        return self.f.encode([v])[0]

    @property
    def plan4(self):
        """The radix-2 plan of the 4n coset, built at first use: the
        four-step path never needs its tables."""
        return ntt_plan(self.curve.name, self.pk.log_n + 2, self.device)

    def _commit(self, coeffs) -> tuple:
        """KZG commit (monomial basis) -> host affine int point; with a
        mesh, the sharded MSM."""
        if self.mesh is not None:
            return self._commit_sharded(coeffs)
        return self.msm.msm_to_affine_int(
            self.pk.srs_g1[: coeffs.shape[0]], coeffs, kind="mont"
        )

    def _commit_sharded(self, coeffs) -> tuple:
        """The commit over the mesh, small ones included."""
        return sharded_commit(self.curve, self.mesh, self.mesh_axis,
                              self.pk.srs_g1[: coeffs.shape[0]], coeffs, self._sharded_msm_cache)

    def _sharded_transform(self, vec, log_sz: int, inverse: bool, coset_shift: int | None):
        """One (i)NTT of size 2^log_sz over the mesh, or None without a mesh
        or where the four-step factors do not divide over the shards.  ``vec`` [m, W]
        (coefficients for the forward, natural-order evaluations for the
        inverse) is zero-padded to the size; the result, in natural order,
        gathers to the key's device."""
        if self.mesh is None:
            return None
        n = 1 << log_sz
        ndev = self.mesh.shape[self.mesh_axis]
        n1 = 1 << (log_sz // 2)
        n2 = n // n1
        if n1 % ndev or n2 % ndev:
            return None
        key = (log_sz, inverse, coset_shift)
        fn = self._sh_ntt_cache.get(key)
        if fn is None:
            fn, _ = sharded_ntt_fn(self.curve.name, self.mesh, self.mesh_axis, log_sz,
                                   inverse=inverse, coset_shift=coset_shift)
            self._sh_ntt_cache[key] = fn
        # flat index j = j1 n2 + j2 -> [j2, j1] (parallel/ntt_sharded.py)
        x = polyops.pad_rows(vec, n).reshape(n1, n2, self.f.W).transpose(0, 1)
        out = all_gather(fn(self.mesh.shard(x, 0)), self.device)
        self.sharded_ntt_hits += 1
        return out.reshape(n, self.f.W)

    def _intt_n(self, ev):
        """Size-n iNTT: sharded over the mesh where it divides."""
        out = self._sharded_transform(ev, self.pk.log_n, inverse=True, coset_shift=None)
        return self.plan.intt(ev) if out is None else out

    def _blind(self, coeffs, nb: int):
        """coeffs [n, W] + (b_0 + b_1 X + ...) (X^n - 1): hides the
        polynomial off H without changing it on H.  Output has n + nb
        coefficients, of which only rows i (-b_i) and n + i (+b_i) change:
        those alone are packed and added."""
        n = self.pk.n
        bs = [self._rand(self.r) for _ in range(nb)]
        if all(b == 0 for b in bs):
            return coeffs
        delta: dict = {}
        for i, b in enumerate(bs):
            delta[i] = delta.get(i, 0) - b
            delta[n + i] = delta.get(n + i, 0) + b
        rows = torch.tensor(list(delta), dtype=torch.long, device=self.device)
        out = polyops.pad_rows(coeffs, n + nb)      # a new tensor: coeffs has n rows
        out[rows] = self.f.add(out[rows], self.f.encode(list(delta.values())))
        return out

    # ------------------------------------------------------------- BSB22

    def bsb_solver(self, info, committed_values) -> int:
        """Witness-solver hook for frontend commitments: interpolate the
        committed polynomial over the linking rows, KZG-commit it, and return
        hash_fr(commitment) as the commitment variable's value.  Span:
        ``bsb_commit``."""
        with profiling.span("bsb_commit"):
            n, npub, W = self.pk.n, self.pk.nb_public, self.f.W
            rows = [npub + row for row in info.linking_rows]
            c_ev = torch.zeros((n, W), dtype=torch.int32, device=self.device)
            if rows:
                c_ev = _scatter_rows(c_ev, rows, self.f.encode(committed_values))
            c_c = self._intt_n(c_ev)
            com = self._commit(c_c)
            self._bsb.append({"com": com, "c_c": c_c, "info": info})
            return hash_fr_bsb22(self.curve, self.tr.point(com))

    # ------------------------------------------------------------ round 3

    def _use_lm_quotient(self) -> bool:
        """Take the four-step quotient (``_quotient_lm``)?  The reference's
        rule and variables: AP_QUOTIENT_LM=0/1 forces a path, otherwise the
        four-step one from a coset of 2^AP_NTT_LM_MIN_LOG (default 19) on,
        and never with a mesh (the batch-major quotient shards its
        transforms).  Unlike the reference, on any device: on the CPU its K9
        passes run their plain version."""
        forced = os.environ.get("AP_QUOTIENT_LM", "")
        if forced in ("0", "1"):
            return forced == "1"
        return (self.pk.log_n + 2 >= int(os.environ.get("AP_NTT_LM_MIN_LOG", "19"))
                and self.mesh is None)

    def _quotient(self, l_c, r_c, o_c, z_c, qk_c_complete, bsb, beta, gamma, alpha):
        """Round-3 quotient, batch-major (the reference's _quotient_xla):
        returns (h0_c, h1_c, h2_c) coefficient slices [n+2, W].

        Its parts are spans under the four-step path's names, in this
        path's order (``r3.lifts`` of the wires, ``r3.gate``, ``r3.perm``,
        ``r3.inv`` of L1, ``r3.combine``, ``r3.intt``), that only record:
        the reference prints none of them."""
        f, r, n, pk = self.f, self.r, self.pk.n, self.pk
        k1 = self.curve.coset_shift
        k2 = k1 * k1 % r
        beta_l = self._const(beta)
        gamma_l = self._const(gamma)
        g = self.coset_g
        N4 = 4 * n

        def lift(coeffs):
            out = self._sharded_transform(coeffs, pk.log_n + 2, inverse=False, coset_shift=g)
            return self.plan4.coset_ntt(polyops.pad_rows(coeffs, N4), g) if out is None else out

        # each selector is lifted just in time and dropped after use
        self._step("r3.lifts", printed=False)
        l4, r4, o4 = lift(l_c), lift(r_c), lift(o_c)
        self._step("r3.gate", printed=False)
        gate = f.mul(lift(pk.ql_c), l4)
        gate = f.add(gate, f.mul(lift(pk.qr_c), r4))
        gate = f.add(gate, f.mul(lift(pk.qm_c), f.mul(l4, r4)))
        gate = f.add(gate, f.mul(lift(pk.qo_c), o4))
        gate = f.add(gate, lift(qk_c_complete))
        for i, b in enumerate(bsb):
            gate = f.add(gate, f.mul(lift(pk.qcp_c[i]), lift(b["c_c"])))

        self._step("r3.perm", printed=False)
        xs = f.mul(polyops.powers(f, self._const(self.w4), N4), self._const(g))
        bxs = f.mul(beta_l, xs)
        A = f.add(f.add(l4, bxs), gamma_l)
        A = f.mul(A, f.add(f.add(r4, f.mul(bxs, self._const(k1))), gamma_l))
        A = f.mul(A, f.add(f.add(o4, f.mul(bxs, self._const(k2))), gamma_l))
        del bxs
        z4 = lift(z_c)
        z4m1 = f.sub(z4, f.one)
        perm = f.mul(A, z4)
        del A, z4

        D = f.add(f.add(l4, f.mul(beta_l, lift(pk.s1_c))), gamma_l)
        D = f.mul(D, f.add(f.add(r4, f.mul(beta_l, lift(pk.s2_c))), gamma_l))
        D = f.mul(D, f.add(f.add(o4, f.mul(beta_l, lift(pk.s3_c))), gamma_l))
        del l4, r4, o4
        # z(omega X): scale coefficients by omega^i
        zw_c = f.mul(z_c, polyops.powers(f, self._const(pk.omega), z_c.shape[0]))
        perm = f.sub(f.mul(D, lift(zw_c)), perm)
        del D, zw_c

        # L1 on the coset: (x^n - 1) / (n (x - 1)); the batch inversion runs
        # in 4 independent chunks of n
        self._step("r3.inv", printed=False)
        zh_tiled = self.zh_pattern.repeat(n, 1)
        inv_zh_tiled = self.inv_zh_pattern.repeat(n, 1)
        nconst = self._const(n)
        inv_parts = [
            polyops.batch_inverse_tree(
                f, f.mul(f.sub(xs[q * n : (q + 1) * n], f.one), nconst)
            )
            for q in range(4)
        ]
        L1 = f.mul(zh_tiled, torch.cat(inv_parts))
        del inv_parts, zh_tiled, xs

        self._step("r3.combine", printed=False)
        num_total = f.add(
            gate,
            f.add(
                f.mul(self._const(alpha), perm),
                f.mul(self._const(alpha * alpha % r), f.mul(L1, z4m1)),
            ),
        )
        del gate, perm, L1, z4m1
        h_ev = f.mul(num_total, inv_zh_tiled)
        del num_total
        self._step("r3.intt", printed=False)
        h_c = self._sharded_transform(h_ev, pk.log_n + 2, inverse=True, coset_shift=g)
        if h_c is None:
            h_c = self.plan4.coset_intt(h_ev, g)
        m = n + 2
        return h_c[:m], h_c[m : 2 * m], h_c[2 * m : 3 * m]

    def _quotient_lm(self, l_c, r_c, o_c, z_c, qk_c_complete, bsb, beta, gamma, alpha):
        """Round-3 quotient through the four-step transforms (the
        reference's ``_quotient_lm``, named after it though the port keeps
        [4n, W] batch-major): the same math as ``_quotient``, with every
        coset evaluation in the four-step's scrambled order.  Everything
        between the transforms is pointwise, and the order-dependent inputs
        (coset x values, Z_H patterns) are built in scrambled order, so the
        h polynomials are the batch-major path's exactly.

        Carried over from the reference's memory discipline
        (prove.py:493-598): from a coset of 2^EVICT_MIN_LOG (a 2^19-row
        circuit) on, the plan's tables of the
        direction not about to run are evicted (``drop_tables``) before the
        lifts and before the iNTT; every operand is dropped after its last
        use, at the reference's points, and z4 - 1 is formed at its single
        use.  Not carried over: the ``sync`` barriers, which bound JAX's
        asynchronous queue, whose pending programs keep their operands
        alive (PyTorch's caching allocator reuses a freed block in stream
        order, so a barrier frees nothing), and buffer donation, for which
        dropping the last reference stands in.

        Each sub-phase is a span (``_step``), as the reference's seven r3
        marks; the prove's ``r3.qk`` ends at the entry here, and ``r3.intt``
        where the prove opens ``r3.commits``."""
        f, r, n, pk = self.f, self.r, self.pk.n, self.pk
        fsp = four_step_plan(self.curve.name, pk.log_n + 2, self.device)
        k1 = self.curve.coset_shift
        k2 = k1 * k1 % r
        beta_l = self._const(beta)
        gamma_l = self._const(gamma)
        g = self.coset_g
        N4 = 4 * n
        big = pk.log_n + 2 >= EVICT_MIN_LOG

        def lift(coeffs):
            return fsp.ntt_scr(polyops.pad_rows(coeffs, N4), coset_shift=g)

        self._step("r3.lifts")
        if big:
            fsp.drop_tables(inverse=True)   # the forward transforms run first
        l4, r4, o4 = lift(l_c), lift(r_c), lift(o_c)
        self._step("r3.gate")
        gate = f.mul(lift(pk.ql_c), l4)
        gate = f.add(gate, f.mul(lift(pk.qr_c), r4))
        gate = f.add(gate, f.mul(lift(pk.qm_c), f.mul(l4, r4)))
        gate = f.add(gate, f.mul(lift(pk.qo_c), o4))
        gate = f.add(gate, lift(qk_c_complete))
        for i, b in enumerate(bsb):
            gate = f.add(gate, f.mul(lift(pk.qcp_c[i]), lift(b["c_c"])))
        self._step("r3.inv")

        xs = fsp.coset_x_scr(g)
        bxs = f.mul(xs, beta_l)
        A = f.add(f.add(l4, bxs), gamma_l)
        A = f.mul(A, f.add(f.add(r4, f.mul(bxs, self._const(k1))), gamma_l))
        A = f.mul(A, f.add(f.add(o4, f.mul(bxs, self._const(k2))), gamma_l))
        del bxs
        # L1 denominators n (x - 1), inverted in independent chunks while
        # xs is live (a cached table here), before z4 is lifted
        nconst = self._const(n)
        chunk = min(n, 1 << 18)
        inv_all = torch.cat([
            polyops.batch_inverse_tree(
                f, f.mul(f.sub(xs[q * chunk : (q + 1) * chunk], f.one), nconst)
            )
            for q in range(N4 // chunk)
        ])
        del xs
        self._step("r3.perm")

        z4 = lift(z_c)
        perm = f.mul(A, z4)
        del A
        D = f.add(f.add(l4, f.mul(lift(pk.s1_c), beta_l)), gamma_l)
        D = f.mul(D, f.add(f.add(r4, f.mul(lift(pk.s2_c), beta_l)), gamma_l))
        D = f.mul(D, f.add(f.add(o4, f.mul(lift(pk.s3_c), beta_l)), gamma_l))
        del l4, r4, o4
        zw_c = f.mul(z_c, polyops.powers(f, self._const(pk.omega), z_c.shape[0]))
        perm = f.sub(f.mul(D, lift(zw_c)), perm)
        del D, zw_c
        self._step("r3.combine")

        L1 = f.mul(f.mul(fsp.tile_by_k_mod4(self.zh_pat_ints), inv_all), f.sub(z4, f.one))
        del inv_all, z4
        num_total = f.add(
            gate,
            f.add(f.mul(perm, self._const(alpha)), f.mul(L1, self._const(alpha * alpha % r))),
        )
        del gate, perm, L1
        h_ev = f.mul(num_total, fsp.tile_by_k_mod4(self.inv_zh_pat_ints))
        del num_total
        self._step("r3.intt")
        if big:
            fsp.drop_tables(inverse=False)  # the lifts are done
        h_c = fsp.intt_scr(h_ev, coset_shift=g)
        del h_ev
        m = n + 2
        return h_c[:m], h_c[m : 2 * m], h_c[2 * m : 3 * m]

    # ---------------------------------------------------------------- prove

    def _drain(self) -> None:
        # the prover's own stream: concurrent provers on other streams of
        # the card (parallel/batch_prove.py) are not waited for
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _printed(self, sp) -> None:
        """With AP_PROVE_PROFILE=1, print the closed span ``sp`` on stderr
        as the reference's profile does (prove.py:612-641), with the card's
        memory in use at its end and the peak."""
        if not self._prof or sp is None:
            return
        mem = (f"  [hbm {sp.mem / 2**30:.2f} GiB in use, peak "
               f"{torch.cuda.max_memory_allocated(self.device) / 2**30:.2f}]"
               if sp.mem is not None else "")
        print(f"  prove phase {PROFILE_LABELS[sp.name]}: {sp.seconds:.2f}s{mem}",
              file=sys.stderr, flush=True)

    def _mark(self, name: str, nxt: str | None = None) -> None:
        """End round ``name`` after the prover's stream has drained, into
        ``phase_seconds`` and its span, and begin round ``nxt`` there."""
        self._drain()
        now = profiling.clock()
        self.phase_seconds[name] = (now - self._t) * 1e-9
        self._t = now
        sp = self._round
        profiling.close_span(sp, now)
        self._printed(sp)
        self._round = profiling.open_span(nxt, now, mem=self.device) if nxt else None

    def _step(self, name: str | None, t_ns: int | None = None, printed: bool = True) -> None:
        """End the open round-3 sub-phase and begin ``name`` (None: none)
        there.  Under AP_PROVE_PROFILE=1 a ``printed`` sub-phase drains the
        stream before it ends and is printed; the others (the batch-major
        quotient's) only record."""
        sp = self._sub
        if sp is not None:
            shown = self._prof and self._sub_printed
            if shown:
                self._drain()
            t_ns = profiling.clock()
            profiling.close_span(sp, t_ns)
            if shown:
                self._printed(sp)
        self._sub = profiling.open_span(name, t_ns, mem=self.device) if name else None
        self._sub_printed = printed

    def prove(self, witness: Witness) -> Proof:
        """Prove a solved witness.  Span: ``prove``, a request's root where
        nothing is open (a bare prove)."""
        with profiling.request("prove"):
            return self._prove(witness)

    def _prove(self, witness: Witness) -> Proof:
        pk, f, r, n = self.pk, self.f, self.r, self.pk.n
        curve = self.curve
        vk = pk.vk
        pub = witness.public_values
        bsb = self._bsb
        self._bsb = []
        if len(bsb) != len(self.ccs.commitments):
            raise RuntimeError(
                "BSB22 state mismatch: solve the witness through "
                "CompiledCircuit.verify (it wires bsb_solver into the solver)"
            )
        bsb_coms = [b["com"] for b in bsb]
        self.phase_seconds = {}
        self._prof = os.environ.get("AP_PROVE_PROFILE", "") == "1"
        self._t = profiling.clock()
        self._sub = None
        self._round = profiling.open_span("r1", self._t, mem=self.device)

        # ---- round 1: wire polynomials + commitments (blinded)
        with profiling.span("wires"):
            l_ev, r_ev, o_ev = wire_columns(f, witness.values, pk.wire_rows)
        l_c = self._blind(self._intt_n(l_ev), 2)
        r_c = self._blind(self._intt_n(r_ev), 2)
        o_c = self._blind(self._intt_n(o_ev), 2)
        l_com = self._commit(l_c)
        r_com = self._commit(r_c)
        o_com = self._commit(o_c)
        self._mark("r1", "r2")
        with profiling.span("transcript"):
            gamma_d, gamma = self.tr.gamma(vk, pub, l_com, r_com, o_com)
        with profiling.span("transcript"):
            beta_d, beta = self.tr.beta(gamma_d)

        # ---- round 2: grand product
        k1 = curve.coset_shift
        k2 = k1 * k1 % r
        omega_pows = polyops.powers(f, self._const(pk.omega), n)
        beta_l = self._const(beta)
        gamma_l = self._const(gamma)

        def lin_term(w_ev, ids):
            return f.add(f.add(w_ev, f.mul(beta_l, ids)), gamma_l)

        id2 = f.mul(omega_pows, self._const(k1))
        id3 = f.mul(omega_pows, self._const(k2))
        num = f.mul(
            f.mul(lin_term(l_ev, omega_pows), lin_term(r_ev, id2)), lin_term(o_ev, id3)
        )
        den = f.mul(
            f.mul(lin_term(l_ev, pk.s1_ev), lin_term(r_ev, pk.s2_ev)),
            lin_term(o_ev, pk.s3_ev),
        )
        ratio = f.mul(num, polyops.batch_inverse_tree(f, den))
        pp = polyops.prefix_products(f, ratio)
        z_ev = torch.cat([f.one[None], pp[:-1]])
        z_c = self._blind(self._intt_n(z_ev), 3)
        z_com = self._commit(z_c)
        del num, den, ratio, pp, z_ev, id2, id3, omega_pows, l_ev, r_ev, o_ev
        self._mark("r2", "r3")
        lm = self._use_lm_quotient()
        self._step("r3.qk", self._t, printed=lm)
        with profiling.span("transcript"):
            alpha_d, alpha = self.tr.alpha(beta_d, bsb_coms, z_com)

        # ---- round 3: quotient on the 4n coset.  qk completion: only the
        # public rows and the BSB22 commitment rows differ from pk.qk_ev
        upd_rows = list(range(len(pub)))
        upd_vals = list(pub)
        for b in bsb:
            info = b["info"]
            upd_rows.append(pk.nb_public + info.constraint_index)
            upd_vals.append(witness.values[info.commitment_var])
        qk_ev_complete = pk.qk_ev
        if upd_rows:
            qk_ev_complete = _scatter_rows(pk.qk_ev, upd_rows, f.encode(upd_vals))
        qk_c_complete = self._intt_n(qk_ev_complete)
        quotient = self._quotient_lm if lm else self._quotient
        h0_c, h1_c, h2_c = quotient(l_c, r_c, o_c, z_c, qk_c_complete, bsb, beta, gamma, alpha)
        self._step("r3.commits")
        h0 = self._commit(h0_c)
        h1 = self._commit(h1_c)
        h2 = self._commit(h2_c)
        self._step(None)
        self._mark("r3", "r4")
        with profiling.span("transcript"):
            zeta_d, zeta = self.tr.zeta(alpha_d, h0, h1, h2)

        # ---- round 4: evaluations
        zl = self._const(zeta)
        evs = polyops.poly_eval_many(f, [l_c, r_c, o_c, pk.s1_c, pk.s2_c, *pk.qcp_c], zl)
        wzeta = pk.omega * zeta % r
        zw_ev = polyops.poly_eval_many(f, [z_c], self._const(wzeta))
        vals = f.decode(torch.cat([evs, zw_ev]))
        l_z, r_z, o_z, s1_z, s2_z = vals[:5]
        qcp_z = vals[5:-1]
        zw_z = vals[-1]

        # ---- linearization polynomial
        m = n + 2
        zh_z = (pow(zeta, n, r) - 1) % r
        l1_z = zh_z * pow(n * (zeta - 1) % r, -1, r) % r
        pi = 0
        lag_rows = [(i, p_val) for i, p_val in enumerate(pub)] + [
            (pk.nb_public + b["info"].constraint_index,
             witness.values[b["info"].commitment_var])
            for b in bsb
        ]
        for idx, val in lag_rows:
            wi = pow(pk.omega, idx, r)
            li = zh_z * pow(n, -1, r) % r * wi % r * pow((zeta - wi) % r, -1, r) % r
            pi = (pi + li * val) % r

        u = (l_z + beta * s1_z + gamma) % r
        v = (r_z + beta * s2_z + gamma) % r
        lin_at_z = (
            -(alpha * u % r * v % r * ((o_z + gamma) % r) % r * zw_z % r
              + pi - alpha * alpha % r * l1_z)
        ) % r
        s3_coef = alpha * beta % r * zw_z % r * u % r * v % r
        z_coef = (
            -(alpha * ((l_z + beta * zeta + gamma) % r) % r
              * ((r_z + beta * k1 % r * zeta + gamma) % r) % r
              * ((o_z + beta * k2 % r * zeta + gamma) % r) % r)
            + alpha * alpha % r * l1_z
        ) % r

        zeta_m = pow(zeta, m, r)  # zeta^(n+2), the H-part fold step
        mlin = n + 3              # max component degree + 1 (blinded Z)

        def acc(lin_acc, coeffs, scalar):
            return f.add(lin_acc, f.mul(polyops.pad_rows(coeffs, mlin), self._const(scalar)))

        lin = torch.zeros((mlin, f.W), dtype=torch.int32, device=self.device)
        lin = acc(lin, pk.ql_c, l_z)
        lin = acc(lin, pk.qr_c, r_z)
        lin = acc(lin, pk.qm_c, l_z * r_z % r)
        lin = acc(lin, pk.qo_c, o_z)
        lin = acc(lin, pk.qk_c, 1)
        for i, b in enumerate(bsb):
            lin = acc(lin, b["c_c"], qcp_z[i])
        lin = acc(lin, pk.s3_c, s3_coef)
        lin = acc(lin, z_c, z_coef)
        lin = acc(lin, h0_c, (-zh_z) % r)
        lin = acc(lin, h1_c, (-zh_z) % r * zeta_m % r)
        lin = acc(lin, h2_c, (-zh_z) % r * zeta_m % r * zeta_m % r)
        lin_com = self._commit(lin)
        self._mark("r4", "r5")

        # ---- round 5: batched opening at zeta
        with profiling.span("transcript"):
            fold_d, fold_r = self.tr.fold(
                zeta, lin_com, l_com, r_com, o_com, vk,
                lin_at_z, l_z, r_z, o_z, s1_z, s2_z, qcp_z, zw_z,
            )
        folded = lin
        rv = 1
        for coeffs in (l_c, r_c, o_c, pk.s1_c, pk.s2_c, *pk.qcp_c):
            rv = rv * fold_r % r
            folded = acc(folded, coeffs, rv)
        # quotients have degree < deg(folded): trim the scan's padding
        q_coeffs, _ = polyops.kzg_quotient(f, folded, zl)
        batch_opening = self._commit(q_coeffs[:mlin])
        q2_coeffs, _ = polyops.kzg_quotient(f, z_c, self._const(wzeta))
        opening_z_omega = self._commit(q2_coeffs[:mlin])
        self._mark("r5")
        return Proof(
            l_com=l_com, r_com=r_com, o_com=o_com,
            h0=h0, h1=h1, h2=h2,
            l_at_z=l_z, r_at_z=r_z, o_at_z=o_z,
            s1_at_z=s1_z, s2_at_z=s2_z,
            z_com=z_com, z_omega_at_z=zw_z,
            batch_opening=batch_opening,
            opening_z_omega=opening_z_omega,
            qcp_at_z=qcp_z,
            bsb_commitments=bsb_coms,
        )
