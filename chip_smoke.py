#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (algoplonk_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build the four MSM kernels from algoplonk_tpu_torch/csrc with nvcc
   (sm_90a), run each on random valid points at the lane widths a 2^16
   commit gives it (c = 11, K = 16), and require word-for-word equality with
   its plain PyTorch version on the same inputs (tolerance: exact);
2. the main path, with the launch counts zeroed just before it: compile the
   2^16-constraint SquareChain circuit on BN254 with the test SRS on the
   GPU, prove and self-verify it (CompiledCircuit.verify), marshal; the
   proof must be 24 words, a flipped public input must be rejected, and
   every kernel must have launched;
3. one commit-sized MSM (65,539 points of that SRS): the kernel path must
   equal the plain path and the host Pippenger;
4. a small circuit proved on the GPU (device MSM forced) must give the same
   proof bytes as on the CPU, and a BSB22 circuit must prove and verify.

Output: timings on stderr and on stdout; before the last line the card's
name and power limit, then a JSON line of per-kernel numbers; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

LOG_N = 16
SRC = "algoplonk_tpu_torch/csrc/msm_kernels.cu"
REPLACES = {
    "mixed_add_signed_multi": "algoplonk_tpu/ops/curve_pallas.py:250",
    "jac_add_multi_scan": "algoplonk_tpu/ops/curve_pallas.py:357",
    "jac_add": "algoplonk_tpu/ops/curve_pallas.py:292",
    "canon": "algoplonk_tpu/ops/curve_pallas.py:404",
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over reps calls (one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def square_chain(apt, log_n: int):
    chain = (1 << log_n) - 3  # + final equality gate + 2 input rows = 2^log_n

    class SquareChain(apt.Circuit):
        y = apt.PublicInput()
        x = apt.SecretInput()

        def define(self, api):
            t = self.x
            for _ in range(chain):
                t = api.mul(t, t)
            api.assert_is_equal(t, self.y)

    return SquareChain, chain


def one_commit(apt):
    class OneCommit(apt.Circuit):
        x = apt.PublicInput()
        y = apt.SecretInput()

        def define(self, api):
            t = api.mul(self.y, self.y)
            v = api.commit(t)
            api.assert_is_different(v, 0)
            api.assert_is_equal(t, self.x)

    return OneCommit


def pythagorean(apt):
    class Pythagorean(apt.Circuit):
        a = apt.PublicInput()
        b = apt.PublicInput()
        c = apt.SecretInput()

        def define(self, api):
            a2 = api.mul(self.a, self.a)
            b2 = api.mul(self.b, self.b)
            c2 = api.mul(self.c, self.c)
            api.assert_is_equal(api.add(a2, b2), c2)

    return Pythagorean


def kernel_phase(torch, rng):
    """K1-K4 against their plain versions at main-path widths."""
    from algoplonk_tpu_torch import BN254
    from algoplonk_tpu_torch._ref.host import fp as hfp
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import msm as M
    from algoplonk_tpu_torch.ops.curve import curve_ops

    dev = torch.device("cuda")
    ops = curve_ops(BN254, dev)
    W = ops.W
    g = torch.Generator(device="cpu").manual_seed(1)
    # widths of one 2^16 commit (n + 3 points, c = 11, K = 16, S = 16)
    n = (1 << LOG_N) + 3
    c = M.WINDOW_BITS
    nw = M.num_windows(c)
    nblk = -(-n // (M.K_BLOCK * M.SUPER)) * M.SUPER
    w1p = M._pad_lanes(nw * nblk)
    w2p = M._pad_lanes(nw * ((1 << (c - 1)) + 1))
    wsbp = M._pad_lanes(nw * (nblk // M.SUPER))
    log(f"kernel widths: w1p={w1p} w2p={w2p} wsbp={wsbp}")

    F = hfp.GF(BN254.fp.modulus)
    base = [hfp.ec_mul(F, BN254.g1, rng.randrange(1, BN254.fr.modulus)) for _ in range(256)]
    table = ops.encode_affine(base)                                  # [256, 2, W]
    pts_flat = torch.cat([table, torch.zeros(1, 2, W, dtype=torch.int32, device=dev)])
    pts_flat = pts_flat.reshape(-1, 2 * W).contiguous()

    def rand_proj(lanes):
        """Random projective points: (doubled, so Z != 1; table rows;
        undoubled).  Row 256 is the identity."""
        idx = torch.randint(0, 257, (lanes,), generator=g).to(dev)
        p = ops.affine_to_jac(pts_flat[idx].reshape(lanes, 2, W))
        return ops.jac_double(p).permute(1, 2, 0).contiguous(), idx, p.permute(1, 2, 0)

    results = []

    def check(name, kern, plain, reps):
        out_k = kern()
        torch.cuda.synchronize()
        out_p = plain()
        torch.cuda.synchronize()
        diff = (out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max().item()
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 1)
        log(f"{name}: exact={diff == 0} kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
        if diff != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        results.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": REPLACES[name], "max_abs_err": diff,
                        "ms": ms, "plain_ms": plain_ms})

    # K1 at phase-1 width: 16 signed gather-adds over random rows and the
    # identity row; lanes 0-63 add their own point (doubling), lanes 64-127
    # its negation (result: identity)
    acc, acc_idx, acc_plain = rand_proj(w1p)
    acc[:, :, :128] = acc_plain[:, :, :128]
    rows = torch.randint(0, 257, (M.FUSE_STEPS, w1p), generator=g).to(dev)
    sign = torch.randint(0, 2, (M.FUSE_STEPS, w1p), generator=g).to(dev)
    rows[0, :128] = acc_idx[:128]
    sign[0, :64] = 0
    sign[0, 64:128] = 1
    packed = (rows | (sign << ck.SIGN_SHIFT)).to(torch.int32).contiguous()
    check("mixed_add_signed_multi",
          lambda: ck.mixed_add_signed_multi(ops, acc, pts_flat, packed),
          lambda: ck.plain_mixed_add_signed_multi(ops, acc, pts_flat, packed), 20)
    # K2 at phase-2a width
    acc2 = rand_proj(wsbp)[0]
    qs = torch.cat([rand_proj(wsbp)[0] for _ in range(M.SUPER)]).contiguous()
    check("jac_add_multi_scan",
          lambda: ck.jac_add_multi_scan(ops, acc2, qs),
          lambda: ck.plain_jac_add_multi_scan(ops, acc2, qs), 20)
    # K3 at phase-3/4 width, with p + p and p + (-p) lanes
    p3 = rand_proj(w2p)[0]
    q3 = rand_proj(w2p)[0]
    q3[:, :, :128] = p3[:, :, :128]
    q3[1, :, 64:128] = ops.f.neg(p3[1, :, 64:128].T).T
    check("jac_add", lambda: ck.jac_add(ops, p3, q3),
          lambda: ck.plain_jac_add(ops, p3, q3), 50)
    # K4 on arbitrary 256-bit words
    x4 = torch.randint(-2**31, 2**31, (3, W, w2p), generator=g, dtype=torch.int64)
    x4 = x4.to(torch.int32).to(dev).contiguous()
    check("canon", lambda: ck.canon(ops, x4), lambda: ck.plain_canon(ops, x4), 50)
    return results


class plain_kernels:
    """Route the MSM pipeline through the plain versions on CUDA tensors."""

    def __enter__(self):
        from algoplonk_tpu_torch.ops import curve_kernels as ck
        from algoplonk_tpu_torch.ops import msm as M

        self.saved = {k: getattr(M, k) for k in ck.KERNELS}
        for k in ck.KERNELS:
            setattr(M, k, getattr(ck, "plain_" + k))
        return self

    def __exit__(self, *exc):
        from algoplonk_tpu_torch.ops import msm as M

        for k, v in self.saved.items():
            setattr(M, k, v)


class msm_timer:
    """Host seconds spent in MsmCtx.msm_to_affine_int.  Each call starts
    after a synchronise and ends in a host fold that waits for the device,
    so the sum is the MSMs' share of a prove."""

    def __enter__(self):
        import torch
        from algoplonk_tpu_torch.ops import msm as M

        self.seconds, self.calls = 0.0, 0
        self.orig = orig = M.MsmCtx.msm_to_affine_int

        def timed(ctx, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(ctx, *args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        M.MsmCtx.msm_to_affine_int = timed
        return self

    def __exit__(self, *exc):
        from algoplonk_tpu_torch.ops import msm as M

        M.MsmCtx.msm_to_affine_int = self.orig


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import algoplonk_tpu_torch as apt
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    from algoplonk_tpu_torch.ops import _build
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import msm as M
    from algoplonk_tpu_torch.plonk import verify as V
    from algoplonk_tpu_torch.plonk.prove import Prover
    from algoplonk_tpu_torch.plonk.marshal import expected_proof_len, marshal_proof
    from algoplonk_tpu_torch._ref.frontend import witness as witness_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = random.Random(0xA1607)
    dev = torch.device("cuda")

    # ---- phase 1: build + kernels vs plain
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    log(_build.build_log.strip())
    kernels = kernel_phase(torch, rng)

    # ---- phase 2: the main path
    SquareChain, chain = square_chain(apt, LOG_N)
    r = apt.BN254.fr.modulus
    x = 0xA1607 % r
    y = pow(x, 1 << chain, r)
    ck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cc = apt.compile(SquareChain, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=dev)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    with msm_timer() as msm_t:
        vp = cc.verify(SquareChain(x=x, y=y))
    t_verify = time.perf_counter() - t0
    blob = vp.marshal_proof()
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"compile (circuit + SRS + setup) at n = {cc.pk.n}: {t_compile:.2f} s")
    log(f"prove + self-verify: {t_verify:.2f} s; phases (s): "
        + json.dumps({k: round(v, 4) for k, v in vp.phase_seconds.items()}))
    log(f"prove MSMs: {msm_t.calls} calls, {msm_t.seconds:.2f} s")
    log(f"launches on the main path: {launches}")
    log(f"peak device memory: {peak / 2**30:.3f} GiB")
    if cc.pk.n != 1 << LOG_N:
        raise AssertionError(f"domain {cc.pk.n} != 2^{LOG_N}")
    if len(blob) != expected_proof_len(apt.BN254, 0):
        raise AssertionError(f"proof blob is {len(blob)} bytes")
    if V.verify(cc.vk, vp.proof, [(y + 1) % r]):
        raise AssertionError("a flipped public input was accepted")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # ---- phase 3: one commit-sized MSM, kernels vs plain vs host
    pts = cc.pk.srs_g1
    n = pts.shape[0]
    scalars = [rng.randrange(r) for _ in range(n)]
    ctx = M.msm_ctx(apt.BN254, dev)
    mont = ctx.fr.encode(scalars)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ctx.msm_to_affine_int(pts, mont, kind="mont")
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    with plain_kernels():
        plain = ctx.msm_to_affine_int(pts, mont, kind="mont")
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = M.host_msm(apt.BN254, ctx.ops.decode_affine(pts), scalars)
    t_host = time.perf_counter() - t0
    log(f"MSM n={n}: kernel path {t_kernel:.3f} s, plain path {t_plain:.3f} s, "
        f"host {t_host:.1f} s; equal: {got == plain == host}")
    if not got == plain == host:
        raise AssertionError("commit-sized MSM disagrees")

    # ---- phase 4: small circuits
    P = pythagorean(apt)
    host_max = M.HOST_MSM_MAX
    M.HOST_MSM_MAX = 0  # every commit through the device pipeline
    try:
        blobs = []
        for d in (dev, torch.device("cpu")):
            small = apt.compile(P, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=d)
            prover = Prover(small.pk, small.ccs, rng=False)
            wit = witness_mod.solve(small.ccs, P(a=3, b=4, c=5), commitment_solver=prover.bsb_solver)
            proof = prover.prove(wit)
            if not V.verify(small.vk, proof, [3, 4]):
                raise AssertionError(f"small proof on {d} failed verification")
            blobs.append(marshal_proof(apt.BN254, proof))
    finally:
        M.HOST_MSM_MAX = host_max
    log(f"small circuit, device MSM: GPU proof == CPU proof: {blobs[0] == blobs[1]}")
    if blobs[0] != blobs[1]:
        raise AssertionError("GPU and CPU proofs differ")
    OneCommit = one_commit(apt)
    t0 = time.perf_counter()
    bcc = apt.compile(OneCommit, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=dev)
    bvp = bcc.verify(OneCommit(x=49, y=7))
    if len(bvp.marshal_proof()) != expected_proof_len(apt.BN254, 1) or len(bvp.proof.bsb_commitments) != 1:
        raise AssertionError("BSB22 proof has the wrong layout")
    log(f"BSB22 circuit proved + verified: {time.perf_counter() - t0:.2f} s")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
