#!/usr/bin/env python3
"""Throughput of the port's Montgomery multiply (csrc/field.cuh) alone on
the card, the arithmetic that bounds K9 and the curve kernels.

    python3 bench_mont_mul.py [--reps N]

Builds a small CUDA program (nvcc, sm_90a) into algoplonk_tpu_torch/_kernels/
that runs chains of W = 8 multiplies on BN254's Fr: each thread keeps ILP
independent values and multiplies each by a constant reps times, at 8 to 64
warps per SM of an H100's 132.  It prints, for each, the time (CUDA events)
and the share of the rate chip_smoke.py's bounds assume: 2 (2 W^2 + W)
32-bit multiplies per Montgomery multiply at 64 per clock per SM and the
SM's maximum clock.
Before timing it checks a multiply of field.cuh against Python integers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "algoplonk_tpu_torch", "csrc")
OUT = os.path.join(HERE, "algoplonk_tpu_torch", "_kernels")

SOURCE = r'''
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdlib>
#include "field.cuh"
constexpr int W = 8;
using FC = ap::FieldConsts<W>;

template <int ILP>
__global__ void __launch_bounds__(256) chains(uint32_t* io, const uint32_t* y, int reps, FC fc) {
  uint32_t x[ILP][W], yy[W];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < ILP; ++i)
    for (int w = 0; w < W; ++w) x[i][w] = io[(tid * ILP + i) * W + w];
  for (int w = 0; w < W; ++w) yy[w] = y[w];
  for (int r = 0; r < reps; ++r)
#pragma unroll
    for (int i = 0; i < ILP; ++i) ap::mont_mul<W>(x[i], x[i], yy, fc);
  for (int i = 0; i < ILP; ++i)
    for (int w = 0; w < W; ++w) io[(tid * ILP + i) * W + w] = x[i][w];
}

template <int ILP>
float run(uint32_t* io, const uint32_t* y, int blocks, int reps, const FC& fc) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  chains<ILP><<<blocks, 256>>>(io, y, 1, fc);
  cudaEventRecord(a);
  chains<ILP><<<blocks, 256>>>(io, y, reps, fc);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

// argv: reps, then p (8 words), n0, x (8 words), y (8 words) as hex
int main(int argc, char** argv) {
  const int reps = atoi(argv[1]);
  FC fc = {};
  uint32_t x0[W], y[W];
  for (int i = 0; i < W; ++i) fc.p[i] = strtoul(argv[2 + i], 0, 16);
  fc.n0 = strtoul(argv[10], 0, 16);
  for (int i = 0; i < W; ++i) x0[i] = strtoul(argv[11 + i], 0, 16);
  for (int i = 0; i < W; ++i) y[i] = strtoul(argv[19 + i], 0, 16);
  const int max_threads = 132 * 8 * 256 * 4;
  uint32_t *io, *dy;
  cudaMalloc(&io, (size_t)max_threads * W * 4);
  cudaMalloc(&dy, sizeof y);
  cudaMemcpy(dy, y, sizeof y, cudaMemcpyHostToDevice);
  cudaMemcpy(io, x0, sizeof x0, cudaMemcpyHostToDevice);
  chains<1><<<1, 1>>>(io, dy, 1, fc);
  uint32_t got[W];
  cudaMemcpy(got, io, sizeof got, cudaMemcpyDeviceToHost);
  printf("check");
  for (int i = 0; i < W; ++i) printf(" %08x", got[i]);
  printf("\n");
  cudaMemset(io, 0x11, (size_t)max_threads * W * 4);
  for (int wps = 8; wps <= 64; wps *= 2) {
    const int blocks = 132 * wps / 8;
    printf("%d 1 %f\n", wps, run<1>(io, dy, blocks, reps, fc));
    printf("%d 2 %f\n", wps, run<2>(io, dy, blocks, reps, fc));
    printf("%d 4 %f\n", wps, run<4>(io, dy, blocks, reps, fc));
  }
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
'''


def words(v: int) -> list[str]:
    return [f"{(v >> (32 * i)) & 0xFFFFFFFF:08x}" for i in range(8)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("bench_mont_mul: no CUDA device", file=sys.stderr)
        return 2
    from algoplonk_tpu_torch.fields.params import CURVES
    from algoplonk_tpu_torch.ops._build import _nvcc

    p = CURVES["bn254"].fr.modulus
    R = 1 << 256
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    x, y = 0x1234567890ABCDEF % p, (p - 1) // 3
    os.makedirs(OUT, exist_ok=True)
    src, exe = os.path.join(OUT, "bench_mont_mul.cu"), os.path.join(OUT, "bench_mont_mul")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", CSRC, "-o", exe, src], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    mhz = float(card.rsplit(",", 1)[1].split()[0])
    out = subprocess.run([exe, str(args.reps), *words(p), f"{n0:08x}", *words(x), *words(y)],
                         capture_output=True, text=True, check=True).stdout.splitlines()
    got = int("".join(reversed(out[0].split()[1:])), 16)
    want = x * y * pow(R, -1, p) % p
    print(card)
    print(f"field.cuh mont_mul against Python integers: {got == want}")
    if got != want or out[-1] != "no error":
        return 1
    rate = 132 * 64 * mhz * 1e6
    for line in out[1:-1]:
        wps, ilp, ms = line.split()
        muls = 132 * int(wps) * 32 * int(ilp) * args.reps
        share = muls * 2 * (2 * 8 * 8 + 8) / (float(ms) * 1e-3) / rate
        print(f"{wps} warps per SM, independent chains per thread {ilp}: {float(ms):.4f} ms, "
              f"{share:.1%} of the assumed 32-bit multiply rate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
