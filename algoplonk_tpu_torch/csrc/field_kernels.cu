// The prover's field arithmetic on the card, CUDA for sm_90a, bound to Python
// through a plain C interface (ctypes): every FieldOps.mul, add, sub and neg
// of a CUDA FieldOps is one launch of these (ops/field_kernels.py).
//
//   K8 field_mul      replaces pallas_field_mul
//                     (algoplonk_tpu/ops/curve_pallas.py:447), a strict
//                     Montgomery product of [N, L] rows
//   field_add_sub     a + b, a - b and -a mod p; no TPU kernel: the
//                     reference computes them in XLA (algoplonk_tpu/ops/
//                     field.py:237-247), which fuses them on the TPU
//
// Operands.  The prover calls FieldOps with broadcast and strided views:
// one element against a batch, an NTT stage's strided halves against a
// strided twiddle slice, every other row, [k, n] against [1, n].  So each
// operand comes as a data pointer and its row strides (in words) over a
// batch of at most two dimensions, n0 x n1 rows, stride 0 where it is
// broadcast; the words of a row are contiguous.  The wrapper merges the
// broadcast shape's batch dimensions into that form, and the output is a
// contiguous [n0 n1, W].  Row r is (r / n1, r % n1); the wrapper keeps
// n0 n1 below 2^31, so the division is 32-bit.
//
// One thread owns one row, batch-major as the prover keeps it (the TPU
// kernel transposes to limbs-major; here nothing is transposed), and reads
// and writes it as 16-byte vectors: two per operand at W = 8, three at
// W = 12.  The wrapper gives only 16-byte aligned rows (it copies an operand
// whose pointer or row strides are not 16-byte multiples).
//
// What bounds them on the H100: at the prover's sizes (at most 2^18 rows)
// the multiply is bound by bytes (2^18 rows of 96 bytes at 3.35 TB/s is
// 7.5 us; its 2 W^2 + W = 136 wide products per row take 4.3 us at the
// card's 32-bit multiply rate), add/sub/neg by bytes alone; below a few
// thousand rows, which is most calls of the blocked scans, by the launch.
// K8 runs the strict carry-chain core of field.cuh unchanged (mont_mul: a
// below R with b below p, or the reverse, gives a canonical product), since
// BLS12-381's Fr has no room for the lazy one; add/sub/neg are the strict
// add_mod, sub_mod and neg_mod.
//
// Built once per width (-DAP_W=8: BN254's Fr and Fp and BLS12-381's Fr;
// -DAP_W=12: BLS12-381's Fp).  Every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "lanes.cuh"

namespace {

using ap::blocks_for;
using ap::kThreads;

constexpr int kAdd = 0;
constexpr int kSub = 1;
constexpr int kNeg = 2;

// Row r of the n0 x n1 batch: its word offset in an operand of strides
// (s0, s1).
struct Rows {
  int64_t rows;   // n0 n1 < 2^31
  uint32_t n1;
  int64_t sa0, sa1, sb0, sb1;
};

template <int W>
__device__ __forceinline__ void load_row(uint32_t* x, const uint32_t* __restrict__ src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const uint4 q = __ldg(v + k);
    x[4 * k] = q.x;
    x[4 * k + 1] = q.y;
    x[4 * k + 2] = q.z;
    x[4 * k + 3] = q.w;
  }
}

template <int W>
__device__ __forceinline__ void store_row(uint32_t* dst, const uint32_t* x) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    v[k] = make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

// K8: out[r] = a[r] b[r] R^-1 mod p, canonical.
template <int W>
__global__ void __launch_bounds__(kThreads)
field_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, Rows L, ap::FieldConsts<W> fc) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= L.rows) return;
  const uint32_t i0 = (uint32_t)r / L.n1;
  const uint32_t i1 = (uint32_t)r - i0 * L.n1;
  uint32_t x[W], y[W];
  load_row<W>(x, a + i0 * L.sa0 + i1 * L.sa1);
  load_row<W>(y, b + i0 * L.sb0 + i1 * L.sb1);
  ap::mont_mul<W>(x, x, y, fc);
  store_row<W>(out + r * W, x);
}

// out[r] = a[r] + b[r], a[r] - b[r] or -a[r] mod p (OP), canonical.
template <int W, int OP>
__global__ void __launch_bounds__(kThreads)
field_add_sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, Rows L, ap::FieldConsts<W> fc) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= L.rows) return;
  const uint32_t i0 = (uint32_t)r / L.n1;
  const uint32_t i1 = (uint32_t)r - i0 * L.n1;
  uint32_t x[W];
  load_row<W>(x, a + i0 * L.sa0 + i1 * L.sa1);
  if constexpr (OP == kNeg) {
    ap::neg_mod<W>(x, fc.p);
  } else {
    uint32_t y[W];
    load_row<W>(y, b + i0 * L.sb0 + i1 * L.sb1);
    if constexpr (OP == kAdd)
      ap::add_mod<W>(x, x, y, fc.p);
    else
      ap::sub_mod<W>(x, x, y, fc.p);
  }
  store_row<W>(out + r * W, x);
}

template <int OP>
void launch_add_sub(const void* a, const void* b, void* out, const Rows& L,
                    const ap::FieldConsts<AP_W>& fc, cudaStream_t s) {
  field_add_sub_kernel<AP_W, OP><<<blocks_for(L.rows), kThreads, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, L, fc);
}

}  // namespace

static_assert(AP_W % 4 == 0, "rows are read as 16-byte vectors");

extern "C" {

// a, b: device pointers of the operands' first rows; (sa0, sa1), (sb0, sb1):
// their row strides in words over the n0 x n1 batch (a, b and every row
// 16-byte aligned); out: a contiguous [n0 n1, AP_W]; consts: host pointer to
// the packed FieldConsts<AP_W> words (p, n0, one).
int AP_ENTRY(ap_field_mul)(const void* a, const void* b, void* out, int64_t n0,
                           int64_t n1, int64_t sa0, int64_t sa1, int64_t sb0,
                           int64_t sb1, const void* consts, void* stream) {
  const auto fc = *static_cast<const ap::FieldConsts<AP_W>*>(consts);
  const Rows L{n0 * n1, (uint32_t)n1, sa0, sa1, sb0, sb1};
  const cudaStream_t s = (cudaStream_t)stream;
  if (L.rows > 0)
    field_mul_kernel<AP_W><<<blocks_for(L.rows), kThreads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, L, fc);
  return (int)cudaGetLastError();
}

// As ap_field_mul; op 0 adds, 1 subtracts b from a, 2 negates a (b unread).
int AP_ENTRY(ap_field_add_sub)(const void* a, const void* b, void* out,
                               int64_t n0, int64_t n1, int64_t sa0,
                               int64_t sa1, int64_t sb0, int64_t sb1, int op,
                               const void* consts, void* stream) {
  const auto fc = *static_cast<const ap::FieldConsts<AP_W>*>(consts);
  const Rows L{n0 * n1, (uint32_t)n1, sa0, sa1, sb0, sb1};
  const cudaStream_t s = (cudaStream_t)stream;
  if (L.rows > 0) {
    if (op == kAdd)
      launch_add_sub<kAdd>(a, b, out, L, fc, s);
    else if (op == kSub)
      launch_add_sub<kSub>(a, b, out, L, fc, s);
    else
      launch_add_sub<kNeg>(a, b, out, L, fc, s);
  }
  return (int)cudaGetLastError();
}

// Words of FieldConsts<AP_W>.
int AP_ENTRY(ap_field_consts_words)() {
  return (int)(sizeof(ap::FieldConsts<AP_W>) / sizeof(uint32_t));
}

}  // extern "C"
