// (phase(t) − 1) over the K = N/2 frequency bins of each batch column:
// the in-loop phase generator of a phase-rotation step.
//
// Replaces the Pallas kernel spf_tpu/ops/phase_rot.py::phase_minus_one_pallas
// (:147; body _phase_kernel :117, seeds _seed_factors :96). Bin m (natural
// order) holds C·Q^m with C = psi^t and Q = psi^(−4t), psi = e^(i·pi/N),
// built by geometric doubling: level j writes seq[2^j + m] =
// cmul(seq[m], q_j) for m < 2^j, q_j = Q^(2^j); then −1 is added to the real
// part (ds_add). C and every q_j are exact lookups into the 2N-entry ds
// table of psi^s (t reduced mod 2N here: the table index is t & (2N − 1)).
//
// Bit for bit with spf_tpu_torch/ops/phase_rot.py::phase_minus_one_plain,
// because every value is made by the same chain of ds32 operations:
// seq[m] is C multiplied by q_j for each set bit j of m, in increasing j,
// each product cmul(previous, q_j) with the operands in that order
// (ds.cuh, built with -fmad=false).
//
// What bounds it on an H100: the 4 output planes, 16·K·B bytes (4 MiB at
// K = 1024, B = 256: ~1.25 us at 3.35 TB/s). The doubling is K − 1 complex
// ds multiplies per column (~19 M f32 operations at that shape in the
// cheapest ds32 form, ~0.3 us at 67 TFLOP/s).
//
// Design: one thread per (column c, low index r < K/8). The thread builds
// seq[r] from C by the multiplies of r's set bits, then runs the last three
// doubling levels in registers, which gives it the 8 bins r + i·K/8 (the
// same multiplies the shared doubling would do at those levels). A warp
// holds 32 neighbouring columns, so each of its stores is 128 contiguous
// bytes of one output row. The optional inverse permutation sends bin m to
// row perm_inv[m]: the gather the TPU ran after its kernel, fused into the
// store. Any B is taken.

#include <cstdint>

#include "common.cuh"
#include "ds.cuh"

namespace {

constexpr int COLS = 32;  // columns per block (threadIdx.x)
constexpr int ROWS = 8;   // low indices per block (threadIdx.y)

struct table {
  const float *rh, *rl, *ih, *il;
  __device__ __forceinline__ dsc operator[](uint32_t i) const {
    return {__ldg(rh + i), __ldg(rl + i), __ldg(ih + i), __ldg(il + i)};
  }
};

// H: the doubling levels run in registers (2^H bins per thread)
template <int H>
__global__ void phase_kernel(const long long* __restrict__ t, table tab,
                             const int* __restrict__ perm_inv, float* __restrict__ orh,
                             float* __restrict__ orl, float* __restrict__ oih,
                             float* __restrict__ oil, int log_k, int b) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r = blockIdx.y * ROWS + threadIdx.y;
  const int low = log_k - H;
  if (c >= b || r >= (1 << low)) return;
  const uint32_t mask = (4u << log_k) - 1;  // 2N − 1
  const uint32_t tt = (uint32_t)(unsigned long long)t[c];
  // q_j = psi^(−4t·2^j mod 2N)
  auto q = [&](int j) { return tab[(0u - (tt << (2 + j))) & mask]; };

  dsc loc[1 << H];
  loc[0] = tab[tt & mask];
  for (int j = 0; j < low; ++j)
    if ((r >> j) & 1) loc[0] = cmul(loc[0], q(j));
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const dsc qj = q(low + h);
#pragma unroll
    for (int i = 0; i < (1 << h); ++i) loc[i + (1 << h)] = cmul(loc[i], qj);
  }
#pragma unroll
  for (int i = 0; i < (1 << H); ++i) {
    const int m = r + (i << low);
    const size_t o = (size_t)(perm_inv ? __ldg(perm_inv + m) : m) * b + c;
    const ds2 re = ds_add(loc[i].rh, loc[i].rl, -1.0f, 0.0f);
    orh[o] = re.h;
    orl[o] = re.l;
    oih[o] = loc[i].ih;
    oil[o] = loc[i].il;
  }
}

template <int H>
int launch(const long long* t, table tab, const int* perm_inv, float* orh, float* orl,
           float* oih, float* oil, int log_k, int b, cudaStream_t stream) {
  const dim3 block(COLS, ROWS);
  const dim3 grid((b + COLS - 1) / COLS, ((1 << (log_k - H)) + ROWS - 1) / ROWS);
  phase_kernel<H><<<grid, block, 0, stream>>>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b);
  return spf_last_error();
}

}  // namespace

// t int64 [B]; the psi table, 4 planes [2N]; perm_inv int32 [K] or null;
// out 4 planes [K, B]. K a power of two in [2, 2^15].
extern "C" int spf_phase_minus_one(const long long* t, const float* tab_rh, const float* tab_rl,
                                   const float* tab_ih, const float* tab_il, const int* perm_inv,
                                   float* orh, float* orl, float* oih, float* oil, int k, int b,
                                   void* stream) {
  if (k < 2 || k > (1 << 15) || (k & (k - 1)) || b < 1 || b > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  int log_k = 0;
  while ((1 << log_k) < k) ++log_k;
  const table tab{tab_rh, tab_rl, tab_ih, tab_il};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (log_k < 3 ? log_k : 3) {
    case 1: return launch<1>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, s);
    case 2: return launch<2>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, s);
    default: return launch<3>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, s);
  }
}
