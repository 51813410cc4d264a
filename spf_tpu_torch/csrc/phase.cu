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
// (ds.cuh, built with -fmad=false). Any schedule that forms every bin by
// that chain gives the same bits.
//
// What bounds it on an H100: the 4 output planes, 16·K·B bytes (4 MiB at
// K = 1024, B = 256: ~1.25 us at 3.35 TB/s). The doubling is K − 1 complex
// ds multiplies per column (~19 M f32 operations at that shape in the
// cheapest ds32 form, ~0.6 us at 33.45 T f32 instructions/s).
//
// Design: a block is COLS columns x ROWS low indices (COLS = MAX_COLS =
// 16, or the least power of two >= B, so that no lane idles at a small B;
// THREADS = 256 threads, halved down to MIN_THREADS while the grid has
// fewer than MIN_BLOCKS blocks, so that a small call still spreads over
// the SMs). The block first stages each of its columns' C and q_0 .. q_{J−1}
// (J = log2 K) in shared memory, every thread issuing all of its t loads,
// then all of its table loads, before it waits on any, one barrier: the
// chains then read no device memory. Each bin's output row perm_inv[m] is
// loaded before the stage, so its latency hides behind the stage's. A
// thread takes one low index r < K / 2^H, forms seq[r] from C by the
// multiplies of r's set bits (lowest first), then runs the last H =
// REG_LEVELS = 2 doubling levels in registers (1 at B <= NARROW_B, where
// twice the blocks timed faster), which gives it the 2^H bins r + i·K/2^H
// (the multiplies the shared doubling does at those levels): ~1.75 complex
// multiplies a bin at K = 1024. At K = 1024, B = 256: 256 blocks of 256
// threads, each storing 64-byte row segments (two whole 32-byte sectors a
// row). Every block loads its columns' table entries (a 32-byte sector
// each) for its 2^H·ROWS bins of a column: 16 columns x 16 low indices
// halve those loads against 32 x 8, which timed 0.5-0.7 us slower at
// B = 256 (PERF.md). The optional inverse
// permutation sends bin m to row perm_inv[m]: the gather the TPU ran after
// its kernel, fused into the store. Any B is taken.

#include <cstdint>

#include "common.cuh"
#include "ds.cuh"

namespace {

constexpr int THREADS = 256;     // a block, or fewer (below)
constexpr int MIN_THREADS = 64;  // a block at the least
constexpr int MIN_BLOCKS = 132;  // halve a block's threads while the grid has fewer (one an SM)
constexpr int MAX_COLS = 16;     // columns a block
constexpr int REG_LEVELS = 2;    // H: doubling levels in registers (2^H bins a thread)
constexpr int NARROW_B = 8;      // at B <= NARROW_B one level: twice the blocks
constexpr int MAX_ENTRIES = 16;  // C and q_0 .. q_{J−1}, J <= 15

struct table {
  const float *rh, *rl, *ih, *il;
};

// a block of blockDim.x threads: COLS columns x blockDim.x / COLS low indices
template <int H, int COLS>
__global__ void __launch_bounds__(THREADS)
    phase_kernel(const long long* __restrict__ t, table tab, const int* __restrict__ perm_inv,
                 float* __restrict__ orh, float* __restrict__ orl, float* __restrict__ oih,
                 float* __restrict__ oil, int log_k, int b) {
  __shared__ float stage[4][MAX_ENTRIES][COLS];  // entry 0: C; entry 1 + j: q_j
  const int tx = threadIdx.x % COLS;
  const int c0 = blockIdx.x * COLS;
  const int c = c0 + tx;
  const int r = blockIdx.y * (blockDim.x / COLS) + threadIdx.x / COLS;
  const int low = log_k - H;
  const bool live = c < b && r < (1 << low);
  // each bin's output row, loaded while the stage loads are in flight
  int row[1 << H];
#pragma unroll
  for (int i = 0; i < (1 << H); ++i) {
    const int m = r + (i << low);
    row[i] = live && perm_inv ? __ldg(perm_inv + m) : m;
  }
  // the stage: a thread's entries i = threadIdx.x + k·blockDim.x, every t
  // load issued before any table load, so the block waits one round trip
  // for each, whatever its size
  constexpr int PER = (MAX_ENTRIES * COLS + MIN_THREADS - 1) / MIN_THREADS;
  const int n_entries = (log_k + 1) * COLS;
  const uint32_t mask = (4u << log_k) - 1;  // 2N − 1
  uint32_t tt[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_entries) tt[k] = (uint32_t)(unsigned long long)t[min(c0 + i % COLS, b - 1)];
  }
  float val[PER][4];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_entries) {
      // C = psi^t; q_j = psi^(−4t·2^j mod 2N)
      const int e = i / COLS;
      const uint32_t idx = (e == 0 ? tt[k] : 0u - (tt[k] << (e + 1))) & mask;
      val[k][0] = __ldg(tab.rh + idx);
      val[k][1] = __ldg(tab.rl + idx);
      val[k][2] = __ldg(tab.ih + idx);
      val[k][3] = __ldg(tab.il + idx);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_entries)
#pragma unroll
      for (int p = 0; p < 4; ++p) stage[p][i / COLS][i % COLS] = val[k][p];
  }
  __syncthreads();
  if (!live) return;
  auto entry = [&](int e) {
    return dsc{stage[0][e][tx], stage[1][e][tx], stage[2][e][tx], stage[3][e][tx]};
  };

  dsc loc[1 << H];
  loc[0] = entry(0);
  for (uint32_t bits = r; bits; bits &= bits - 1)  // r's set bits, lowest first
    loc[0] = cmul(loc[0], entry(__ffs(bits)));     // q_j is entry j + 1
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const dsc qj = entry(low + h + 1);
#pragma unroll
    for (int i = 0; i < (1 << h); ++i) loc[i + (1 << h)] = cmul(loc[i], qj);
  }
#pragma unroll
  for (int i = 0; i < (1 << H); ++i) {
    const size_t o = (size_t)row[i] * b + c;
    const ds2 re = ds_add(loc[i].rh, loc[i].rl, -1.0f, 0.0f);
    orh[o] = re.h;
    orl[o] = re.l;
    oih[o] = loc[i].ih;
    oil[o] = loc[i].il;
  }
}

template <int H, int COLS>
int launch(const long long* t, table tab, const int* perm_inv, float* orh, float* orl,
           float* oih, float* oil, int log_k, int b, cudaStream_t stream) {
  const int lows = 1 << (log_k - H);
  int threads = THREADS;
  auto blocks = [&](int nt) {
    const int rows = nt / COLS;
    return (long long)((b + COLS - 1) / COLS) * ((lows + rows - 1) / rows);
  };
  while (threads > MIN_THREADS && threads / COLS > 1 && blocks(threads) < MIN_BLOCKS)
    threads /= 2;
  const int rows = threads / COLS;
  const dim3 grid((b + COLS - 1) / COLS, (lows + rows - 1) / rows);
  phase_kernel<H, COLS><<<grid, threads, 0, stream>>>(t, tab, perm_inv, orh, orl, oih, oil, log_k,
                                                      b);
  return spf_last_error();
}

// COLS: MAX_COLS, or the least power of two >= b
template <int H, int COLS = MAX_COLS>
int launch_cols(const long long* t, table tab, const int* perm_inv, float* orh, float* orl,
                float* oih, float* oil, int log_k, int b, cudaStream_t stream) {
  if constexpr (COLS > 1) {
    if (b <= COLS / 2)
      return launch_cols<H, COLS / 2>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, stream);
  }
  return launch<H, COLS>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, stream);
}

// H: REG_LEVELS; 1 at B <= NARROW_B (timed faster at B = 8), or log_k
// where K has fewer levels
template <int H = REG_LEVELS>
int launch_levels(const long long* t, table tab, const int* perm_inv, float* orh, float* orl,
                  float* oih, float* oil, int log_k, int b, cudaStream_t stream) {
  if constexpr (H > 1) {
    if (log_k < H || b <= NARROW_B)
      return launch_levels<H - 1>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, stream);
  }
  return launch_cols<H>(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, stream);
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
  return launch_levels(t, tab, perm_inv, orh, orl, oih, oil, log_k, b, (cudaStream_t)stream);
}
