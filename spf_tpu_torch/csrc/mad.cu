// Multi-bit MAD + Horner subset phases, the frequency-domain half of a
// blind-rotation step, with the step's (phase - 1) factors formed inside.
//
// Replaces the Pallas kernel spf_tpu/ops/mad_pallas.py::mad_horner_fused
// (:94) together with the per-bit phase combine that XLA fuses around it
// on the TPU (spf_tpu/ops/multibit.py:213-245). For every (bin, batch
// column) it forms the per-bit factors u_j from the step's hoisted
// outer-product halves, as combine_phase_minus_one does
// (spf_tpu_torch/ops/phase_rot.py):
//
//   u_j = cmul(hi[j][bin / Klo], lo[j][bin % Klo]), then -1 on the real part
//
// then the 2^g - 1 subset MADs of the l*(k+1) digit spectra with that
// subset's bootstrap-key row, then their Horner-factored sum:
//
//   R(j, base) = u_j (x) (M[base|2^j] + R(j+1, base|2^j)) + R(j+1, base)
//
// in the evaluation order of _mad_horner_body (mad_pallas.py:51-90), so it
// agrees with the plain version (combine_phase_minus_one per bit, freq_mad
// per subset, nested_subset_sum) bit for bit. It takes any B and any
// K = Klo * Khi up to 65,535, not only multiples of 128. Built for g = 3
// (the multi-bit PBS), g = 2 (the multi-bit rotation inside circuit
// bootstrapping, l = 4) and g = 1 (the single-bit phase_rot step: one MAD
// times (phase - 1), the order of bootstrap_u32.py:278-280). g = 0 is the
// plain MAD of one key row with no phase (freq_mad, bootstrap_u32.py:161;
// XLA glue on the TPU), the frequency-domain half of the single-bit plain
// and fuse_rot steps. k+1 = 2 (DEFAULT_128 and every 128-bit set but one)
// has its own instances, mad_horner_kernel below. Any other k+1 up to 8
// (the test sets' 3 and 4, GLWE_5_256_128's 6) runs mad_planes_kernel, or
// mad_plane_kernel where that was measured faster (one_plane, below).
//
// What bounds it on an H100: f32 instruction issue. At the main path's
// shapes (g = 3, k+1 = 2, l = 2, K = 1024, B = 256) it moves ~27 MB (~8 us
// at 3.35 TB/s) but issues 4 * 14 * (58 + 22) + 2 * (7 * 58 + 6 * 22) +
// 3 * 69 = 5,763 f32 instructions per (bin, column) (a ds complex multiply
// is 58 with the fma TwoProd, an add 22, a combine 69): 1.5 G, ~45 us at
// 128 a clock per SM. Almost all are single FADD / FMUL, one result per
// lane and clock, so the flop rate (which counts an FFMA twice) halves
// this bound. Tensor cores cannot help: ds32 needs exact f32 products,
// which TF32 and bf16 do not give.
//
// mad_horner_kernel (k+1 = 2): the instruction count first. TwoProd is one
// fma (ds.cuh), 2 instructions where the Veltkamp split took 17; the
// combine costs 69 per bit in registers instead of a 12.6 MB intermediate
// and ~60 eager operators a bit. A block is up to 128 columns of one bin
// (grid: column tiles x bins). It stages the bin's key rows in shared
// memory as 16-byte (re hi, re lo, im hi, im lo) entries, so each key read
// of the MAD is one broadcast 16-byte shared load at a fixed offset
// instead of four warp-broadcast global loads and their 64-bit address
// arithmetic. One thread per (bin, column): the 2^g - 1 subset
// accumulators of both output planes (56 floats at g = 3) and the g
// factors live in registers, with no spills; neighbouring threads take
// neighbouring columns (coalesced spectra, halves and outputs). At g = 3
// the (i, j) loop of the MAD stays rolled: unrolled over i, the kernel's
// code (~4k instructions) outgrows the instruction cache, which cost 12% on
// an H100; at g <= 2 the unrolled form is the faster one.
//
// The other k+1: the same bound, f32 issue for g >= 1 (at [l = 2, k+1 =
// 6, K = 128, B = 129], g = 3: 21.6 us of instructions against 1.7 us of
// bytes), bytes for g = 0. mad_planes_kernel: a block is one bin and
// PLANE_COLS = 32 * W columns, W warps an output plane (k+1 planes; W = 4,
// 2 or 1, the one that pads B least, the wider on a tie, so a ragged B
// wastes at most a warp's lanes a plane and a wide B shares the staged key
// rows among 128 columns). It stages the bin's key rows into every plane
// and the tile's l(k+1) digit spectra in shared memory once, all in flight
// at once (cp.async), while its first warps form each column's g phase
// factors once into shared memory. Each thread then runs one output
// plane's subset MADs from shared memory (the key reads a warp broadcast,
// the spectra conflict-free), so its registers do not grow with k+1 (the
// accumulators of all k+1 planes at k+1 = 6, g = 3 would be 168 floats).
// mad_plane_kernel is one output plane a block, up to 128 columns,
// the spectra read from device memory in its (i, j) loop: at B a multiple
// of 128 with a short MAD, and for a plain MAD of at most 6 steps at B <=
// 32, its k+1 times as many small blocks hide the loads better (an A/B on
// an H100: up to 11% faster there, up to 34% slower elsewhere). Each
// output plane's sums run in the same order as in the k+1 = 2 instances,
// so the bits are the same.

//
// spf_freq_mad_batched, below, is the g = 0 MAD under a batched row: batch
// column b reads its own GGSW row, the one at slot slots[b] of a GGSW
// buffer, in place (the rows circuit bootstrapping makes, one a column, or
// the wave machine's GGSW slot buffer). It computes what freq_mad_plain
// computes for a 5-dimensional row (XLA glue on the TPU:
// spf_tpu/ops/bootstrap_u32.py:161-178), in the same i-then-j order of
// cadd(acc, cmul(d, g)), bit for bit. Bound: device memory. At the wave
// machine's widest CMux wave (l = 4, k+1 = 2, K = 1024, B = 256) its
// distinct rows are up to 2 * 4 * 2 * 1024 * 16 B = 256 KB a slot (67 MB
// for 256 slots), the digit spectra 33.5 MB and the output 8.4 MB; its
// 16 complex multiply-adds a (bin, column) are ~10 us of f32 issue.
// Design (mad_batched_kernel): one thread a (bin, column), a warp 8 bins x
// 4 columns, so that a warp's row loads from a slot-major buffer fill whole
// 32-byte sectors (8 consecutive bins of 4 slots) and a block's two
// neighbouring warps share the sectors of the spectra and outputs; the k+1
// output accumulators stay in registers (k+1 a template parameter: 2, 3,
// 4, 6). Lanes that share a slot read the same row, which the L2 serves.
// The row gather is what holds it at ~half of its bound, not the loads'
// latency: without its row reads it took 0.0227 ms at B = 256 (0.0481 with
// them), and twelve redesigns timed against it on an H100 lost at some
// width of 32-256 (a ring of cp.async stages 3 steps ahead, bin x column
// tiles chosen by B, 1-4 steps of loads in flight a thread, 2 columns a
// thread, warps along 16 or 32 bins, L2-only row loads). What won at
// every width: each load asks the L2 for its whole 128-byte line on a
// miss (L2::128B) rather than the 32-byte sector, and the grid runs bin
// tiles first, so the four bin tiles that share a line of a row or a
// spectrum run side by side and find it there.

#include "common.cuh"
#include "ds.cuh"

namespace {

constexpr int THREADS = 128;
// multiply-adds per (i, j) above which the (i, j) loop stays rolled
constexpr int ROLL_ABOVE = 8;

struct Planes4 {
  const float *rh, *rl, *ih, *il;
  __device__ __forceinline__ dsc load(size_t i) const {
    return {__ldg(rh + i), __ldg(rl + i), __ldg(ih + i), __ldg(il + i)};
  }
};

// The step's (phase - 1) factor of each bit j < G at (bin, col):
// u_j = cmul(hi[j][bin / Klo], lo[j][bin % Klo]) - 1 (combine_phase_minus_one)
template <int G>
__device__ __forceinline__ void step_factors(const Planes4& lo, const Planes4& hi, int bin,
                                             int col, int k, int b, int klo, dsc* uu) {
  const int khi = k / klo;
  const size_t lo_at = (size_t)(bin % klo) * b + col;
  const size_t hi_at = (size_t)(bin / klo) * b + col;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const dsc f = cmul(hi.load((size_t)j * khi * b + hi_at), lo.load((size_t)j * klo * b + lo_at));
    const ds2 re = ds_add(f.rh, f.rl, -1.0f, 0.0f);
    uu[j] = {re.h, re.l, f.ih, f.il};
  }
}

// R(J, BASE) over the subset MADs M[0 .. 2^G - 2] of one output plane
template <int G, int J, int BASE>
struct Horner {
  static __device__ __forceinline__ dsc eval(const dsc* m, const dsc* u) {
    constexpr int WITH = BASE | (1 << J);
    if constexpr (J + 1 == G) {
      return cmul(m[WITH - 1], u[J]);
    } else {
      const dsc t = cadd(m[WITH - 1], Horner<G, J + 1, WITH>::eval(m, u));
      const dsc term = cmul(t, u[J]);
      return cadd(term, Horner<G, J + 1, BASE>::eval(m, u));
    }
  }
};

template <int KP1, int G>
__global__ void __launch_bounds__(THREADS)
    mad_horner_kernel(Planes4 dfft, Planes4 row, Planes4 lo, Planes4 hi, float* __restrict__ orh,
                      float* __restrict__ orl, float* __restrict__ oih, float* __restrict__ oil,
                      int l, int k, int b, int klo) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  constexpr int PER_IJ = NS * KP1;  // key-row values per (input plane, digit level)
  extern __shared__ float4 key[];   // [l][k+1][NS][k+1]: this bin's key rows
  const int bin = blockIdx.y;
  const int col = blockIdx.x * THREADS + threadIdx.x;

  // the block's bin's key rows, row[m, i, j, o] -> key[(j * KP1 + i) * PER_IJ + m * KP1 + o]
  for (int e = threadIdx.x; e < PER_IJ * KP1 * l; e += THREADS) {
    const int o = e % KP1, m = e / KP1 % NS, i = e / PER_IJ % KP1, j = e / (PER_IJ * KP1);
    const dsc r = row.load((size_t)(((m * KP1 + i) * l + j) * KP1 + o) * k + bin);
    key[e] = make_float4(r.rh, r.rl, r.ih, r.il);
  }
  __syncthreads();
  if (col >= b) return;
  const size_t plane = (size_t)k * b;
  const size_t idx = (size_t)bin * b + col;

  dsc uu[G == 0 ? 1 : G];
  if constexpr (G > 0) step_factors<G>(lo, hi, bin, col, k, b, klo, uu);

  dsc mads[NS][KP1];
#pragma unroll
  for (int m = 0; m < NS; ++m)
#pragma unroll
    for (int o = 0; o < KP1; ++o) mads[m][o] = {0.f, 0.f, 0.f, 0.f};

  // MAD: for each input plane i, digit level j: acc[m][o] += d[j, i] * row[m, i, j, o]
  const auto step = [&](int i, int j) {
    const dsc d = dfft.load((size_t)(j * KP1 + i) * plane + idx);
    const float4* kij = key + (j * KP1 + i) * PER_IJ;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
#pragma unroll
      for (int o = 0; o < KP1; ++o) {
        const float4 r = kij[m * KP1 + o];  // one broadcast 16-byte shared load
        mads[m][o] = cadd(mads[m][o], cmul(d, {r.x, r.y, r.z, r.w}));
      }
    }
  };
  if constexpr (NS * KP1 > ROLL_ABOVE) {
    // one loop body of NS * KP1 multiply-adds: unrolled over i, the kernel's
    // code outgrows the instruction cache
#pragma unroll 1
    for (int ij = 0; ij < KP1 * l; ++ij) step(ij / l, ij % l);
  } else {
#pragma unroll
    for (int i = 0; i < KP1; ++i)
      for (int j = 0; j < l; ++j) step(i, j);
  }

#pragma unroll
  for (int o = 0; o < KP1; ++o) {
    dsc v;
    if constexpr (G == 0) {
      v = mads[0][o];
    } else {
      dsc mo[NS];
#pragma unroll
      for (int m = 0; m < NS; ++m) mo[m] = mads[m][o];
      v = Horner<G, 0, 0>::eval(mo, uu);
    }
    const size_t out = (size_t)o * plane + idx;
    orh[out] = v.rh;
    orl[out] = v.rl;
    oih[out] = v.ih;
    oil[out] = v.il;
  }
}

// One 4-byte word from device memory into shared memory through the L1,
// asynchronously (cp.async, sm_80 and later): the copy holds no register.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ const float* plane_of(const Planes4& x, int p) {
  return p == 0 ? x.rh : p == 1 ? x.rl : p == 2 ? x.ih : x.il;
}

// The step's (phase - 1) factor of bit j at (bin, col), as step_factors
__device__ __forceinline__ dsc phase_factor(const Planes4& lo, const Planes4& hi, int j, int bin,
                                            int col, int k, int b, int klo) {
  const int khi = k / klo;
  const dsc f = cmul(hi.load((size_t)j * khi * b + (size_t)(bin / klo) * b + col),
                     lo.load((size_t)j * klo * b + (size_t)(bin % klo) * b + col));
  const ds2 re = ds_add(f.rh, f.rl, -1.0f, 0.0f);
  return {re.h, re.l, f.ih, f.il};
}

// The MAD for any k+1, one output plane a block: o = blockIdx.z,
// up to THREADS columns, the input planes i a runtime loop; otherwise
// mad_horner_kernel's steps in its order.
template <int G>
__global__ void __launch_bounds__(THREADS)
    mad_plane_kernel(Planes4 dfft, Planes4 row, Planes4 lo, Planes4 hi, float* __restrict__ orh,
                     float* __restrict__ orl, float* __restrict__ oih, float* __restrict__ oil,
                     int kp1, int l, int k, int b, int klo) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  extern __shared__ float4 key[];  // [k+1][l][NS]: this bin's key rows into plane o
  const int bin = blockIdx.y;
  const int o = blockIdx.z;
  const int col = blockIdx.x * THREADS + threadIdx.x;

  // row[m, i, j, o] -> key[(i * l + j) * NS + m]
  for (int e = threadIdx.x; e < NS * kp1 * l; e += THREADS) {
    const int m = e % NS, ij = e / NS;
    const dsc r = row.load((size_t)(((m * kp1 + ij / l) * l + ij % l) * kp1 + o) * k + bin);
    key[e] = make_float4(r.rh, r.rl, r.ih, r.il);
  }
  __syncthreads();
  if (col >= b) return;
  const size_t plane = (size_t)k * b;
  const size_t idx = (size_t)bin * b + col;

  dsc uu[G == 0 ? 1 : G];
  if constexpr (G > 0) step_factors<G>(lo, hi, bin, col, k, b, klo, uu);

  dsc mads[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) mads[m] = {0.f, 0.f, 0.f, 0.f};
  // for each input plane i, digit level j (i outer): acc[m] += d[j, i] * row[m, i, j, o]
#pragma unroll 1
  for (int ij = 0; ij < kp1 * l; ++ij) {
    const dsc d = dfft.load((size_t)(ij % l * kp1 + ij / l) * plane + idx);
    const float4* kij = key + ij * NS;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const float4 r = kij[m];
      mads[m] = cadd(mads[m], cmul(d, {r.x, r.y, r.z, r.w}));
    }
  }

  dsc v;
  if constexpr (G == 0) {
    v = mads[0];
  } else {
    v = Horner<G, 0, 0>::eval(mads, uu);
  }
  const size_t out = (size_t)o * plane + idx;
  orh[out] = v.rh;
  orl[out] = v.rl;
  oih[out] = v.ih;
  oil[out] = v.il;
}

constexpr int PLANE_MAX_KP1 = 8;  // output planes of a block
// the warps an output plane of a block a launch picks from, widest first
// (a block PLANE_COLS = 32 * W columns)
constexpr int PLANE_W_WIDE = 4, PLANE_W_MID = 2, PLANE_W_NARROW = 1;

// The MAD for any k+1 up to PLANE_MAX_KP1, every output plane a block:
// bin blockIdx.y and PLANE_COLS = 32 * W columns from blockIdx.x *
// PLANE_COLS, thread (o, c) = (threadIdx.x / PLANE_COLS, threadIdx.x %
// PLANE_COLS) the output plane o of column c; otherwise
// mad_horner_kernel's steps in its order.
template <int G, int W>
__global__ void __launch_bounds__(32 * W * PLANE_MAX_KP1)
    mad_planes_kernel(Planes4 dfft, Planes4 row, Planes4 lo, Planes4 hi, float* __restrict__ orh,
                      float* __restrict__ orl, float* __restrict__ oih, float* __restrict__ oil,
                      int kp1, int l, int k, int b, int klo) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  constexpr int PLANE_COLS = 32 * W;
  const int nij = kp1 * l;
  extern __shared__ float4 smem4[];
  float4* key = smem4;                                    // [ij][NS][k+1], ij = i * l + j
  float* spec = reinterpret_cast<float*>(key + nij * NS * kp1);  // [ij][4][PLANE_COLS]
  float* uf = spec + nij * 4 * PLANE_COLS;                // [G][4][PLANE_COLS]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int c = tid % PLANE_COLS, o = tid / PLANE_COLS;
  const int bin = blockIdx.y;
  const int col0 = blockIdx.x * PLANE_COLS, col = col0 + c;
  const size_t plane = (size_t)k * b;

  // the bin's key rows into every plane: row[m, i, j, oo] -> key[(ij * NS + m) * kp1 + oo]
  for (int e = tid; e < nij * NS * kp1; e += nthreads) {
    const int oo = e % kp1, m = e / kp1 % NS, ij = e / (kp1 * NS);
    const size_t at = (size_t)(((m * kp1 + ij / l) * l + ij % l) * kp1 + oo) * k + bin;
    float* dst = reinterpret_cast<float*>(key + e);
#pragma unroll
    for (int p = 0; p < 4; ++p) cp_async4(dst + p, plane_of(row, p) + at);
  }
  // the tile's digit spectra d[j, i], once for every plane
  for (int e = tid; e < nij * 4 * PLANE_COLS; e += nthreads) {
    const int cc = e % PLANE_COLS, p = e / PLANE_COLS % 4, ij = e / (4 * PLANE_COLS);
    if (col0 + cc < b)
      cp_async4(spec + e, plane_of(dfft, p) + (size_t)(ij % l * kp1 + ij / l) * plane +
                              (size_t)bin * b + col0 + cc);
  }
  cp_async_commit();
  // meanwhile each column's g phase factors, once: thread (j, c) forms u_j
  if constexpr (G > 0) {
    for (int e = tid; e < G * PLANE_COLS; e += nthreads) {
      const int cc = e % PLANE_COLS, j = e / PLANE_COLS;
      if (col0 + cc < b) {
        const dsc u = phase_factor(lo, hi, j, bin, col0 + cc, k, b, klo);
        float* dst = uf + j * 4 * PLANE_COLS + cc;
        dst[0] = u.rh;
        dst[PLANE_COLS] = u.rl;
        dst[2 * PLANE_COLS] = u.ih;
        dst[3 * PLANE_COLS] = u.il;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (col >= b) return;

  dsc uu[G == 0 ? 1 : G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float* u = uf + j * 4 * PLANE_COLS + c;
    uu[j] = {u[0], u[PLANE_COLS], u[2 * PLANE_COLS], u[3 * PLANE_COLS]};
  }
  dsc mads[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) mads[m] = {0.f, 0.f, 0.f, 0.f};
  // for each input plane i, digit level j (i outer): acc[m] += d[j, i] * row[m, i, j, o]
#pragma unroll 1
  for (int ij = 0; ij < nij; ++ij) {
    const float* s = spec + ij * 4 * PLANE_COLS + c;
    const dsc d = {s[0], s[PLANE_COLS], s[2 * PLANE_COLS], s[3 * PLANE_COLS]};
    const float4* kij = key + ij * NS * kp1 + o;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const float4 r = kij[m * kp1];  // one broadcast 16-byte shared load
      mads[m] = cadd(mads[m], cmul(d, {r.x, r.y, r.z, r.w}));
    }
  }

  dsc v;
  if constexpr (G == 0) {
    v = mads[0];
  } else {
    v = Horner<G, 0, 0>::eval(mads, uu);
  }
  const size_t out = (size_t)o * plane + (size_t)bin * b + col;
  orh[out] = v.rh;
  orl[out] = v.rl;
  oih[out] = v.ih;
  oil[out] = v.il;
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in, once; the
// H100 gives a block at most 227 KB.
constexpr size_t SMEM_DEFAULT = 48 * 1024, SMEM_MAX = 227 * 1024;

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  if (smem <= SMEM_DEFAULT || smem <= *allowed) return 0;
  const int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  if (err == 0) *allowed = smem;
  return err;
}

template <int G, int W>
int launch_planes_w(const Planes4& d, const Planes4& r, const Planes4& lo, const Planes4& hi,
                    float* o0, float* o1, float* o2, float* o3, int kp1, int l, int k, int b,
                    int klo, cudaStream_t stream) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  constexpr int PLANE_COLS = 32 * W;
  static size_t allowed = SMEM_DEFAULT;
  const size_t smem = sizeof(float4) * NS * kp1 * l * kp1 +
                      sizeof(float) * 4 * PLANE_COLS * (kp1 * l + G);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = allow_smem(mad_planes_kernel<G, W>, smem, &allowed)) return err;
  const dim3 grid((b + PLANE_COLS - 1) / PLANE_COLS, k);
  mad_planes_kernel<G, W><<<grid, PLANE_COLS * kp1, smem, stream>>>(d, r, lo, hi, o0, o1, o2, o3,
                                                                    kp1, l, k, b, klo);
  return spf_last_error();
}

// the warps an output plane that pad B least (a block 32 * W columns), the
// wider on a tie: a narrow B keeps its lanes busy, a wide one shares the
// key rows a block stages among more columns
int plane_warps(int b) {
  const auto padded = [b](int w) { return (b + 32 * w - 1) / (32 * w) * 32 * w; };
  const int narrower[] = {PLANE_W_MID, PLANE_W_NARROW};
  int best = PLANE_W_WIDE;
  for (const int w : narrower)
    if (padded(w) < padded(best)) best = w;
  return best;
}

template <int G>
int launch_one_plane(const Planes4& d, const Planes4& r, const Planes4& lo, const Planes4& hi,
                  float* o0, float* o1, float* o2, float* o3, int kp1, int l, int k, int b,
                  int klo, cudaStream_t stream) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  const size_t smem = sizeof(float4) * NS * kp1 * l;
  if (k > 65535 || kp1 > 65535 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b + THREADS - 1) / THREADS, k, kp1);
  mad_plane_kernel<G><<<grid, THREADS, smem, stream>>>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k,
                                                       b, klo);
  return spf_last_error();
}

// The one-plane kernel where the A/B on an H100 timed it faster than the
// all-planes one: B a multiple of its THREADS columns (no lane idle) with a
// short MAD, at most ONE_PLANE_PRODUCTS subset x plane products a step, and
// a plain MAD of at most ONE_PLANE_STEPS steps at B <= ONE_PLANE_B (both at
// the launch floor, where its k+1 times as many blocks win).
constexpr int ONE_PLANE_PRODUCTS = 12, ONE_PLANE_STEPS = 6, ONE_PLANE_B = 32;

bool one_plane(int g, int kp1, int l, int b) {
  const int products = (g == 0 ? 1 : (1 << g) - 1) * kp1;
  return (b % THREADS == 0 && products <= ONE_PLANE_PRODUCTS) ||
         (b <= ONE_PLANE_B && products * l <= ONE_PLANE_STEPS);
}

template <int G>
int launch_planes(const Planes4& d, const Planes4& r, const Planes4& lo, const Planes4& hi,
                  float* o0, float* o1, float* o2, float* o3, int kp1, int l, int k, int b,
                  int klo, cudaStream_t stream) {
  if (one_plane(G, kp1, l, b))
    return launch_one_plane<G>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, stream);
  if (k > 65535 || kp1 > PLANE_MAX_KP1) return static_cast<int>(cudaErrorInvalidValue);
  switch (plane_warps(b)) {
    case PLANE_W_WIDE:
      return launch_planes_w<G, PLANE_W_WIDE>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo,
                                               stream);
    case PLANE_W_MID:
      return launch_planes_w<G, PLANE_W_MID>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo,
                                              stream);
    default:
      return launch_planes_w<G, PLANE_W_NARROW>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo,
                                                 stream);
  }
}

template <int KP1, int G>
int launch(const Planes4& d, const Planes4& r, const Planes4& lo, const Planes4& hi, float* o0,
           float* o1, float* o2, float* o3, int l, int k, int b, int klo, cudaStream_t stream) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  const size_t smem = sizeof(float4) * NS * KP1 * KP1 * l;
  if (k > 65535 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b + THREADS - 1) / THREADS, k);
  mad_horner_kernel<KP1, G><<<grid, THREADS, smem, stream>>>(d, r, lo, hi, o0, o1, o2, o3, l, k, b,
                                                            klo);
  return spf_last_error();
}


// A 4-byte read-only load whose L2 miss fetches the whole 128-byte line
// (ld.global.nc with the L2::128B prefetch size), not only its 32-byte
// sector: the batched MAD's neighbouring bin tiles take the rest of the line.
__device__ __forceinline__ float ldg_line(const float* p) {
  float v;
  asm volatile("ld.global.nc.L2::128B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ dsc load_line(const Planes4& x, size_t i) {
  return {ldg_line(x.rh + i), ldg_line(x.rl + i), ldg_line(x.ih + i), ldg_line(x.il + i)};
}

constexpr int BATCHED_THREADS = 256;
constexpr int BATCHED_BINS = 8;  // bins of a warp (and of a block)
constexpr int BATCHED_COLS = BATCHED_THREADS / BATCHED_BINS;

// out[o][bin, col] = sum over i (outer), j of d[j, i][bin, col] *
// rows[slot(col), i, j, o][bin]; slot(col) = slots[col], or col without
// slots. The row element (s, i, j, o, bin) lies at
// s * s_slot + ((i * l + j) * KP1 + o) * s_ijo + bin * s_bin.
template <int KP1>
__global__ void __launch_bounds__(BATCHED_THREADS)
    mad_batched_kernel(Planes4 dfft, Planes4 rows, const int* __restrict__ slots,
                       float* __restrict__ orh, float* __restrict__ orl, float* __restrict__ oih,
                       float* __restrict__ oil, int l, int k, int b, int nslots, long long s_slot,
                       long long s_ijo, long long s_bin) {
  const int bin = blockIdx.x * BATCHED_BINS + (threadIdx.x % BATCHED_BINS);
  const int col = blockIdx.y * BATCHED_COLS + (threadIdx.x / BATCHED_BINS);
  if (bin >= k || col >= b) return;
  const size_t plane = (size_t)k * b;
  const size_t idx = (size_t)bin * b + col;
  const int s = slots == nullptr ? col : __ldg(slots + col);
  if (s < 0 || s >= nslots) {  // an index outside the buffer: NaN, never a stray read
    for (int o = 0; o < KP1; ++o) {
      const size_t out = (size_t)o * plane + idx;
      orh[out] = orl[out] = oih[out] = oil[out] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const size_t base = (size_t)s * s_slot + (size_t)bin * s_bin;
  dsc acc[KP1];
#pragma unroll
  for (int o = 0; o < KP1; ++o) acc[o] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < KP1; ++i) {
#pragma unroll 1
    for (int j = 0; j < l; ++j) {
      const dsc d = load_line(dfft, (size_t)(j * KP1 + i) * plane + idx);
      const size_t at = base + (size_t)((i * l + j) * KP1) * s_ijo;
#pragma unroll
      for (int o = 0; o < KP1; ++o) acc[o] = cadd(acc[o], cmul(d, load_line(rows, at + o * s_ijo)));
    }
  }
#pragma unroll
  for (int o = 0; o < KP1; ++o) {
    const size_t out = (size_t)o * plane + idx;
    orh[out] = acc[o].rh;
    orl[out] = acc[o].rl;
    oih[out] = acc[o].ih;
    oil[out] = acc[o].il;
  }
}

template <int KP1>
int launch_batched(const Planes4& d, const Planes4& r, const int* slots, float* o0, float* o1,
                   float* o2, float* o3, int l, int k, int b, int nslots, long long s_slot,
                   long long s_ijo, long long s_bin, cudaStream_t stream) {
  // bin tiles first: the tiles that share a 128-byte line run side by side
  const dim3 grid((k + BATCHED_BINS - 1) / BATCHED_BINS, (b + BATCHED_COLS - 1) / BATCHED_COLS);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  mad_batched_kernel<KP1><<<grid, BATCHED_THREADS, 0, stream>>>(
      d, r, slots, o0, o1, o2, o3, l, k, b, nslots, s_slot, s_ijo, s_bin);
  return spf_last_error();
}

}  // namespace

// dfft 4 x [l, k+1, K, B]; rows 4 x a GGSW buffer of nslots GGSWs, element
// (s, i, j, o, bin) at s * s_slot + ((i * l + j) * (k+1) + o) * s_ijo +
// bin * s_bin (a slot buffer [S, k+1, l, k+1, K] or a batched row
// [k+1, l, k+1, K, S]); slots int32 [B], or null for slot b = column b
// -> out 4 x [k+1, K, B]. A slot outside [0, nslots) gives NaN outputs.
extern "C" int spf_freq_mad_batched(const float* d0, const float* d1, const float* d2,
                                    const float* d3, const float* r0, const float* r1,
                                    const float* r2, const float* r3, const int* slots, float* o0,
                                    float* o1, float* o2, float* o3, int kp1, int l, int k, int b,
                                    int nslots, long long s_slot, long long s_ijo,
                                    long long s_bin, void* stream) {
  if (l < 1 || k < 1 || b < 1 || nslots < 1 || (long long)k * b >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes4 d{d0, d1, d2, d3}, r{r0, r1, r2, r3};
  cudaStream_t s = (cudaStream_t)stream;
  switch (kp1) {
    case 2: return launch_batched<2>(d, r, slots, o0, o1, o2, o3, l, k, b, nslots, s_slot, s_ijo, s_bin, s);
    case 3: return launch_batched<3>(d, r, slots, o0, o1, o2, o3, l, k, b, nslots, s_slot, s_ijo, s_bin, s);
    case 4: return launch_batched<4>(d, r, slots, o0, o1, o2, o3, l, k, b, nslots, s_slot, s_ijo, s_bin, s);
    case 6: return launch_batched<6>(d, r, slots, o0, o1, o2, o3, l, k, b, nslots, s_slot, s_ijo, s_bin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dfft 4 x [l, k+1, K, B]; row 4 x [2^g-1, k+1, l, k+1, K]; the step's
// phase factor halves lo 4 x [g, Klo, B] and hi 4 x [g, K / Klo, B]
// -> out 4 x [k+1, K, B]. g = 0: row 4 x [k+1, l, k+1, K], lo and hi unread.
extern "C" int spf_mad_horner(const float* d0, const float* d1, const float* d2, const float* d3,
                              const float* r0, const float* r1, const float* r2, const float* r3,
                              const float* lo0, const float* lo1, const float* lo2,
                              const float* lo3, const float* hi0, const float* hi1,
                              const float* hi2, const float* hi3, float* o0, float* o1, float* o2,
                              float* o3, int kp1, int l, int g, int k, int b, int klo,
                              void* stream) {
  if (kp1 < 1 || l < 1 || k < 1 || b < 1 || (long long)k * b >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g > 0 && (klo < 1 || k % klo != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const Planes4 d{d0, d1, d2, d3}, r{r0, r1, r2, r3}, lo{lo0, lo1, lo2, lo3},
      hi{hi0, hi1, hi2, hi3};
  cudaStream_t s = (cudaStream_t)stream;
  if (kp1 == 2) {
    switch (g) {
      case 0: return launch<2, 0>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      case 1: return launch<2, 1>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      case 2: return launch<2, 2>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      case 3: return launch<2, 3>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      default: break;
    }
  } else {
    switch (g) {
      case 0: return launch_planes<0>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      case 1: return launch_planes<1>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      case 2: return launch_planes<2>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      case 3: return launch_planes<3>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
