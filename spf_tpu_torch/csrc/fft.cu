// The ds32 negacyclic FFT, forward and inverse, in bit-reversed order.
//
// Replaces the Pallas kernels spf_tpu/ops/fft_pallas.py::fwd_ds (:258)
// and inv_ds (:294). Same transform, bit for bit with the plain version
// (spf_tpu_torch/ops/fft.py): the forward folds the N reals of a
// polynomial into K = N/2 complex values, twists them and runs log2(K)
// radix-2 DIF stages (natural order in, bit-reversed out); the inverse
// runs DIT stages from bit-reversed order, untwists (with 1/K) and
// unfolds. Each butterfly keeps the plain version's ds32 operations and
// operand order: DIF a = x_a + x_b, b = (x_a - x_b) * w; DIT t = x_b * w,
// a = x_a + t, b = x_a - t.
//
// What bounds it on an H100: f32 instruction issue. A butterfly is 102 f32
// instructions (a complex multiply 58, an add and a subtract 22 each, with
// the one-fma TwoProd of ds.cuh), the twist a complex multiply a point. At
// the main path's forward shape (P = 4 polynomials of N = 2048, B = 256)
// that is 0.60 G instructions, 17.8 us at 33.45 T/s (128 a clock per SM),
// against 33.6 MB moved, 10.0 us at 3.35 TB/s; the inverse at P = 2 is half
// of both.
//
// Design: a thread holds R = 8 points of one column in registers and runs
// 3 consecutive radix-2 stages on them there, 4 independent butterflies a
// stage; at K = 1024 the 10 stages are 4 passes (3 + 3 + 3 + 1). In a pass
// over the bits [lo, lo + 3) of the row index a thread's points are the
// rows that differ only in those bits; the other bits are the thread's
// index in its column. Between passes the points move through shared
// memory, one 16-byte (re hi, re lo, im hi, im lo) slot a point,
// XOR-swizzled so that no exchange has a bank conflict. The first pass
// reads device memory (the fold and the twist applied on the way in), the
// last writes it (the untwist and the unfold on the way out), so device
// memory is read and written once. A last pass of fewer than 3 stages
// splits a thread's points into independent groups and stores each group
// while the next computes. The twiddles are one compact table a direction,
// the twiddle of stage half h and index n < h at entry h + n (K - 1
// entries, word for word the plain version's), then the twist, read as
// 16-byte loads through the read-only cache; the threads of one row share
// each.
//
// A block is K / R threads a column times bc neighbouring columns, which
// decides how much of each 32-byte sector one warp's load or store fills
// (bc * 4 bytes): stores that fill half a sector cost ~13 us of 54 in A/B
// runs on an H100 (spf_tpu_torch/scripts/fft_ab.py). So a call takes
// 1024-thread blocks (bc = 8 at K = 1024, one block an SM, 128 KB of
// shared memory, 64 registers) when there are enough of them to give every
// SM one, and 512-thread blocks (bc = 4) when there are not, as for the
// inverse at P = 2 (512 columns: 64 blocks of 8 or 128 of 4). R = 8 and
// not 16 for the size of the code: inside the paths, where each launch
// follows other kernels, the R = 16 kernels (~7,500 instructions with the
// grouped stores) ran 31-47% slower than alone, back to back, while the
// R = 8 ones run as fast as alone. What is left is latency: every call is
// one wave in which all blocks load, compute and store in step.

#include "common.cuh"
#include "ds.cuh"

namespace {

constexpr int R_MAX = 8;  // points a thread holds

// the row of a thread's j-th point in a pass over the bits [lo, lo + s)
__device__ __forceinline__ int row_of(int t, int j, int lo, int s) {
  return (t & ((1 << lo) - 1)) | (j << lo) | ((t >> lo) << (lo + s));
}

// the exchange slot of (row, column c): bc = 2^log_bc columns a row, the
// low 3 bits of the slot XORed with the next 3 (16-byte slots, 8 to the 32
// banks), which leaves every exchange at R = 8 free of bank conflicts
__device__ __forceinline__ int slot(int row, int c, int log_bc) {
  const int i = (row << log_bc) | c;
  return i ^ ((i >> 3) & 7);
}

__device__ __forceinline__ float4 pack(const dsc& v) { return make_float4(v.rh, v.rl, v.ih, v.il); }
__device__ __forceinline__ dsc unpack(const float4& v) { return {v.x, v.y, v.z, v.w}; }

// Where a thread sits: column c of the block's bc, index t of the K / R
// threads of its column, and the full passes of the schedule: log2 K = S *
// nfull + REM, the REM < S stages left over run in a last, partial pass.
template <int R>
struct Layout {
  static constexpr int S = R == 2 ? 1 : R == 4 ? 2 : 3;
  static_assert(1 << S == R, "R must be 2, 4 or 8");
  int log_k, log_bc, c, t, nfull;

  __device__ Layout(int log_k_, int log_bc_)
      : log_k(log_k_), log_bc(log_bc_), c(threadIdx.x & ((1 << log_bc_) - 1)),
        t(threadIdx.x >> log_bc_), nfull(log_k_ / S) {}

  // the full passes: DIF from the top bits down, DIT from the bottom bits up
  __device__ int dif_lo(int p) const { return log_k - S * (p + 1); }
  __device__ int dit_lo(int p) const { return S * p; }

  // the pass's points to shared memory and the next pass's back
  __device__ void exchange(dsc (&x)[R], float4* sm, int lo_from, int lo_to, bool first) const {
    if (!first) __syncthreads();  // the previous exchange's reads are done
#pragma unroll
    for (int j = 0; j < R; ++j) sm[slot(row_of(t, j, lo_from, S), c, log_bc)] = pack(x[j]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = unpack(sm[slot(row_of(t, j, lo_to, S), c, log_bc)]);
  }
};

// The radix-2 butterfly of the pair (j, j | 2^i) on local bit i of a pass
// over the bits [lo, lo + S): half h = 2^(lo + i), twiddle w_{2h}^n, n the
// a-row mod h.
template <int R, bool INVERSE>
__device__ __forceinline__ void butterfly(dsc (&x)[R], const float4* __restrict__ tw, int base,
                                          int lo, int i, int j) {
  const int h = 1 << (lo + i);
  const int jb = j | (1 << i);
  const dsc w = unpack(__ldg(tw + h + ((base & (h - 1)) | ((j & ((1 << i) - 1)) << lo))));
  const dsc a = x[j];
  if (!INVERSE) {
    x[j] = cadd(a, x[jb]);
    x[jb] = cmul(csub(a, x[jb]), w);
  } else {
    const dsc t = cmul(x[jb], w);
    x[j] = cadd(a, t);
    x[jb] = csub(a, t);
  }
}

// One stage on local bit i: R/2 independent butterflies.
template <int R, bool INVERSE>
__device__ __forceinline__ void stage(dsc (&x)[R], const float4* __restrict__ tw, int base, int lo,
                                      int i) {
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (!(j & (1 << i))) butterfly<R, INVERSE>(x, tw, base, lo, i, j);
}

// The last pass when it is partial (REM < S stages, on the low bits for
// DIF, the high bits for DIT): the pass's other local bits split a
// thread's points into independent groups (DIF: j >> REM; DIT: j's low
// S - REM bits), and each group runs its stages and is stored, put(j),
// before the next, so that one group's stores overlap the next group's
// arithmetic (at K = 1024, 4 groups of 2 points).
template <int R, bool INVERSE, int REM>
__device__ __forceinline__ int group_of(int j) {
  return INVERSE ? (j & ((1 << (Layout<R>::S - REM)) - 1)) : (j >> REM);
}

template <int R, bool INVERSE, int REM, typename Put>
__device__ __forceinline__ void last_pass(dsc (&x)[R], const float4* __restrict__ tw, int base,
                                          int lo, Put put) {
  constexpr int S = Layout<R>::S;
#pragma unroll
  for (int q = 0; q < (R >> REM); ++q) {
#pragma unroll
    for (int s = 0; s < REM; ++s) {
      const int i = INVERSE ? S - REM + s : REM - 1 - s;
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (!(j & (1 << i)) && group_of<R, INVERSE, REM>(j) == q)
          butterfly<R, INVERSE>(x, tw, base, lo, i, j);
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (group_of<R, INVERSE, REM>(j) == q) put(j);
  }
}

// hi, lo [P, 2K, B] -> out [4, P, K, B]; tab: K twiddle entries, then K twist
template <int R, int THREADS, int REM>
__global__ void __launch_bounds__(THREADS, 1)
fwd_ds_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
              const float4* __restrict__ tab, float* __restrict__ out, int log_k, int log_bc,
              int b, int tiles, size_t plane) {
  extern __shared__ float4 sm[];
  const Layout<R> g(log_k, log_bc);
  constexpr int S = Layout<R>::S;
  const int k = 1 << log_k;
  const int poly = blockIdx.x / tiles;
  const int col = ((blockIdx.x - poly * tiles) << log_bc) + g.c;
  const bool valid = col < b;
  const float* hi_c = hi + (size_t)poly * 2 * k * b + col;
  const float* lo_c = lo + (size_t)poly * 2 * k * b + col;
  dsc x[R];

  // fold z = x[:K] + i x[K:], then twist
  int lo_b = g.dif_lo(0);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = row_of(g.t, j, lo_b, S);
    dsc z = {0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const size_t a = (size_t)r * b, c = (size_t)(r + k) * b;
      z = {hi_c[a], lo_c[a], hi_c[c], lo_c[c]};
    }
    x[j] = cmul(z, unpack(__ldg(tab + k + r)));
  }

  // DIF stages, half K/2 .. 1, S of them a pass; a partial last pass
  // stores each of its groups as soon as it is done
  for (int p = 0; p < g.nfull; ++p) {
    if (p > 0) {
      const int next = g.dif_lo(p);
      g.exchange(x, sm, lo_b, next, p == 1);
      lo_b = next;
    }
    const int base = row_of(g.t, 0, lo_b, S);
#pragma unroll
    for (int i = S - 1; i >= 0; --i) stage<R, false>(x, tab, base, lo_b, i);
  }
  float* o = out + (size_t)poly * k * b + col;
  auto put = [&](int j) {
    if (valid) {
      const size_t a = (size_t)row_of(g.t, j, lo_b, S) * b;
      o[a] = x[j].rh;
      o[plane + a] = x[j].rl;
      o[2 * plane + a] = x[j].ih;
      o[3 * plane + a] = x[j].il;
    }
  };
  if constexpr (REM > 0) {
    g.exchange(x, sm, lo_b, 0, g.nfull == 1);
    lo_b = 0;
    last_pass<R, false, REM>(x, tab, row_of(g.t, 0, 0, S), 0, put);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) put(j);
  }
}

// 4 planes [P, K, B] -> out [2, P, 2K, B] (hi, lo); tab as above
template <int R, int THREADS, int REM>
__global__ void __launch_bounds__(THREADS, 1)
inv_ds_kernel(const float* __restrict__ rh, const float* __restrict__ rl,
              const float* __restrict__ ih, const float* __restrict__ il,
              const float4* __restrict__ tab, float* __restrict__ out, int log_k, int log_bc,
              int b, int tiles, size_t plane) {
  extern __shared__ float4 sm[];
  const Layout<R> g(log_k, log_bc);
  constexpr int S = Layout<R>::S;
  const int k = 1 << log_k;
  const int poly = blockIdx.x / tiles;
  const int col = ((blockIdx.x - poly * tiles) << log_bc) + g.c;
  const bool valid = col < b;
  const size_t in = (size_t)poly * k * b + col;
  dsc x[R];

  int lo_b = g.dit_lo(0);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const size_t a = in + (size_t)row_of(g.t, j, lo_b, S) * b;
    x[j] = valid ? dsc{rh[a], rl[a], ih[a], il[a]} : dsc{0.f, 0.f, 0.f, 0.f};
  }

  // DIT stages, half 1 .. K/2, S of them a pass; a partial last pass
  // stores each of its groups as soon as it is done
  for (int p = 0; p < g.nfull; ++p) {
    if (p > 0) {
      const int next = g.dit_lo(p);
      g.exchange(x, sm, lo_b, next, p == 1);
      lo_b = next;
    }
    const int base = row_of(g.t, 0, lo_b, S);
#pragma unroll
    for (int i = 0; i < S; ++i) stage<R, true>(x, tab, base, lo_b, i);
  }
  // untwist (and 1/K), unfold: hi = [re_hi ; im_hi], lo = [re_lo ; im_lo]
  float* o = out + (size_t)poly * 2 * k * b + col;
  auto put = [&](int j) {
    if (valid) {
      const int r = row_of(g.t, j, lo_b, S);
      const dsc v = cmul(x[j], unpack(__ldg(tab + k + r)));
      const size_t a = (size_t)r * b, c = (size_t)(r + k) * b;
      o[a] = v.rh;
      o[plane + a] = v.rl;
      o[c] = v.ih;
      o[plane + c] = v.il;
    }
  };
  if constexpr (REM > 0) {
    const int next = log_k - S;
    g.exchange(x, sm, lo_b, next, g.nfull == 1);
    lo_b = next;
    last_pass<R, true, REM>(x, tab, row_of(g.t, 0, lo_b, S), lo_b, put);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) put(j);
  }
}

int log2_exact(int k) {
  int l = 0;
  while ((1 << l) < k) ++l;
  return (1 << l) == k ? l : -1;
}

// The current device and its SM count (queried once per device).
int device_sms(int* dev, int* sms) {
  static int by_device[64];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev < 0 || *dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (by_device[*dev] == 0) {
    err = cudaDeviceGetAttribute(&by_device[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = by_device[*dev];
  return 0;
}

// The launch shape: R = min(R_MAX, K) points a thread, K / R threads a
// column, 1024 or 512 threads a block (see the note above). Returns 0 or a
// cudaError_t.
struct Launch {
  int r, log_k, log_bc, tiles, threads, dev;
  unsigned blocks;

  int init(int p, int k, int b) {
    log_k = log2_exact(k);
    if (log_k < 1 || k > 2048 || p < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    if (int err = device_sms(&dev, &sms)) return err;
    r = k < R_MAX ? k : R_MAX;
    for (threads = 1024;; threads = 512) {
      log_bc = log2_exact(threads / (k / r));
      tiles = (b + (1 << log_bc) - 1) >> log_bc;
      const long long nblocks = (long long)tiles * p;
      if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      blocks = static_cast<unsigned>(nblocks);
      if (threads == 512 || 10LL * nblocks >= 9LL * sms) return 0;
    }
  }
  size_t smem() const { return (size_t)threads * r * sizeof(float4); }
};

// Raises a kernel's shared-memory limit, once per device: `done` is the
// calling launcher's own flag set.
template <typename Kernel>
int allow_smem(Kernel kernel, const Launch& l, bool* done) {
  if (done[l.dev]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(l.smem()));
  done[l.dev] = err == cudaSuccess;
  return static_cast<int>(err);
}

template <int R, int THREADS, int REM>
int launch_fwd(const Launch& l, const float* hi, const float* lo, const float* tab, float* out,
               size_t plane, int b, cudaStream_t stream) {
  static bool done[64];
  if (int err = allow_smem(fwd_ds_kernel<R, THREADS, REM>, l, done)) return err;
  fwd_ds_kernel<R, THREADS, REM><<<l.blocks, THREADS, l.smem(), stream>>>(
      hi, lo, reinterpret_cast<const float4*>(tab), out, l.log_k, l.log_bc, b, l.tiles, plane);
  return spf_last_error();
}

template <int R, int THREADS, int REM>
int launch_inv(const Launch& l, const float* rh, const float* rl, const float* ih,
               const float* il, const float* tab, float* out, size_t plane, int b,
               cudaStream_t stream) {
  static bool done[64];
  if (int err = allow_smem(inv_ds_kernel<R, THREADS, REM>, l, done)) return err;
  inv_ds_kernel<R, THREADS, REM><<<l.blocks, THREADS, l.smem(), stream>>>(
      rh, rl, ih, il, reinterpret_cast<const float4*>(tab), out, l.log_k, l.log_bc, b, l.tiles,
      plane);
  return spf_last_error();
}

// R = K below 8 (one full pass); at R = 8 the last pass has log2 K mod 3
// stages (0: none).
template <int THREADS>
int fwd(const Launch& l, const float* hi, const float* lo, const float* tab, float* out,
        size_t plane, int b, cudaStream_t s) {
  switch (l.r == R_MAX ? l.log_k % 3 : -l.r) {
    case -2: return launch_fwd<2, THREADS, 0>(l, hi, lo, tab, out, plane, b, s);
    case -4: return launch_fwd<4, THREADS, 0>(l, hi, lo, tab, out, plane, b, s);
    case 0: return launch_fwd<8, THREADS, 0>(l, hi, lo, tab, out, plane, b, s);
    case 1: return launch_fwd<8, THREADS, 1>(l, hi, lo, tab, out, plane, b, s);
    default: return launch_fwd<8, THREADS, 2>(l, hi, lo, tab, out, plane, b, s);
  }
}

template <int THREADS>
int inv(const Launch& l, const float* rh, const float* rl, const float* ih, const float* il,
        const float* tab, float* out, size_t plane, int b, cudaStream_t s) {
  switch (l.r == R_MAX ? l.log_k % 3 : -l.r) {
    case -2: return launch_inv<2, THREADS, 0>(l, rh, rl, ih, il, tab, out, plane, b, s);
    case -4: return launch_inv<4, THREADS, 0>(l, rh, rl, ih, il, tab, out, plane, b, s);
    case 0: return launch_inv<8, THREADS, 0>(l, rh, rl, ih, il, tab, out, plane, b, s);
    case 1: return launch_inv<8, THREADS, 1>(l, rh, rl, ih, il, tab, out, plane, b, s);
    default: return launch_inv<8, THREADS, 2>(l, rh, rl, ih, il, tab, out, plane, b, s);
  }
}

}  // namespace

// hi, lo [P, 2K, B] -> out [4, P, K, B] (re hi, re lo, im hi, im lo);
// tab [2K, 4]: the forward twiddles (entry h + n), then the twist
extern "C" int spf_fwd_ds(const float* hi, const float* lo, const float* tab, float* out, int p,
                          int k, int b, void* stream) {
  Launch l;
  if (int err = l.init(p, k, b)) return err;
  const size_t plane = (size_t)p * k * b;
  const auto s = static_cast<cudaStream_t>(stream);
  return l.threads == 1024 ? fwd<1024>(l, hi, lo, tab, out, plane, b, s)
                          : fwd<512>(l, hi, lo, tab, out, plane, b, s);
}

// 4 planes [P, K, B] -> out [2, P, 2K, B] (hi, lo); tab [2K, 4]: the
// inverse twiddles, then the untwist (with 1/K)
extern "C" int spf_inv_ds(const float* rh, const float* rl, const float* ih, const float* il,
                          const float* tab, float* out, int p, int k, int b, void* stream) {
  Launch l;
  if (int err = l.init(p, k, b)) return err;
  const size_t plane = (size_t)p * 2 * k * b;
  const auto s = static_cast<cudaStream_t>(stream);
  return l.threads == 1024 ? inv<1024>(l, rh, rl, ih, il, tab, out, plane, b, s)
                          : inv<512>(l, rh, rl, ih, il, tab, out, plane, b, s);
}
