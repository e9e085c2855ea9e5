// LayerNorm over the last axis, for Hopper (sm_90a): a forward that writes y
// and each row's mean and rstd, and a fused backward that writes dx and each
// block's partial dgamma and dbeta in one pass over the rows, then sums the
// partials over the blocks in a second, small pass.
//
// Replaces: no TPU kernel. The JAX package leaves LayerNorm (flax's
// nn.LayerNorm) to XLA, which fuses it into its neighbours on the TPU. In
// the port it ran as PyTorch's own kernels (the forward, the dx kernel and
// the weight-gradient kernel, with autocast's casts to and from f32 around
// them), the largest ops outside the products and the attention kernels in
// the bf16 train step, at B x Lv = 65,536 rows of 256 at TACoS's shapes.
//
// What it computes, row by row of x (rows, d), eps from the caller:
//   mean = sum_j x_j / d,  var = sum_j (x_j - mean)^2 / d (biased),
//   rstd = rsqrt(var + eps),  y = (x - mean) rstd gamma + beta   (f32)
// and the backward, from dy (f32), x and the forward's mean and rstd:
//   xh = (x - mean) rstd,  g = dy gamma,
//   dx = rstd (g - sum_j g_j / d - xh sum_j g_j xh_j / d)       (x's dtype)
//   dgamma = sum_rows dy xh,  dbeta = sum_rows dy                 (f32)
// x is float32 or bfloat16 (what autocast's products hand on); every sum is
// taken in f32. y in f32 is autocast's f32 policy for layer_norm, which cast
// a bf16 x to f32 first: widening is exact, so y is the same function; dx in
// x's dtype is the same rounding as autograd's cast back.
//
// What bounds it: bytes. A forward reads x and writes y (f32 x at 65,536 x
// 256: 134 MB, 40 us at 3.35 TB/s); the backward reads x and dy and writes
// dx (201 MB, 60 us), against about ten operations an element. The design:
//  * rows up to kMaxWarpWidth wide: one warp a row, held in registers from
//    one read, in 16-byte loads where d allows (ITERS loads of VEC elements
//    a lane; the widest VEC that divides d); mean and variance by two warp
//    butterflies over the registers (two-pass, no second read);
//  * wider rows (the 2818- and 4096-wide input projections): one block a
//    row, re-read from L1 / L2 for each pass;
//  * the backward runs one wave of blocks (as many as fit on the card at
//    once, ops/layer_norm.py asks flashvtg_layer_norm_bwd_blocks); each warp
//    (each block, for wide rows) takes a contiguous run of rows and keeps
//    its dgamma / dbeta sums for its columns in registers (shared memory,
//    for wide rows) over them, so the weight gradient costs one write of
//    [blocks, d] partials and not a second pass over dy and x; the block's
//    warps add theirs in warp order, and the sum kernel adds the blocks'
//    in block order: no atomics, so a graph replay gives the same bits;
//  * the dx write is skipped where no input gradient is wanted (dx null:
//    the layer norms over the input features).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps a block, in every kernel but the sum
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWarpWidth = 1024;  // the widest row one warp holds
constexpr int kMaxWidth = 16384;     // the wide backward's [2, d] f32 in shared memory
constexpr int kSumCols = 32, kSumSplit = 32;  // the sum kernel's block
constexpr int kWideRows = 8;  // the fewest rows a block of the wide backward takes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive elements, loaded and stored as one access of up to 16 bytes
// (a 32-byte pack of floats goes as two)
template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

// a butterfly: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sums of a and b over the block, the warps' in warp order, the same
// bits in every thread; red is [2][kWarps] of shared memory
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
  __syncthreads();  // red is reused
}

// ---- forward ---------------------------------------------------------------

// one warp a row; lane l holds the VEC elements from column (32 i + l) VEC,
// i < ITERS (ITERS 32 VEC >= d; d % VEC == 0)
template <typename T, int VEC, int ITERS>
__global__ void __launch_bounds__(kThreads)
    vtg_layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, float* __restrict__ y,
                              float* __restrict__ stats, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  float v[ITERS][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int c = (32 * i + lane) * VEC;
    if (c < d) {
      const Pack<T, VEC> p = load<T, VEC>(xr + c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[i][k] = to_f32(p.v[k]);
        sum += v[i][k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[i][k] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    if ((32 * i + lane) * VEC < d) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float t = v[i][k] - mean;
        sq += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
  float* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int c = (32 * i + lane) * VEC;
    if (c < d) {
      const Pack<float, VEC> g = load<float, VEC>(gamma + c);
      const Pack<float, VEC> b = load<float, VEC>(beta + c);
      Pack<float, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) o.v[k] = (v[i][k] - mean) * rstd * g.v[k] + b.v[k];
      store<float, VEC>(yr + c, o);
    }
  }
  if (stats != nullptr && lane == 0) {
    stats[row] = mean;
    stats[rows + row] = rstd;
  }
}

// one block a row, for rows wider than a warp holds
template <typename T>
__global__ void __launch_bounds__(kThreads)
    vtg_layer_norm_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ y,
                                   float* __restrict__ stats, int rows, int d, float eps) {
  __shared__ float red[2 * kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  float sum = 0.f, unused = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads) sum += to_f32(xr[j]);
  block_sum2(sum, unused, red);
  const float mean = sum / d;
  float sq = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float t = to_f32(xr[j]) - mean;
    sq += t * t;
  }
  unused = 0.f;
  block_sum2(sq, unused, red);
  const float rstd = rsqrtf(sq / d + eps);
  float* yr = y + row * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    yr[j] = (to_f32(xr[j]) - mean) * rstd * gamma[j] + beta[j];
  }
  if (stats != nullptr && threadIdx.x == 0) {
    stats[row] = mean;
    stats[rows + row] = rstd;
  }
}

// ---- backward --------------------------------------------------------------

// one warp a row at a time, over a contiguous run of rows a warp; part is
// [2, gridDim.x, d]: each block's dgamma, then its dbeta
template <typename T, int VEC, int ITERS>
__global__ void __launch_bounds__(kThreads)
    vtg_layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                              const float* __restrict__ stats, const float* __restrict__ gamma,
                              T* __restrict__ dx, float* __restrict__ part, int rows, int d) {
  __shared__ float acc[2][kMaxWarpWidth];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t per = (rows + warps - 1) / warps;
  const int64_t first = ((int64_t)blockIdx.x * kWarps + warp) * per;
  const int64_t last = first + per < rows ? first + per : rows;
  const float inv_d = 1.f / d;
  float dg[ITERS][VEC], db[ITERS][VEC];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) dg[i][k] = db[i][k] = 0.f;
  }
  for (int64_t r = first; r < last; ++r) {
    const float mean = stats[r], rstd = stats[rows + r];
    const T* xr = x + r * d;
    const float* dyr = dy + r * d;
    float xh[ITERS][VEC], g[ITERS][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int c = (32 * i + lane) * VEC;
      if (c < d) {
        const Pack<T, VEC> xp = load<T, VEC>(xr + c);
        const Pack<float, VEC> dp = load<float, VEC>(dyr + c);
        const Pack<float, VEC> gp = load<float, VEC>(gamma + c);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          xh[i][k] = (to_f32(xp.v[k]) - mean) * rstd;
          g[i][k] = dp.v[k] * gp.v[k];
          s1 += g[i][k];
          s2 += g[i][k] * xh[i][k];
          dg[i][k] += dp.v[k] * xh[i][k];
          db[i][k] += dp.v[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xh[i][k] = g[i][k] = 0.f;
      }
    }
    if (dx == nullptr) continue;  // the same branch in every lane
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    T* dxr = dx + r * d;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int c = (32 * i + lane) * VEC;
      if (c < d) {
        Pack<T, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(rstd * (g[i][k] - m1 - xh[i][k] * m2));
        store<T, VEC>(dxr + c, o);
      }
    }
  }
  // the block's partials: its warps' sums added in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < ITERS; ++i) {
        const int c = (32 * i + lane) * VEC;
        if (c < d) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            acc[0][c + k] = w == 0 ? dg[i][k] : acc[0][c + k] + dg[i][k];
            acc[1][c + k] = w == 0 ? db[i][k] : acc[1][c + k] + db[i][k];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < d; j += kThreads) {
    part[(int64_t)blockIdx.x * d + j] = acc[0][j];
    part[((int64_t)gridDim.x + blockIdx.x) * d + j] = acc[1][j];
  }
}

// one block a row at a time, rows blockIdx.x, blockIdx.x + gridDim.x, ...;
// thread t keeps the sums of columns t, t + kThreads, ... in shared memory
// (2 d floats, dynamic)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    vtg_layer_norm_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                                   const float* __restrict__ stats,
                                   const float* __restrict__ gamma, T* __restrict__ dx,
                                   float* __restrict__ part, int rows, int d) {
  extern __shared__ float acc[];  // [2][d]
  __shared__ float red[2 * kWarps];
  const float inv_d = 1.f / d;
  for (int j = threadIdx.x; j < d; j += kThreads) acc[j] = acc[d + j] = 0.f;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const float mean = stats[r], rstd = stats[rows + r];
    const T* xr = x + r * d;
    const float* dyr = dy + r * d;
    float s1 = 0.f, s2 = 0.f;
    for (int j = threadIdx.x; j < d; j += kThreads) {
      const float xh = (to_f32(xr[j]) - mean) * rstd, dv = dyr[j], g = dv * gamma[j];
      s1 += g;
      s2 += g * xh;
      acc[j] += dv * xh;
      acc[d + j] += dv;
    }
    if (dx == nullptr) continue;  // the same branch in every thread
    block_sum2(s1, s2, red);
    const float m1 = s1 * inv_d, m2 = s2 * inv_d;
    T* dxr = dx + r * d;
    for (int j = threadIdx.x; j < d; j += kThreads) {
      const float xh = (to_f32(xr[j]) - mean) * rstd, g = dyr[j] * gamma[j];
      dxr[j] = from_f32<T>(rstd * (g - m1 - xh * m2));
    }
  }
  for (int j = threadIdx.x; j < d; j += kThreads) {
    part[(int64_t)blockIdx.x * d + j] = acc[j];
    part[((int64_t)gridDim.x + blockIdx.x) * d + j] = acc[d + j];
  }
}

// dgamma and dbeta from part [2, blocks, d]: column c of the 2 d takes its
// blocks in kSumSplit strided runs, each in block order, then the runs in
// order; the same order at every launch
__global__ void __launch_bounds__(kSumCols* kSumSplit)
    vtg_layer_norm_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dgamma,
                                  float* __restrict__ dbeta, int blocks, int d) {
  __shared__ float runs[kSumSplit][kSumCols + 1];
  const int c = blockIdx.x * kSumCols + threadIdx.x;  // in [0, 2 d)
  const int h = c >= d ? 1 : 0, j = c - h * d;
  float t = 0.f;
  if (c < 2 * d) {
    const float* p = part + (int64_t)h * blocks * d + j;
#pragma unroll 4
    for (int b = threadIdx.y; b < blocks; b += kSumSplit) t += p[(int64_t)b * d];
  }
  runs[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < 2 * d) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kSumSplit; ++k) s += runs[k][threadIdx.x];
    (h ? dbeta : dgamma)[j] = s;
  }
}

// ---- dispatch ----------------------------------------------------------------

struct Fwd {
  const void* x;
  const float* gamma;
  const float* beta;
  float* y;
  float* stats;
  int rows, d;
  float eps;
};

struct Bwd {
  const void* x;
  const float* dy;
  const float* stats;
  const float* gamma;
  void* dx;
  float* part;
  int rows, d, blocks;
};

template <typename T, int VEC, int ITERS>
struct WarpPath {
  static int forward(const Fwd& a, cudaStream_t s) {
    const int grid = (a.rows + kWarps - 1) / kWarps;
    vtg_layer_norm_fwd_kernel<T, VEC, ITERS><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(a.x), a.gamma, a.beta, a.y, a.stats, a.rows, a.d, a.eps);
    return (int)cudaGetLastError();
  }
  static int backward(const Bwd& a, cudaStream_t s) {
    vtg_layer_norm_bwd_kernel<T, VEC, ITERS><<<a.blocks, kThreads, 0, s>>>(
        static_cast<const T*>(a.x), a.dy, a.stats, a.gamma, static_cast<T*>(a.dx), a.part,
        a.rows, a.d);
    return (int)cudaGetLastError();
  }
  static int resident(int* n) {  // backward blocks an SM holds at once
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, vtg_layer_norm_bwd_kernel<T, VEC, ITERS>, kThreads, 0);
  }
};

template <typename T, int VEC, typename Call>
int by_iters(int d, Call call) {
  const int need = (d + 32 * VEC - 1) / (32 * VEC);
  if (need <= 1) return call(WarpPath<T, VEC, 1>());
  if (need <= 2) return call(WarpPath<T, VEC, 2>());
  if constexpr (4 * VEC <= 32) {
    if (need <= 4) return call(WarpPath<T, VEC, 4>());
  }
  if constexpr (8 * VEC <= 32) {
    if (need <= 8) return call(WarpPath<T, VEC, 8>());
  }
  if constexpr (16 * VEC <= 32) {
    if (need <= 16) return call(WarpPath<T, VEC, 16>());
  }
  if constexpr (32 * VEC <= 32) {
    if (need <= 32) return call(WarpPath<T, VEC, 32>());
  }
  return (int)cudaErrorInvalidValue;
}

// the warp path's instance for width d <= kMaxWarpWidth: the widest VEC
// (at most 16 bytes) that divides d
template <typename T, typename Call>
int warp_path(int d, Call call) {
  if constexpr (sizeof(T) == 2) {
    if (d % 8 == 0) return by_iters<T, 8>(d, call);
  }
  if (d % 4 == 0) return by_iters<T, 4>(d, call);
  if (d % 2 == 0) return by_iters<T, 2>(d, call);
  return by_iters<T, 1>(d, call);
}

struct CallForward {
  const Fwd& a;
  cudaStream_t s;
  template <typename P>
  int operator()(P) const { return P::forward(a, s); }
};

struct CallBackward {
  const Bwd& a;
  cudaStream_t s;
  template <typename P>
  int operator()(P) const { return P::backward(a, s); }
};

struct CallResident {
  int* n;
  template <typename P>
  int operator()(P) const { return P::resident(n); }
};

template <typename T>
int forward(const Fwd& a, cudaStream_t s) {
  if (a.d <= kMaxWarpWidth) return warp_path<T>(a.d, CallForward{a, s});
  vtg_layer_norm_fwd_wide_kernel<T><<<a.rows, kThreads, 0, s>>>(
      static_cast<const T*>(a.x), a.gamma, a.beta, a.y, a.stats, a.rows, a.d, a.eps);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const Bwd& a, float* dgamma, float* dbeta, cudaStream_t s) {
  int rc;
  if (a.d <= kMaxWarpWidth) {
    rc = warp_path<T>(a.d, CallBackward{a, s});
  } else {
    const int smem = 2 * a.d * (int)sizeof(float);
    if (smem > 48 * 1024) {
      rc = (int)cudaFuncSetAttribute(vtg_layer_norm_bwd_wide_kernel<T>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != 0) return rc;
    }
    vtg_layer_norm_bwd_wide_kernel<T><<<a.blocks, kThreads, smem, s>>>(
        static_cast<const T*>(a.x), a.dy, a.stats, a.gamma, static_cast<T*>(a.dx), a.part,
        a.rows, a.d);
    rc = (int)cudaGetLastError();
  }
  if (rc != 0) return rc;
  const dim3 block(kSumCols, kSumSplit);
  vtg_layer_norm_bwd_sum_kernel<<<(2 * a.d + kSumCols - 1) / kSumCols, block, 0, s>>>(
      a.part, dgamma, dbeta, a.blocks, a.d);
  return (int)cudaGetLastError();
}

template <typename T>
int resident(int d, int* n) {
  if (d <= kMaxWarpWidth) return warp_path<T>(d, CallResident{n});
  const int smem = 2 * d * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(vtg_layer_norm_bwd_wide_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, vtg_layer_norm_bwd_wide_kernel<T>, kThreads, smem);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// x (rows, d) f32 (x_bf16 0) or bf16 (1); gamma, beta (d) f32; y (rows, d)
// f32; stats (2, rows) f32, mean then rstd, or null (not written). Every
// pointer 16-byte aligned, every tensor contiguous; rows >= 1,
// 1 <= d <= 16384.
int flashvtg_layer_norm_fwd(const void* x, const float* gamma, const float* beta, float* y,
                            float* stats, int rows, int d, int x_bf16, float eps, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxWidth || x == nullptr || gamma == nullptr ||
      beta == nullptr || y == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Fwd a = {x, gamma, beta, y, stats, rows, d, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? forward<__nv_bfloat16>(a, s) : forward<float>(a, s);
}

// The backward's grid for `rows` rows of width d: one wave of the card's
// SMs at the kernel's occupancy, no more blocks than rows need (for wide
// rows, one a kWideRows rows: each block writes 2 d floats of partials),
// and the rows spread evenly (every warp of the warp path the same run of
// rows, but the last). Returns the block count, or minus a CUDA error.
int flashvtg_layer_norm_bwd_blocks(int rows, int d, int x_bf16) {
  if (rows < 1 || d < 1 || d > kMaxWidth) return -(int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&device);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == 0) rc = x_bf16 ? resident<__nv_bfloat16>(d, &per_sm) : resident<float>(d, &per_sm);
  if (rc != 0) return -rc;
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (d > kMaxWarpWidth) {  // at least kWideRows rows a block: the partials stay small
    const int64_t want = (rows + kWideRows - 1) / kWideRows;
    return (int)(want < wave ? want : wave);
  }
  const int64_t warps = wave * kWarps;
  const int64_t per = (rows + warps - 1) / warps;  // rows a warp
  return (int)((rows + per * kWarps - 1) / (per * kWarps));
}

// x (rows, d) as in the forward; dy (rows, d) f32; stats the forward's;
// dx (rows, d) in x's dtype, or null (not written); part (2, blocks, d) f32
// scratch, blocks from flashvtg_layer_norm_bwd_blocks; dgamma, dbeta (d)
// f32, written whole. Alignment and contiguity as the forward.
int flashvtg_layer_norm_bwd(const void* x, const float* dy, const float* stats,
                            const float* gamma, void* dx, float* part, float* dgamma,
                            float* dbeta, int rows, int d, int x_bf16, int blocks,
                            void* stream) {
  if (rows < 1 || d < 1 || d > kMaxWidth || blocks < 1 || x == nullptr || dy == nullptr ||
      stats == nullptr || gamma == nullptr || part == nullptr || dgamma == nullptr ||
      dbeta == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Bwd a = {x, dy, stats, gamma, dx, part, rows, d, blocks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? backward<__nv_bfloat16>(a, dgamma, dbeta, s)
                : backward<float>(a, dgamma, dbeta, s);
}

}  // extern "C"
