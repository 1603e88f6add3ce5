// Fused GroupNorm affine -> SiLU -> 3x3 conv [+ bias + residual] for Hopper
// (sm_90a), on channels-last (NHWC) tensors.
//
// Replaces the TPU kernel controlanimate_tpu/ops/conv_kernel.py `_conv_kernel`
// (called through `conv3x3_fused`). It computes what that kernel computes:
//   z = x * a[b, c] + b[b, c]            in the input dtype (two roundings)
//   z = silu(z) in fp32, rounded back to the input dtype
//   zero padding applied AFTER the activation (a border tap reads 0)
//   y = conv3x3(z, w) with fp32 accumulation, + bias (fp32) [+ residual (fp32)]
//   one rounding to the output dtype.
// The TPU kernel keeps whole image rows in VMEM and does the 9*Cin reduction as
// one im2col dot. Here the conv is an implicit GEMM (M = pixels, N = Cout,
// K = 9*Cin): one block owns an 8 x 16 pixel tile and 128 output channels,
// loops over Cin in chunks of 16, stages the (tile + 1-pixel halo) input patch
// through shared memory with the affine, SiLU, rounding and border zeroing
// applied while staging (each input element is activated once per block),
// stages the 9 x 16 x 128 weight slab beside it, and keeps the fp32
// accumulators in registers; bias and residual are added in the epilogue.
//
// bf16: the products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// fp32 accumulate); 8 warps each own 32 pixels x 64 channels. fp32: the same
// staging, the products as fp32 FMAs on the CUDA cores (no TF32), each thread
// owning 4 pixels x 16 channels.
//
// Layouts: x and residual (B, H, W, Cin / Cout) contiguous; out (B, H, W, Cout);
// weights re-laid by the wrapper to (9, Cout, Cin) contiguous in the input
// dtype (tap-major, Cin innermost, so a channel pair of one output channel is
// one 32-bit word, the mma B fragment); a, b (B, Cin) in the input dtype; bias
// (Cout,) fp32. Cin must be a multiple of 16 and Cout of 128; H and W are
// free (ragged tiles are masked).
//
// Bound on the H100: 2*9*B*H*W*Cin*Cout FLOPs against 989 TFLOP/s (bf16
// tensor cores) is above the bytes it must move at every VAE shape, so the
// kernel is compute-bound; this first version has no cp.async / TMA
// pipelining and no wgmma, so the loads and the products do not overlap.
//
// Interface: plain C functions (no PyTorch headers), built with one nvcc call
// and loaded with ctypes by controlanimate_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;            // tile rows
constexpr int TW = 16;           // tile cols (one mma M tile of 16 pixels)
constexpr int PH = TH + 2;       // staged patch rows (1-pixel halo)
constexpr int PW = TW + 2;       // staged patch cols
constexpr int NPIX = PH * PW;    // 180 staged pixels
constexpr int BN = 128;          // output channels per block
constexpr int KC = 16;           // input channels per stage
constexpr int kThreads = 256;    // 8 warps

// Shared-memory row pitches (elements). bf16: 24 halves = 12 words, so the 8
// rows one mma fragment load touches fall on 8 disjoint groups of 4 banks.
// fp32: 17 floats (odd) for the same reason on scalar loads.
constexpr int LD16 = 24;
constexpr int LD32 = 17;

constexpr size_t kSmemBf16 = sizeof(__nv_bfloat16) * (size_t)(NPIX + 9 * BN) * LD16;
constexpr size_t kSmemF32 = sizeof(float) * (size_t)(NPIX + 9 * BN) * LD32;

struct Args {
  const void* x;
  const void* w;       // (9, Cout, Cin)
  const float* bias;   // (Cout,)
  const void* a;       // (B, Cin) or null
  const void* b;       // (B, Cin) or null
  const void* res;     // (B, H, W, Cout) or null
  void* out;           // (B, H, W, Cout)
  int B, H, W, Cin, Cout, silu, tiles_x, tiles_y;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One input element through affine -> SiLU, rounding to T after each step as
// the plain version does (the explicit _rn intrinsics keep nvcc from fusing
// the multiply and add into one FMA with a single rounding).
template <typename T>
__device__ __forceinline__ T activate(T v, const T* a, const T* b, int c, bool silu) {
  if (a != nullptr) {
    v = from_f<T>(__fmul_rn(to_f(v), to_f(a[c])));
    v = from_f<T>(__fadd_rn(to_f(v), to_f(b[c])));
  }
  if (silu) {
    const float z = to_f(v);
    v = from_f<T>(z * (1.f / (1.f + expf(-z))));
  }
  return v;
}

// 16 bytes into shared memory: one vector store where the pitch keeps rows
// 16-byte aligned (bf16), else element by element (fp32's odd pitch).
template <typename T, int LD>
__device__ __forceinline__ void store_row(T* dst, const T* src) {
  if constexpr ((LD * sizeof(T)) % 16 == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = src[i];
  }
}

// Stage input channels [c0, c0 + 16) of the tile's (PH x PW) patch into `sp`
// (pitch LD elements per pixel), activated, zero outside the image.
template <typename T, int LD>
__device__ __forceinline__ void stage_patch(const Args& p, T* sp, int bi, int y0, int x0, int c0) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_PIX = KC / VEC;
  const T* x = static_cast<const T*>(p.x);
  const T* a = p.a ? static_cast<const T*>(p.a) + (size_t)bi * p.Cin : nullptr;
  const T* b = p.b ? static_cast<const T*>(p.b) + (size_t)bi * p.Cin : nullptr;
  for (int task = threadIdx.x; task < NPIX * PER_PIX; task += kThreads) {
    const int pix = task / PER_PIX;
    const int part = task % PER_PIX;
    const int y = y0 - 1 + pix / PW;
    const int xx = x0 - 1 + pix % PW;
    alignas(16) T vals[VEC];
    if (y >= 0 && y < p.H && xx >= 0 && xx < p.W) {
      const int c = c0 + part * VEC;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          x + (((size_t)bi * p.H + y) * p.W + xx) * p.Cin + c);
      const T* rv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = activate<T>(rv[i], a, b, c + i, p.silu != 0);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = from_f<T>(0.f);
    }
    store_row<T, LD>(sp + pix * LD + part * VEC, vals);
  }
}

// Stage weights [tap][n0 + n][c0 .. c0 + 16) for all 9 taps into `sw`
// (row (tap * BN + n), pitch LD).
template <typename T, int LD>
__device__ __forceinline__ void stage_weights(const Args& p, T* sw, int n0, int c0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = KC / VEC;
  const T* w = static_cast<const T*>(p.w);
  for (int task = threadIdx.x; task < 9 * BN * PER_ROW; task += kThreads) {
    const int row = task / PER_ROW;
    const int part = task % PER_ROW;
    const int tap = row / BN;
    const int n = row % BN;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        w + ((size_t)tap * p.Cout + n0 + n) * p.Cin + c0 + part * VEC);
    store_row<T, LD>(sw + row * LD + part * VEC, reinterpret_cast<const T*>(&raw));
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Which tile / channel slice this block owns.
struct Tile {
  int bi, y0, x0, n0;
};

__device__ __forceinline__ Tile block_tile(const Args& p) {
  const int per_image = p.tiles_x * p.tiles_y;
  const int t = blockIdx.x % per_image;
  return Tile{(int)(blockIdx.x / per_image), (t / p.tiles_x) * TH, (t % p.tiles_x) * TW,
              (int)blockIdx.y * BN};
}

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw = sp + NPIX * LD16;
  const uint32_t* P = reinterpret_cast<const uint32_t*>(sp);
  const uint32_t* Wt = reinterpret_cast<const uint32_t*>(sw);
  constexpr int LDW = LD16 / 2;  // pitch in 32-bit words

  const Tile tile = block_tile(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3;   // pixel rows 2*wm, 2*wm + 1 of the tile
  const int wn = warp >> 2;  // channels wn*64 .. wn*64 + 63 of the block
  const int g = lane >> 2, tg = lane & 3;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  for (int c0 = 0; c0 < p.Cin; c0 += KC) {
    __syncthreads();
    stage_patch<__nv_bfloat16, LD16>(p, sp, tile.bi, tile.y0, tile.x0, c0);
    stage_weights<__nv_bfloat16, LD16>(p, sw, tile.n0, c0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 2 * wm + mt + dy;
        const int p0 = (r * PW + g + dx) * LDW + tg;
        const int p1 = (r * PW + g + 8 + dx) * LDW + tg;
        af[mt][0] = P[p0];
        af[mt][1] = P[p1];
        af[mt][2] = P[p0 + 4];
        af[mt][3] = P[p1 + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int wrow = (tap * BN + wn * 64 + nt * 8 + g) * LDW + tg;
        const uint32_t b0 = Wt[wrow], b1 = Wt[wrow + 4];
        mma_bf16(acc[0][nt], af[0], b0, b1);
        mma_bf16(acc[1][nt], af[1], b0, b1);
      }
    }
  }

  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.res);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int y = tile.y0 + 2 * wm + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = tile.x0 + g + 8 * half;
      if (y >= p.H || x >= p.W) continue;
      const size_t pix = ((size_t)tile.bi * p.H + y) * p.W + x;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = tile.n0 + wn * 64 + nt * 8 + 2 * tg;
        float v0 = acc[mt][nt][2 * half] + p.bias[co];
        float v1 = acc[mt][nt][2 * half + 1] + p.bias[co + 1];
        if (res != nullptr) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + pix * p.Cout + co);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + pix * p.Cout + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float* sw = sp + NPIX * LD32;

  const Tile tile = block_tile(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // pixel i of this thread: tile row 2*i + lane/16, col lane%16; channels warp*16 + j
  const int row0 = lane / 16, col = lane % 16;

  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < p.Cin; c0 += KC) {
    __syncthreads();
    stage_patch<float, LD32>(p, sp, tile.bi, tile.y0, tile.x0, c0);
    stage_weights<float, LD32>(p, sw, tile.n0, c0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* wt = sw + (tap * BN + warp * 16) * LD32;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float av[4], bv[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sp[((2 * i + row0 + dy) * PW + col + dx) * LD32 + k];
#pragma unroll
        for (int j = 0; j < 16; ++j) bv[j] = wt[j * LD32 + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  const float* res = static_cast<const float*>(p.res);
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = tile.y0 + 2 * i + row0;
    const int x = tile.x0 + col;
    if (y >= p.H || x >= p.W) continue;
    const size_t base = (((size_t)tile.bi * p.H + y) * p.W + x) * p.Cout + tile.n0 + warp * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[i][j] + p.bias[tile.n0 + warp * 16 + j];
      if (res != nullptr) v += res[base + j];
      out[base + j] = v;
    }
  }
}

template <typename K>
cudaError_t launch(K kern, size_t smem, const Args& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, p.Cout / BN);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b, residual and out share it);
// bias is fp32. a and b are both null (no affine) or both set; residual may
// be null; silu is 0 or 1. Returns the cudaError_t of the launch
// (cudaGetLastError), 0 on success.
int conv3x3_fused_fwd(const void* x, const void* w, const float* bias, const void* a,
                      const void* b, const void* residual, void* out, int B, int H, int W,
                      int Cin, int Cout, int silu, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % KC != 0 || Cout % BN != 0 ||
      Cout / BN > 65535 || (a == nullptr) != (b == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args p{x, w, bias, a, b, residual, out, B, H, W, Cin, Cout, silu,
               (W + TW - 1) / TW, (H + TH - 1) / TH};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(conv3x3_f32_kernel, kSmemF32, p, s);
  if (dtype == 1) return (int)launch(conv3x3_bf16_kernel, kSmemBf16, p, s);
  return (int)cudaErrorInvalidValue;
}

const char* conv3x3_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
