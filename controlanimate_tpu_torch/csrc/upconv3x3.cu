// conv3x3 [+ nearest-2x upsample folded in] + bias [+ leaky ReLU] for Hopper
// (sm_90a), on channels-last (NHWC) tensors: the RealESRGAN x4 tail.
//
// Replaces the TPU kernel controlanimate_tpu/ops/upconv_kernel.py `_kernel`
// (called through `_run` by `conv3x3_small` and `upsample2x_conv3x3_fine`).
// It computes what that kernel computes, in two modes:
//   conv      y[i, j]          = lrelu(sum_{dy,dx} x[i+dy-1, j+dx-1] w[dy, dx] + b)
//   upsample  y[2i+p, 2j+q]    = lrelu(conv3x3(nearest_2x(x))[2i+p, 2j+q] + b)
// with fp32 accumulation, the bias added in fp32, leaky ReLU (slope 0.2) in
// fp32, and one rounding to the output dtype. SAME zero padding in both.
//
// The TPU kernel folds nearest-2x + conv3x3 into one dense (9 Ci, 4 Co)
// matrix whose output columns are the four parities; 5/9 of it are
// structural zeros, and at Ci = Co = 64 it is 295 KB in bf16, more than a
// block's 227 KB of shared memory. Here each output parity (p, q) is its own
// 2x2 convolution on the coarse input (ops/upsample.py's tap table): parity
// p reads coarse rows i-1+p and i+p (and q the columns likewise) with folded
// weights that the wrapper computes in fp32 and rounds once to the input
// dtype. One block owns an 8 x 16 coarse tile, one parity and BN (64 or 32)
// output channels; it loops over Ci in chunks of 32, stages the coarse tile
// with its one-pixel halo (zero outside the image) and the parity's 4 (or
// the conv's 9) taps x BN x 32 weights in shared memory, and keeps the fp32
// accumulators in registers. The epilogue adds the bias, applies the leaky
// ReLU and writes the fine layout (B, 2H, 2W, Co) directly: on the card the
// depth-to-space that Mosaic could not lower is only an address.
//
// bf16: the products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// fp32 accumulate); 8 warps as 4 (tile rows) x 2 (channel halves), each 32
// pixels x BN/2 channels. fp32: the same staging, the products as fp32 FMAs
// on the CUDA cores (no TF32), each thread owning 1 or 2 pixels x 16 channels.
//
// Layouts: x (B, H, W, Ci) read by its element strides (sb, sh, sw) with the
// channels contiguous, so a channels_last activation needs no copy; weights
// (P, T, Co, Ci) in the input dtype (P = 4 parities x T = 4 taps, or P = 1 x
// T = 9 taps; tap-major, Ci innermost, so a channel pair of one output
// channel is one 32-bit word, the mma B fragment); bias (Co,) fp32; out
// contiguous (B, 2H, 2W, Co) or (B, H, W, Co). Ci and Co must be multiples
// of 32; H and W are free (ragged tiles are masked).
//
// Bound on the H100: the useful work is 2*4*Ci*Co FLOPs a fine output pixel
// (upsample) or 2*9*Ci*Co (conv), against the input read once and the output
// written once. At Ci = Co = 64 in bf16 that is 64 FLOPs a byte for the
// upsample and 144 for the conv, under the card's 295: the x4 tail is
// bound by bytes (the 2048^2 x 64 output is 537 MB a frame). This first
// version has no cp.async / TMA pipelining and no wgmma, so loads and
// products do not overlap, and the fine-layout stores are 16-byte pieces.
//
// Interface: plain C functions (no PyTorch headers), built with one nvcc call
// and loaded with ctypes by controlanimate_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;            // coarse tile rows
constexpr int TW = 16;           // coarse tile cols (one mma M tile of 16 pixels)
constexpr int PH = TH + 2;       // staged patch rows (1-pixel halo)
constexpr int PW = TW + 2;       // staged patch cols
constexpr int NPIX = PH * PW;    // 180 staged pixels
constexpr int KC = 32;           // input channels per stage
constexpr int kThreads = 256;    // 8 warps

// Shared-memory row pitches (elements). bf16: 40 halves = 20 words, so the 8
// rows one mma fragment load touches fall on 8 disjoint groups of 4 banks,
// and rows stay 16-byte aligned. fp32: 33 floats (odd) for scalar loads.
constexpr int LD16 = 40;
constexpr int LD32 = 33;

template <typename T>
constexpr size_t smem_bytes(int taps, int bn) {
  return sizeof(T) * (size_t)(NPIX + taps * bn) * (sizeof(T) == 2 ? LD16 : LD32);
}

struct Args {
  const void* x;
  long long sb, sh, sw;  // element strides of x; the channel stride is 1
  const void* w;         // (P, T, Co, Ci)
  const float* bias;     // (Co,)
  void* out;             // (B, 2H, 2W, Co) upsample, (B, H, W, Co) conv
  int B, H, W, Ci, Co, upsample, lrelu, tiles_x, tiles_y, n_blocks;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// bias then leaky ReLU, each rounded in fp32 as the plain version does (the
// explicit _rn intrinsics keep nvcc from fusing them into one FMA).
__device__ __forceinline__ float epilogue(float acc, float bias, int lrelu) {
  float v = __fadd_rn(acc, bias);
  if (lrelu && v < 0.f) v = __fmul_rn(v, 0.2f);
  return v;
}

// 16 bytes into shared memory: one vector store where the pitch keeps rows
// 16-byte aligned (bf16), else element by element (fp32's odd pitch).
template <typename T, int LD>
__device__ __forceinline__ void store_row(T* dst, const uint4& raw) {
  if constexpr ((LD * sizeof(T)) % 16 == 0) {
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
    const T* src = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = src[i];
  }
}

// Stage input channels [c0, c0 + KC) of the coarse tile's (PH x PW) patch
// into `sp` (pitch LD elements a pixel), zero outside the image.
template <typename T, int LD>
__device__ __forceinline__ void stage_patch(const Args& p, T* sp, int bi, int y0, int x0, int c0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_PIX = KC / VEC;
  const T* x = static_cast<const T*>(p.x);
  for (int task = threadIdx.x; task < NPIX * PER_PIX; task += kThreads) {
    const int pix = task / PER_PIX;
    const int part = task % PER_PIX;
    const int y = y0 - 1 + pix / PW;
    const int xx = x0 - 1 + pix % PW;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // 0.0 in both dtypes
    if (y >= 0 && y < p.H && xx >= 0 && xx < p.W)
      raw = *reinterpret_cast<const uint4*>(x + bi * p.sb + y * p.sh + xx * p.sw + c0 + part * VEC);
    store_row<T, LD>(sp + pix * LD + part * VEC, raw);
  }
}

// Stage weights [par][tap][n0 + n][c0 .. c0 + KC) for the NT taps into `sw`
// (row tap * BN + n, pitch LD).
template <typename T, int LD, int NT, int BN>
__device__ __forceinline__ void stage_weights(const Args& p, T* sw, int par, int n0, int c0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = KC / VEC;
  const T* w = static_cast<const T*>(p.w);
  for (int task = threadIdx.x; task < NT * BN * PER_ROW; task += kThreads) {
    const int row = task / PER_ROW;
    const int part = task % PER_ROW;
    const int tap = row / BN;
    const int n = row % BN;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        w + (((size_t)par * NT + tap) * p.Co + n0 + n) * p.Ci + c0 + part * VEC);
    store_row<T, LD>(sw + row * LD + part * VEC, raw);
  }
}

// Where tap `tap` of parity `par` reads, relative to a tile pixel, in patch
// coordinates (the patch starts one pixel above and left of the tile). conv:
// the 3x3 window. upsample: parity p reads coarse rows i-1+p, i+p, which
// are patch rows p, p+1 (columns likewise with q).
template <int NT>
__device__ __forceinline__ void tap_offset(int tap, int par, int& oy, int& ox) {
  if constexpr (NT == 9) {
    oy = tap / 3;
    ox = tap % 3;
  } else {
    oy = (par >> 1) + (tap >> 1);
    ox = (par & 1) + (tap & 1);
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Which coarse tile, parity and channel slice this block owns.
struct Tile {
  int bi, y0, x0, par, n0;
};

__device__ __forceinline__ Tile block_tile(const Args& p, int bn) {
  const int per_image = p.tiles_x * p.tiles_y;
  const int t = blockIdx.x % per_image;
  return Tile{(int)(blockIdx.x / per_image), (t / p.tiles_x) * TH, (t % p.tiles_x) * TW,
              (int)blockIdx.y / p.n_blocks, ((int)blockIdx.y % p.n_blocks) * bn};
}

// Output element offset of coarse pixel (y, x) of the tile's parity.
__device__ __forceinline__ size_t out_pixel(const Args& p, const Tile& t, int y, int x) {
  if (p.upsample) {
    const int oy = 2 * y + (t.par >> 1), ox = 2 * x + (t.par & 1);
    return ((size_t)t.bi * 2 * p.H + oy) * (2 * (size_t)p.W) + ox;
  }
  return ((size_t)t.bi * p.H + y) * p.W + x;
}

template <int NT, int BN>
__global__ void __launch_bounds__(kThreads)
upconv_bf16_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw = sp + NPIX * LD16;
  const uint32_t* P = reinterpret_cast<const uint32_t*>(sp);
  const uint32_t* Wt = reinterpret_cast<const uint32_t*>(sw);
  constexpr int LDW = LD16 / 2;  // pitch in 32-bit words
  constexpr int WN = BN / 2;     // channels a warp owns
  constexpr int N8 = WN / 8;     // its n8 tiles

  const Tile tile = block_tile(p, BN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3;   // tile rows 2*wm, 2*wm + 1
  const int wn = warp >> 2;  // channels wn*WN .. wn*WN + WN - 1 of the block
  const int g = lane >> 2, tg = lane & 3;

  float acc[2][N8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  for (int c0 = 0; c0 < p.Ci; c0 += KC) {
    __syncthreads();
    stage_patch<__nv_bfloat16, LD16>(p, sp, tile.bi, tile.y0, tile.x0, c0);
    stage_weights<__nv_bfloat16, LD16, NT, BN>(p, sw, tile.par, tile.n0, c0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < NT; ++tap) {
      int oy, ox;
      tap_offset<NT>(tap, tile.par, oy, ox);
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = 2 * wm + mt + oy;
          const int p0 = (r * PW + g + ox) * LDW + ks * 8 + tg;
          const int p1 = (r * PW + g + 8 + ox) * LDW + ks * 8 + tg;
          af[mt][0] = P[p0];
          af[mt][1] = P[p1];
          af[mt][2] = P[p0 + 4];
          af[mt][3] = P[p1 + 4];
        }
#pragma unroll
        for (int nt = 0; nt < N8; ++nt) {
          const int wrow = (tap * BN + wn * WN + nt * 8 + g) * LDW + ks * 8 + tg;
          const uint32_t b0 = Wt[wrow], b1 = Wt[wrow + 4];
          mma_bf16(acc[0][nt], af[0], b0, b1);
          mma_bf16(acc[1][nt], af[1], b0, b1);
        }
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int y = tile.y0 + 2 * wm + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = tile.x0 + g + 8 * half;
      if (y >= p.H || x >= p.W) continue;
      const size_t pix = out_pixel(p, tile, y, x);
#pragma unroll
      for (int nt = 0; nt < N8; ++nt) {
        const int co = tile.n0 + wn * WN + nt * 8 + 2 * tg;
        const float v0 = epilogue(acc[mt][nt][2 * half], p.bias[co], p.lrelu);
        const float v1 = epilogue(acc[mt][nt][2 * half + 1], p.bias[co + 1], p.lrelu);
        *reinterpret_cast<__nv_bfloat162*>(out + pix * p.Co + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int NT, int BN>
__global__ void __launch_bounds__(kThreads)
upconv_f32_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float* sw = sp + NPIX * LD32;
  constexpr int NG = BN / 16;     // channel groups of 16, one per warp
  constexpr int MW = 8 / NG;      // warps along the tile rows
  constexpr int ROWS = TH / MW;   // tile rows a warp owns
  constexpr int PP = ROWS / 2;    // pixels a thread owns

  const Tile tile = block_tile(p, BN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % NG, wm = warp / NG;
  // pixel i of this thread: tile row wm*ROWS + 2*i + lane/16, col lane%16
  const int r0 = lane / 16, col = lane % 16;

  float acc[PP][16];
#pragma unroll
  for (int i = 0; i < PP; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < p.Ci; c0 += KC) {
    __syncthreads();
    stage_patch<float, LD32>(p, sp, tile.bi, tile.y0, tile.x0, c0);
    stage_weights<float, LD32, NT, BN>(p, sw, tile.par, tile.n0, c0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < NT; ++tap) {
      int oy, ox;
      tap_offset<NT>(tap, tile.par, oy, ox);
      const float* wt = sw + (tap * BN + wn * 16) * LD32;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float av[PP], bv[16];
#pragma unroll
        for (int i = 0; i < PP; ++i)
          av[i] = sp[((wm * ROWS + 2 * i + r0 + oy) * PW + col + ox) * LD32 + k];
#pragma unroll
        for (int j = 0; j < 16; ++j) bv[j] = wt[j * LD32 + k];
#pragma unroll
        for (int i = 0; i < PP; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    const int y = tile.y0 + wm * ROWS + 2 * i + r0;
    const int x = tile.x0 + col;
    if (y >= p.H || x >= p.W) continue;
    const size_t base = out_pixel(p, tile, y, x) * p.Co + tile.n0 + wn * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      out[base + j] = epilogue(acc[i][j], p.bias[tile.n0 + wn * 16 + j], p.lrelu);
  }
}

template <typename K>
cudaError_t launch(K kern, size_t smem, const Args& p, int parities, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, parities * p.n_blocks);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NT, int BN>
cudaError_t dispatch(const Args& p, cudaStream_t stream) {
  const int parities = NT == 4 ? 4 : 1;
  if constexpr (sizeof(T) == 2)
    return launch(upconv_bf16_kernel<NT, BN>, smem_bytes<T>(NT, BN), p, parities, stream);
  else
    return launch(upconv_f32_kernel<NT, BN>, smem_bytes<T>(NT, BN), p, parities, stream);
}

template <typename T>
cudaError_t dispatch_shape(Args p, cudaStream_t stream) {
  const bool wide = p.Co % 64 == 0;  // BN = 64, else 32
  p.n_blocks = p.Co / (wide ? 64 : 32);
  if (p.upsample)
    return wide ? dispatch<T, 4, 64>(p, stream) : dispatch<T, 4, 32>(p, stream);
  return wide ? dispatch<T, 9, 64>(p, stream) : dispatch<T, 9, 32>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); bias is fp32.
// x is read at x + b*sb + y*sh + x*sw + c (element strides; the channels
// contiguous and each pixel's channels 16-byte aligned). w is (4, 4, Co, Ci)
// when upsample is 1 (the folded parity weights), (1, 9, Co, Ci) when it is
// 0. lrelu is 0 or 1. Returns the cudaError_t of the launch
// (cudaGetLastError), 0 on success.
int upconv3x3_fwd(const void* x, long long sb, long long sh, long long sw, const void* w,
                  const float* bias, void* out, int B, int H, int W, int Ci, int Co,
                  int upsample, int lrelu, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || Ci % KC != 0 || Co % 32 != 0 ||
      (upsample != 0 && upsample != 1) || sb < 0 || sh < 0 || sw < 0)
    return (int)cudaErrorInvalidValue;
  const Args p{x, sb, sh, sw, w, bias, out, B, H, W, Ci, Co, upsample, lrelu,
               (W + TW - 1) / TW, (H + TH - 1) / TH, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_shape<float>(p, s);
  if (dtype == 1) return (int)dispatch_shape<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* upconv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
