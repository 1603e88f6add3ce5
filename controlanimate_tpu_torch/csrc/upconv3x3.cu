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
// structural zeros. Here each output parity (p, q) is its own 2x2
// convolution on the coarse input (ops/upsample.py's tap table): parity p
// reads coarse rows i-1+p and i+p (and q the columns likewise) with folded
// weights that the wrapper computes in fp32 and rounds once to the input
// dtype, once per parameter version (the upscaler caches them).
//
// What bounds it on the H100: the useful work is 2*4*Ci*Co FLOPs a fine
// output pixel (upsample) or 2*9*Ci*Co (conv), against the input read once
// and the output written once. At the tail's Ci = Co = 64 in bf16 that is 64
// FLOPs a byte for the upsample and 144 for the conv, under the card's 295:
// up1 and up2 are bound by bytes (the 2048^2 x 64 output of up2 is 537 MB a
// frame), conv_hr nearly balanced (2.50 ms of operations against 2.56 of
// bytes at 8 frames). On mma.sync, which reaches well under the tensor
// cores' peak, the products set the pace at conv_hr and share it at up2.
// Measured on the card (PERF.md §6, `k4_split.py`, which builds variants of
// this source without the products or the stores): the staging, the
// products and the stores add up instead of overlapping, since a block's 8
// warps run the epilogue together and the per-thread copies share the
// load/store pipe with ldmatrix. Stores deferred into the next tile's
// products, spread over them, or a third ring slot did not help.
// Overlapping them needs bulk asynchronous copies (TMA) beside wgmma: a
// later step.
//
// bf16 design (`upconv_bf16_kernel`), for loads that overlap the products
// and stores at full width:
//   - Persistent blocks: one block an SM slot, 8 warps, walks over tiles
//     gridDim.x apart. A tile is 16 x 16 output pixels (conv) or 8 x 16
//     coarse pixels (upsample), for BN (64 or 32) output channels;
//     output-channel blocks are grid.y.
//   - The folded weights stay resident in shared memory while the block
//     walks (at 64 -> 64: the four parities' 4 taps, 131 KB, or the conv's
//     9 taps, 73.7 KB), staged once a block by cp.async. When every input
//     chunk's weights do not fit (at BN = 64: Ci > 64 upsample, Ci > 128
//     conv), each step stages its chunk's weights with its patch instead.
//     Persistent blocks beat blocks of 8 consecutive tiles, which restage
//     the weights 8 tiles apart, by 3-6% (PERF.md §6).
//   - A step is one tile's patch (with its 1-pixel halo, zero outside the
//     image) for KC = 32 input channels. Steps go through a two-slot
//     cp.async ring: step s + 1 is issued before step s's products, one
//     __syncthreads a step.
//   - Upsample: the block computes all four parities from one staged patch.
//     Warp (wm, wn) owns parity column q = wm >> 1, coarse rows
//     4 (wm & 1) .. + 3 and both parity rows p (2 x 4 m16 x BN/16 n8
//     accumulators). Conv: warp wm owns tile rows 4 wm .. + 3.
//   - Products: mma.sync m16n8k16 (bf16 in, fp32 accumulate). Fragments by
//     ldmatrix.x4 from unpadded 64-byte rows with their four 16-byte units
//     XOR-swizzled (`swz`), so the 8 rows of every 8x8 matrix hit 8
//     different bank groups. A tap's shift is only the patch row and column
//     each lane hands to ldmatrix: for one column offset, a warp loads its
//     six patch rows once and every tap of that column reuses them (conv: 3
//     taps; upsample: the 4 (p, a) taps of both parity rows).
//   - Epilogue: + bias, leaky ReLU, one rounding, into a 256-pixel output
//     stage in shared memory (swizzled by pixel), then 16-byte stores, a
//     pixel's BN channels by BN / 8 neighbouring threads. In the upsample
//     mode each of the two rounds (p = 0, 1) writes 8 whole fine rows of
//     2 x 16 pixels (both parities q), contiguous in the fine layout: on the
//     card the depth-to-space that Mosaic could not lower is only an address.
// fp32 (`upconv_f32_kernel`, the 1e-4 reference runs): 8 x 16 coarse tiles
// for one parity and BN channels, 32-channel steps staged through shared
// memory, the products as fp32 FMAs on the CUDA cores (no TF32), each thread
// owning 1 or 2 pixels x 16 channels; no pipelining.
//
// Layouts: x (B, H, W, Ci) read by its element strides (sb, sh, sw) with the
// channels contiguous, so a channels_last activation needs no copy; weights
// (P, T, Co, Ci) in the input dtype (P = 4 parities 2p + q x T = 4 taps
// 2a + b, or P = 1 x T = 9 taps 3 dy + dx; Ci innermost, so a weight row of
// one output channel is the mma B fragment's k run); bias (Co,) fp32; out
// contiguous (B, 2H, 2W, Co) or (B, H, W, Co). Ci and Co must be multiples
// of 32; H and W are free (ragged tiles are masked). bf16 needs 16-byte-
// aligned x, pixel strides, weights and out.
//
// Interface: plain C functions (no PyTorch headers), built with one nvcc call
// and loaded with ctypes by controlanimate_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Args {
  const void* x;
  long long sb, sh, sw;  // element strides of x; the channel stride is 1
  const void* w;         // (P, T, Co, Ci)
  const float* bias;     // (Co,)
  void* out;             // (B, 2H, 2W, Co) upsample, (B, H, W, Co) conv
  int B, H, W, Ci, Co, upsample, lrelu;
  int tiles_x, tiles_y, n_blocks;  // coarse tiles of the kernel's tile shape; channel blocks
  int resident;  // bf16: every chunk's weights staged once a block
};

// bias then leaky ReLU, each rounded in fp32 as the plain version does (the
// explicit _rn intrinsics keep nvcc from fusing them into one FMA).
__device__ __forceinline__ float epilogue(float acc, float bias, int lrelu) {
  float v = __fadd_rn(acc, bias);
  if (lrelu && v < 0.f) v = __fmul_rn(v, 0.2f);
  return v;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ============================================================ bf16 path

constexpr int TW = 16;              // tile columns: one m16 tile of pixels
constexpr int KC = 32;              // input channels a step
constexpr int kRowBytes = KC * 2;   // a staged row: one pixel's or weight row's chunk
constexpr int kThreads = 256;       // 8 warps: 4 (pixel rows) x 2 (channel halves)
constexpr int kSlots = 2;           // the patch ring
constexpr int kOutPix = 256;        // pixels an epilogue round stores
constexpr int kSmemLimit = 232448;  // shared memory a block may use

// The tile geometry of one mode and channel block width.
template <bool kUp, int BN>
struct Plan {
  static constexpr int TH = kUp ? 8 : 16;  // coarse tile rows
  static constexpr int PW = TW + 2;        // staged patch columns (1-pixel halo)
  static constexpr int NPIX = (TH + 2) * PW;
  static constexpr int NTAP = kUp ? 16 : 9;     // weight rows an output channel
  static constexpr int NCOL = kUp ? 2 : 3;      // column offsets a warp reads
  static constexpr int NROW = kUp ? 4 : 3;      // taps a column offset
  static constexpr int NP = kUp ? 2 : 1;        // parity rows a warp accumulates
  static constexpr int NT8 = BN / 16;           // n8 tiles a warp
  static constexpr int kPBytes = NPIX * kRowBytes;       // a step's patch
  static constexpr int kWChunk = NTAP * BN * kRowBytes;  // a chunk's weights
  static constexpr int kOBytes = kOutPix * BN * 2;       // the output stage
  static_assert(TH * TW * (kUp ? 2 : 1) == kOutPix, "an epilogue round is 256 pixels");
  static_assert(BN == 32 || BN == 64, "BN / 8 units a pixel, 16-byte swizzle");

  // (resident, shared bytes) for Ci input channels
  static void smem(int Ci, int& resident, size_t& bytes) {
    const size_t res = (size_t)(Ci / KC) * kWChunk + (size_t)kSlots * kPBytes + kOBytes;
    resident = res <= (size_t)kSmemLimit;
    bytes = resident ? res : (size_t)kSlots * (kPBytes + kWChunk) + kOBytes;
  }
};

// Byte offset of 16-byte unit u of staged row `row` (64 bytes); the unit is
// XORed with bits 1-2 of `key`: the row itself for weights, the pixel's
// column in the patch for the patch (the patch is 18 columns wide, so a row
// and its key agree in bit 0). 8 consecutive keys then cover the 8 bank
// groups of 16 bytes once (bit 0 picks the half of the 128-byte line, bits
// 1-2 the unit).
__host__ __device__ constexpr int swz(int row, int key, int u) {
  return row * kRowBytes + ((u ^ ((key >> 1) & 3)) << 4);
}

// Byte offset of unit u of output-stage pixel `sp` (BN * 2 bytes a pixel):
// 128-byte rows XOR the unit with sp & 7, 64-byte rows as `swz`. The
// fragment writes of 8 consecutive pixels then hit 8 bank groups.
template <int BN>
__host__ __device__ constexpr int ost(int sp, int u) {
  if constexpr (BN == 64) return sp * 128 + ((u ^ (sp & 7)) << 4);
  return swz(sp, sp, u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `valid` false writes 16 zero bytes
// and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The tiles a block walks: tile t0 + i * stride for i < the count returned.
__device__ __forceinline__ int block_tiles(int ntiles, int& t0, int& stride) {
  t0 = blockIdx.x;
  stride = gridDim.x;
  return (ntiles - t0 + stride - 1) / stride;
}

// Image and coarse origin of tile t (tiles_x fastest, then rows, then images).
struct Tile {
  int bi, y0, x0;
};

template <int TH>
__device__ __forceinline__ Tile tile_at(const Args& p, int t) {
  const int per_image = p.tiles_x * p.tiles_y;
  const int bi = t / per_image, r = t - bi * per_image;
  return Tile{bi, (r / p.tiles_x) * TH, (r % p.tiles_x) * TW};
}

// Issue input channels [c0, c0 + KC) of tile t's patch into `dst`: unit u
// of patch pixel pix at swz(pix, its column, u), zero outside the image.
// Every thread keeps the same unit u = threadIdx.x & 3. The loops stay
// rolled (here and in load_weights), so that the next step's addresses hold
// no registers across the products.
template <class PL>
__device__ __forceinline__ void load_patch(const Args& p, uint32_t dst, int t, int c0) {
  const Tile tl = tile_at<PL::TH>(p, t);
  const int u = threadIdx.x & 3;
  const bf16* x = static_cast<const bf16*>(p.x) + tl.bi * p.sb + c0 + u * 8;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < PL::NPIX * 4; idx += kThreads) {
    const int pix = idx >> 2;
    const int py = pix / PL::PW, px = pix - py * PL::PW;
    const int y = tl.y0 - 1 + py, xx = tl.x0 - 1 + px;
    const bool inside = y >= 0 && y < p.H && xx >= 0 && xx < p.W;
    cp_async16(dst + swz(pix, px, u), inside ? x + y * p.sh + xx * p.sw : x, inside);
  }
}

// Issue input channels [c0, c0 + KC) of the block's weights into `dst`:
// row tap * BN + n (output channel n0 + n), unit u at swz(row, row, u).
template <class PL, int BN>
__device__ __forceinline__ void load_weights(const Args& p, uint32_t dst, int n0, int c0) {
  const int u = threadIdx.x & 3;
  const bf16* w = static_cast<const bf16*>(p.w) + (size_t)n0 * p.Ci + c0 + u * 8;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < PL::NTAP * BN * 4; idx += kThreads) {
    const int row = idx >> 2, tap = row / BN, n = row - tap * BN;
    cp_async16(dst + swz(row, row, u), w + ((size_t)tap * p.Co + n) * p.Ci, true);
  }
}

// B fragments of one tap for the warp's BN/2 channels, k16 step s:
// ldmatrix.x4 j gives n8 tiles 2j (matrices 0, 1: k 0-7, 8-15) and 2j + 1.
template <int NT8>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT8][2], uint32_t wts, int tap, int bn,
                                       uint32_t off) {
#pragma unroll
  for (int j = 0; j < NT8 / 2; ++j) {
    uint32_t r[4];
    ldmatrix_x4(r, wts + (tap * bn + 16 * j) * kRowBytes + off);
    b[2 * j][0] = r[0];
    b[2 * j][1] = r[1];
    b[2 * j + 1][0] = r[2];
    b[2 * j + 1][1] = r[3];
  }
}

// The products of one step (KC channels: two k16 steps). For each column
// offset the warp loads its six patch rows (rows rbase .. rbase + 5 of the
// patch; offA already holds rbase and the column), then runs every tap of
// that column on them: conv tap (dy, j) reads rows mt + dy; upsample tap
// (p, q, a, b = j) reads rows mt + p + a into parity row p's accumulators.
// The next tap's B fragments load before this tap's products.
template <bool kUp, int BN>
__device__ __forceinline__ void mma_step(float (&acc)[Plan<kUp, BN>::NP][4][BN / 16][4],
                                         uint32_t patch, uint32_t wts,
                                         const uint32_t (&offA)[Plan<kUp, BN>::NCOL][2],
                                         const uint32_t (&offB)[2], int q) {
  using PL = Plan<kUp, BN>;
  constexpr int NT8 = PL::NT8;
#pragma unroll
  for (int s = 0; s < KC / 16; ++s) {
#pragma unroll
    for (int j = 0; j < PL::NCOL; ++j) {
      uint32_t a[6][4];
#pragma unroll
      for (int i = 0; i < 6; ++i) ldmatrix_x4(a[i], patch + i * PL::PW * kRowBytes + offA[j][s]);
      uint32_t b[2][NT8][2];
      auto tap_of = [&](int t) {
        return kUp ? (2 * (t >> 1) + q) * 4 + 2 * (t & 1) + j : 3 * t + j;
      };
      load_b<NT8>(b[0], wts, tap_of(0), BN, offB[s]);
#pragma unroll
      for (int t = 0; t < PL::NROW; ++t) {
        if (t + 1 < PL::NROW) load_b<NT8>(b[(t + 1) & 1], wts, tap_of(t + 1), BN, offB[s]);
        const int pr = kUp ? t >> 1 : 0;
        const int dy = kUp ? (t >> 1) + (t & 1) : t;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT8; ++nt)
            mma_bf16(acc[pr][mt][nt], a[mt + dy], b[t & 1][nt][0], b[t & 1][nt][1]);
      }
    }
  }
}

template <bool kUp, int BN>
__global__ void __launch_bounds__(kThreads, 1)
upconv_bf16_kernel(const Args p) {
  using PL = Plan<kUp, BN>;
  constexpr int NT8 = PL::NT8, NP = PL::NP;
  constexpr int UPR = BN / 8;  // 16-byte units an output pixel
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int nck = p.Ci / KC;
  // [resident weights, every chunk] [ring: kSlots x (patch [, chunk weights])] [output stage]
  const uint32_t ring = base + (p.resident ? nck * PL::kWChunk : 0);
  const int slot_bytes = PL::kPBytes + (p.resident ? 0 : PL::kWChunk);
  const uint32_t ostage = ring + kSlots * slot_bytes;

  const int ntiles = p.B * p.tiles_x * p.tiles_y;
  int t0, tstride;
  const int nsteps = block_tiles(ntiles, t0, tstride) * nck;
  const int n0 = blockIdx.y * BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int q = kUp ? wm >> 1 : 0;              // upsample: the warp's parity column
  const int rbase = kUp ? 4 * (wm & 1) : 4 * wm;  // its first coarse (tile) row
  const int g = lane >> 2, tg = lane & 3;

  // ldmatrix lane offsets. A: patch row rbase, column (lane & 15) + the
  // column offset (q + j upsample, j conv), unit 2s + (lane >> 4); a patch
  // row i adds i * PW rows, which keeps the key. B: channel row
  // wn * BN/2 + (lane & 7) + 8 (lane >> 4) of tap 0, unit 2s + ((lane >> 3) & 1).
  uint32_t offA[PL::NCOL][2], offB[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int bn = wn * (BN / 2) + (lane & 7) + ((lane >> 4) << 3);
    offB[s] = swz(bn, bn, 2 * s + ((lane >> 3) & 1));
#pragma unroll
    for (int j = 0; j < PL::NCOL; ++j) {
      const int col = (lane & 15) + (kUp ? q : 0) + j;
      offA[j][s] = swz(rbase * PL::PW + col, col, 2 * s + (lane >> 4));
    }
  }
  float bias_r[NT8][2];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    const int c = n0 + wn * (BN / 2) + nt * 8 + 2 * tg;
    bias_r[nt][0] = p.bias[c];
    bias_r[nt][1] = p.bias[c + 1];
  }

  auto issue = [&](int s) {
    const int t = t0 + (s / nck) * tstride, c = s % nck;
    const uint32_t slot = ring + (s % kSlots) * slot_bytes;
    load_patch<PL>(p, slot, t, c * KC);
    if (!p.resident) load_weights<PL, BN>(p, slot + PL::kPBytes, n0, c * KC);
  };
  if (p.resident)
    for (int c = 0; c < nck; ++c) load_weights<PL, BN>(p, base + c * PL::kWChunk, n0, c * KC);
  issue(0);
  cp_async_commit();

  float acc[NP][4][NT8][4];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < NT8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][k][e] = 0.f;

  bf16* out = static_cast<bf16*>(p.out);
  unsigned char* ost_ptr = smem + (ostage - base);
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s has landed, and every warp is done with step s - 1's slot
    if (s + 1 < nsteps) issue(s + 1);
    cp_async_commit();
    const int c = s % nck;
    const uint32_t slot = ring + (s % kSlots) * slot_bytes;
    mma_step<kUp, BN>(acc, slot, p.resident ? base + c * PL::kWChunk : slot + PL::kPBytes, offA,
                      offB, q);
    if (c != nck - 1) continue;

    // The tile's epilogue, one round a parity row p (one round in conv):
    // + bias, leaky ReLU and one rounding into the output stage, then
    // 16-byte stores of whole pixels. Stage pixel sp: q * 128 + row * 16 +
    // column (upsample), row * 16 + column (conv).
    const Tile tl = tile_at<PL::TH>(p, t0 + (s / nck) * tstride);
#pragma unroll
    for (int pr = 0; pr < NP; ++pr) {
      if (pr > 0) __syncthreads();  // the last round's stores have read the stage
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sp = (kUp ? q * (PL::TH * TW) : 0) + (rbase + mt) * TW + g + 8 * h;
#pragma unroll
          for (int nt = 0; nt < NT8; ++nt) {
            const int cc = wn * (BN / 2) + nt * 8 + 2 * tg;
            const float v0 = epilogue(acc[pr][mt][nt][2 * h], bias_r[nt][0], p.lrelu);
            const float v1 = epilogue(acc[pr][mt][nt][2 * h + 1], bias_r[nt][1], p.lrelu);
            *reinterpret_cast<__nv_bfloat162*>(ost_ptr + ost<BN>(sp, cc >> 3) + (cc & 7) * 2) =
                __floats2bfloat162_rn(v0, v1);
            acc[pr][mt][nt][2 * h] = 0.f;
            acc[pr][mt][nt][2 * h + 1] = 0.f;
          }
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int idx = threadIdx.x; idx < kOutPix * UPR; idx += kThreads) {
        const int pix = idx / UPR, u = idx % UPR;
        int sp, y, x;
        size_t dst;
        if constexpr (kUp) {
          // fine row 2 (y0 + r) + pr, fine column 2 x0 + fc: 32 a row
          const int r = pix >> 5, fc = pix & 31;
          sp = (fc & 1) * (PL::TH * TW) + r * TW + (fc >> 1);
          y = tl.y0 + r;
          x = tl.x0 + (fc >> 1);
          dst = ((size_t)tl.bi * 2 * p.H + 2 * y + pr) * (2 * (size_t)p.W) + 2 * tl.x0 + fc;
        } else {
          sp = pix;
          y = tl.y0 + (pix >> 4);
          x = tl.x0 + (pix & 15);
          dst = ((size_t)tl.bi * p.H + y) * p.W + x;
        }
        if (y < p.H && x < p.W)
          *reinterpret_cast<uint4*>(out + dst * p.Co + n0 + u * 8) =
              lds128(ostage + ost<BN>(sp, u));
      }
    }
  }
  cp_async_wait_all();
}

// ============================================================ fp32 path

namespace f32 {

constexpr int TH = 8;            // coarse tile rows
constexpr int PH = TH + 2;       // staged patch rows (1-pixel halo)
constexpr int PW = TW + 2;       // staged patch cols
constexpr int NPIX = PH * PW;    // 180 staged pixels
constexpr int LD = 33;           // row pitch in floats: odd, so scalar loads of 8 rows miss no bank

constexpr size_t smem_bytes(int taps, int bn) {
  return sizeof(float) * (size_t)(NPIX + taps * bn) * LD;
}

// Stage input channels [c0, c0 + KC) of the coarse tile's (PH x PW) patch
// into `sp` (pitch LD floats a pixel), zero outside the image.
__device__ __forceinline__ void stage_patch(const Args& p, float* sp, int bi, int y0, int x0,
                                            int c0) {
  constexpr int PER_PIX = KC / 4;
  const float* x = static_cast<const float*>(p.x);
  for (int task = threadIdx.x; task < NPIX * PER_PIX; task += kThreads) {
    const int pix = task / PER_PIX;
    const int part = task % PER_PIX;
    const int y = y0 - 1 + pix / PW;
    const int xx = x0 - 1 + pix % PW;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y >= 0 && y < p.H && xx >= 0 && xx < p.W)
      raw = *reinterpret_cast<const float4*>(x + bi * p.sb + y * p.sh + xx * p.sw + c0 + part * 4);
    float* dst = sp + pix * LD + part * 4;
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
}

// Stage weights [par][tap][n0 + n][c0 .. c0 + KC) for the NT taps into `sw`
// (row tap * BN + n, pitch LD).
template <int NT, int BN>
__device__ __forceinline__ void stage_weights(const Args& p, float* sw, int par, int n0, int c0) {
  constexpr int PER_ROW = KC / 4;
  const float* w = static_cast<const float*>(p.w);
  for (int task = threadIdx.x; task < NT * BN * PER_ROW; task += kThreads) {
    const int row = task / PER_ROW;
    const int part = task % PER_ROW;
    const int tap = row / BN;
    const int n = row % BN;
    const float4 raw = *reinterpret_cast<const float4*>(
        w + (((size_t)par * NT + tap) * p.Co + n0 + n) * p.Ci + c0 + part * 4);
    float* dst = sw + row * LD + part * 4;
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
}

}  // namespace f32

// One block: an 8 x 16 coarse tile, one parity (upsample) and BN channels.
template <int NT, int BN>
__global__ void __launch_bounds__(kThreads)
upconv_f32_kernel(const Args p) {
  using f32::LD, f32::PW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float* sw = sp + f32::NPIX * LD;
  constexpr int NG = BN / 16;     // channel groups of 16, one per warp
  constexpr int MW = 8 / NG;      // warps along the tile rows
  constexpr int ROWS = f32::TH / MW;  // tile rows a warp owns
  constexpr int PP = ROWS / 2;    // pixels a thread owns

  const int per_image = p.tiles_x * p.tiles_y;
  const int t = blockIdx.x % per_image;
  const int bi = blockIdx.x / per_image;
  const int y0 = (t / p.tiles_x) * f32::TH, x0 = (t % p.tiles_x) * TW;
  const int par = blockIdx.y / p.n_blocks, n0 = (blockIdx.y % p.n_blocks) * BN;
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
    f32::stage_patch(p, sp, bi, y0, x0, c0);
    f32::stage_weights<NT, BN>(p, sw, par, n0, c0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < NT; ++tap) {
      // where the tap reads, in patch coordinates: the conv's 3x3 window;
      // parity (p, q) reads patch rows p, p + 1 and columns q, q + 1
      const int oy = NT == 9 ? tap / 3 : (par >> 1) + (tap >> 1);
      const int ox = NT == 9 ? tap % 3 : (par & 1) + (tap & 1);
      const float* wt = sw + (tap * BN + wn * 16) * LD;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float av[PP], bv[16];
#pragma unroll
        for (int i = 0; i < PP; ++i)
          av[i] = sp[((wm * ROWS + 2 * i + r0 + oy) * PW + col + ox) * LD + k];
#pragma unroll
        for (int j = 0; j < 16; ++j) bv[j] = wt[j * LD + k];
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
    const int y = y0 + wm * ROWS + 2 * i + r0;
    const int x = x0 + col;
    if (y >= p.H || x >= p.W) continue;
    size_t pix;
    if (p.upsample)
      pix = ((size_t)bi * 2 * p.H + 2 * y + (par >> 1)) * (2 * (size_t)p.W) + 2 * x + (par & 1);
    else
      pix = ((size_t)bi * p.H + y) * p.W + x;
    const size_t base = pix * p.Co + n0 + wn * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      out[base + j] = epilogue(acc[i][j], p.bias[n0 + wn * 16 + j], p.lrelu);
  }
}

// ============================================================ launch

template <typename K>
cudaError_t launch(K kern, size_t smem, dim3 grid, const Args& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 launch of one mode and BN: plan[0..4] = shared bytes, resident
// weights (0 / 1), grid.x, grid.y, the most tiles a block walks. With
// `run` false only the plan is computed.
template <bool kUp, int BN>
cudaError_t bf16_plan_launch(Args p, int* plan, bool run, cudaStream_t stream) {
  using PL = Plan<kUp, BN>;
  size_t smem;
  PL::smem(p.Ci, p.resident, smem);
  p.tiles_x = (p.W + TW - 1) / TW;
  p.tiles_y = (p.H + PL::TH - 1) / PL::TH;
  const long long ntiles = (long long)p.B * p.tiles_x * p.tiles_y;
  if (ntiles > 2147483647LL || p.Co / BN > 65535) return cudaErrorInvalidValue;
  auto kern = upconv_bf16_kernel<kUp, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // persistent blocks: the SM slots shared by the channel blocks
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const long long nb = p.Co / BN;
  long long blocks = ((long long)sms * per_sm + nb - 1) / nb;
  if (blocks > ntiles) blocks = ntiles;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)nb);
  if (plan != nullptr) {
    plan[0] = (int)smem;
    plan[1] = p.resident;
    plan[2] = (int)grid.x;
    plan[3] = (int)grid.y;
    plan[4] = (int)((ntiles + blocks - 1) / blocks);
  }
  if (!run) return cudaSuccess;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t bf16_dispatch(const Args& p, int* plan, bool run, cudaStream_t stream) {
  const bool wide = p.Co % 64 == 0;  // BN = 64, else 32
  if (p.upsample)
    return wide ? bf16_plan_launch<true, 64>(p, plan, run, stream)
                : bf16_plan_launch<true, 32>(p, plan, run, stream);
  return wide ? bf16_plan_launch<false, 64>(p, plan, run, stream)
              : bf16_plan_launch<false, 32>(p, plan, run, stream);
}

template <int NT, int BN>
cudaError_t f32_launch(Args p, cudaStream_t stream) {
  p.n_blocks = p.Co / BN;
  p.tiles_x = (p.W + TW - 1) / TW;
  p.tiles_y = (p.H + f32::TH - 1) / f32::TH;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x;
  if (blocks > 2147483647LL || (NT == 4 ? 4 : 1) * p.n_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (NT == 4 ? 4 : 1) * p.n_blocks);
  return launch(upconv_f32_kernel<NT, BN>, f32::smem_bytes(NT, BN), grid, p, stream);
}

cudaError_t f32_dispatch(const Args& p, cudaStream_t stream) {
  const bool wide = p.Co % 64 == 0;
  if (p.upsample) return wide ? f32_launch<4, 64>(p, stream) : f32_launch<4, 32>(p, stream);
  return wide ? f32_launch<9, 64>(p, stream) : f32_launch<9, 32>(p, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

bool valid_shape(int B, int H, int W, int Ci, int Co, int upsample, long long sb, long long sh,
                 long long sw) {
  return B > 0 && H > 0 && W > 0 && Ci > 0 && Co > 0 && Ci % KC == 0 && Co % 32 == 0 &&
         (upsample == 0 || upsample == 1) && sb >= 0 && sh >= 0 && sw >= 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); bias is fp32.
// x is read at x + b*sb + y*sh + x*sw + c (element strides; the channels
// contiguous and each pixel's channels 16-byte aligned). w is (4, 4, Co, Ci)
// when upsample is 1 (the folded parity weights), (1, 9, Co, Ci) when it is
// 0. lrelu is 0 or 1. Returns the cudaError_t of the launch (cudaGetLastError), 0 on success.
int upconv3x3_fwd(const void* x, long long sb, long long sh, long long sw, const void* w,
                  const float* bias, void* out, int B, int H, int W, int Ci, int Co,
                  int upsample, int lrelu, int dtype, void* stream) {
  if (!valid_shape(B, H, W, Ci, Co, upsample, sb, sh, sw)) return (int)cudaErrorInvalidValue;
  const Args p{x, sb, sh, sw, w, bias, out, B, H, W, Ci, Co, upsample, lrelu, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)f32_dispatch(p, s);
  if (dtype == 1) {
    if (!aligned16(x) || !aligned16(w) || !aligned16(out) || sb % 8 || sh % 8 || sw % 8)
      return (int)cudaErrorMisalignedAddress;
    return (int)bf16_dispatch(p, nullptr, true, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 launch plan of a call, without launching: plan[0..4] = the
// block's shared bytes, resident weights (0 / 1), grid.x, grid.y and the
// most tiles a block walks. Returns a cudaError_t, 0 on success.
int upconv3x3_bf16_plan(int B, int H, int W, int Ci, int Co, int upsample, int* plan) {
  if (!valid_shape(B, H, W, Ci, Co, upsample, 0, 0, 0)) return (int)cudaErrorInvalidValue;
  const Args p{nullptr, 0, 0, 0, nullptr, nullptr, nullptr, B, H, W, Ci, Co, upsample, 0,
               0, 0, 0, 0};
  return (int)bf16_dispatch(p, plan, false, nullptr);
}

const char* upconv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
