// Fused GroupNorm affine -> SiLU -> 3x3 conv [+ bias + residual] for Hopper
// (sm_90a), on channels-last (NHWC) tensors.
//
// Replaces the TPU kernel controlanimate_tpu/ops/conv_kernel.py `_conv_kernel`
// (called through `conv3x3_fused`). It computes what that kernel computes,
// with the plain version's roundings (ops/conv_kernel.py
// `conv3x3_fused_plain`):
//   z = x * a[b, c] + b[b, c]     in the input dtype, two roundings, never
//                                 one FMA (fp32: __fmul_rn then __fadd_rn;
//                                 bf16: mul.rn and add.rn on bf16x2, which
//                                 round as __fmul_rn / __fadd_rn in fp32
//                                 followed by a rounding to bf16 would)
//   z = silu(z)                   in fp32, rounded back to the input dtype
//   zero padding applied AFTER the activation (a border tap reads 0)
//   y = conv3x3(z, w)             fp32 accumulation, + bias (fp32)
//                                 [+ residual (fp32)], one rounding to the
//                                 output dtype.
// The TPU kernel keeps whole image rows in VMEM and does the 9*Cin reduction
// as one im2col dot. Here the conv is an implicit GEMM (M = pixels,
// N = Cout, K = 9*Cin) in which a tap's A tile is the input patch shifted by
// (dy, dx), so no im2col tensor exists.
//
// What bounds it on the H100: 2*9*B*H*W*Cin*Cout FLOPs against 989 TFLOP/s
// (bf16 tensor cores) is above the bytes it must move at every VAE shape:
// compute-bound. bf16 design (`conv3x3_bf16_kernel`):
//   - One block owns a 16 x 16 pixel tile and 128 output channels (1 block
//     an SM, 8 warps; warp (wm, wn) owns tile rows 4wm..4wm+3, i.e. 64
//     pixels, x channels 64wn..64wn+63, as 4 x 8 m16n8 fp32 accumulators).
//     Output-channel blocks are the fastest grid index, so the blocks that
//     read one patch run together. The 18 x 18 halo patch costs 1.27x the
//     tile in loads and activations.
//   - The block walks Cin in chunks of KC = 32 channels (the last chunk is
//     16 when Cin % 32 = 16) through a ring of two stages, each holding the
//     chunk's 9 x 128 x 32 weight slab (72 KB) and its activated patch
//     (20.25 KB), with one __syncthreads a chunk. While chunk k is
//     multiplied, chunk k+1's raw patch lands by 16-byte cp.async in a raw
//     buffer (one commit group) and its weight slab straight in the other
//     stage (a second group). From tap 2 on, each thread waits for its own
//     patch group only and activates one of its units after each tap
//     (affine, SiLU, rounding, border zeroing, branch-free), so the ALU
//     work issues between the products; every input element is activated
//     once a block. With no affine and no SiLU (the upsample convs) the
//     patch goes by cp.async straight into its stage, zero-filled outside
//     the image. The copy loops stay rolled so that their addresses hold no
//     registers across the products (unrolled, they spilled).
//   - Products: mma.sync m16n8k16 (bf16 in, fp32 accumulate). A and B
//     fragments come by ldmatrix.x4: a pixel's KC channels are one 64-byte
//     row, so a tap's A tile is 16 consecutive patch rows. Rows are 64 bytes
//     with their four 16-byte units XOR-swizzled (`swz`), so the 8 rows of
//     every ldmatrix 8x8 matrix (8 consecutive output channels, or 8
//     consecutive pixels of a patch row) fall in 8 different bank groups.
//   - The last chunk stages the block's residual tile by cp.async in the
//     stage it leaves free; the epilogue adds bias and residual in fp32,
//     rounds once into the other stage, and stores the tile in 16-byte
//     units, a pixel's 128 channels by 16 neighbouring threads, masked for
//     ragged tiles.
// fp32 (`conv3x3_f32_kernel`, the 1e-4 reference runs): 8 x 16 pixel tiles,
// 16-channel steps staged through shared memory with the same activation,
// the products as fp32 FMAs on the CUDA cores (no TF32), each thread owning
// 4 pixels x 16 channels; no pipelining.
//
// Layouts: x and residual (B, H, W, Cin / Cout) contiguous; out (B, H, W,
// Cout); weights re-laid by the wrapper to (9, Cout, Cin) contiguous in the
// input dtype (tap-major, Cin innermost: a weight row of one output channel
// is the mma B fragment's k run); a, b (B, Cin) in the input dtype; bias
// (Cout,) fp32. Cin must be a multiple of 16 and Cout of 128; H and W are
// free (ragged tiles are masked). bf16 needs 16-byte-aligned x, weights, a,
// b, residual and out (the entry point returns cudaErrorMisalignedAddress).
//
// Interface: plain C functions (no PyTorch headers), built by nvcc and
// loaded with ctypes by controlanimate_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

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

// One fp32 input element through affine -> SiLU (the fp32 kernel; the
// explicit _rn intrinsics keep nvcc from fusing the multiply and add into one
// FMA with a single rounding, as the plain version rounds after each).
__device__ __forceinline__ float activate(float v, float av, float bv, bool affine, bool silu) {
  if (affine) v = __fadd_rn(__fmul_rn(v, av), bv);
  if (silu) v = v * (1.f / (1.f + expf(-v)));
  return v;
}

// ============================================================ bf16 path

constexpr int kTile = 16;                  // the tile is kTile x kTile pixels
constexpr int kPatch = kTile + 2;          // staged patch side (1-pixel halo)
constexpr int kPatchPix = kPatch * kPatch; // 324
constexpr int BN = 128;                    // output channels a block
constexpr int KC = 32;                     // input channels a chunk
constexpr int kUnits = KC / 8;             // 16-byte units a staged row
constexpr int kRowBytes = KC * 2;          // one staged row: a pixel's or a weight's chunk
constexpr int kThreads = 256;              // 8 warps: 4 (tile rows) x 2 (channel halves)
constexpr int kStages = 2;                 // the chunk ring
constexpr int kWRows = 9 * BN;             // weight rows a stage, (tap, output channel)
constexpr int kWBytes = kWRows * kRowBytes;      // 73,728
constexpr int kPBytes = kPatchPix * kRowBytes;   // 20,736
constexpr int kStageBytes = kWBytes + kPBytes;   // 94,464
constexpr int kPatchUnits = kPatchPix * kUnits;  // 1296
constexpr int kPatchIters = (kPatchUnits + kThreads - 1) / kThreads;
static_assert(kUnits == 4, "swz permutes the four 16-byte units of a row");

__host__ __device__ constexpr size_t smem_bf16(bool transform) {
  return (size_t)kStages * kStageBytes + (transform ? kPBytes : 0);
}

// Byte offset of 16-byte unit u of staged row `row`; the unit index is XORed
// with bits 1-2 of `key`: the row itself for weights, the pixel's column in
// the patch for the patch. 8 consecutive keys then cover the 8 bank groups
// of 16 bytes once (bit 0 picks the half of the 128-byte line, bits 1-2 the
// unit), so every ldmatrix 8x8 matrix and every 128 bytes of stores are
// conflict-free.
__host__ __device__ constexpr int swz(int row, int key, int u) {
  return row * kRowBytes + ((u ^ ((key >> 1) & 3)) << 4);
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8, fp32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// What one block owns, and where its chunk ring lives.
struct Block {
  int bi, y0, x0, n0;
  uint32_t ring;  // shared address of stage 0
  uint32_t raw;   // the raw patch buffer (transform only)
};

// Units this thread stages: unit idx = threadIdx.x + i * kThreads is unit
// (idx & 3) of patch pixel idx >> 2; every thread keeps the same unit u.
struct PatchUnit {
  int pix, px, u;
  int y, x;     // the pixel in the image
  bool inside;  // in the image (false: the patch reads 0)
};

__device__ __forceinline__ PatchUnit patch_unit(const Args& p, const Block& blk, int idx) {
  PatchUnit pu;
  pu.pix = idx >> 2;
  pu.u = idx & 3;
  const int py = pu.pix / kPatch;
  pu.px = pu.pix - py * kPatch;
  pu.y = blk.y0 - 1 + py;
  pu.x = blk.x0 - 1 + pu.px;
  pu.inside = pu.y >= 0 && pu.y < p.H && pu.x >= 0 && pu.x < p.W;
  return pu;
}

// Issue chunk [c0, c0 + kc)'s patch into stage `st`: raw into the raw
// buffer when it is transformed, else straight into the stage, zero-filled
// outside the image. Units past kc are not staged: a short chunk's second k16
// step is skipped. The loops stay rolled (here and in load_weights), so that
// the addresses of the next chunk's copies hold no registers across the
// products.
template <bool kTransform>
__device__ __forceinline__ void load_patch(const Args& p, const Block& blk, int st, int c0,
                                           int kc) {
  if ((threadIdx.x & 3) * 8 >= kc) return;
  const uint32_t sp = blk.ring + st * kStageBytes + kWBytes;
  const bf16* x = static_cast<const bf16*>(p.x) + (size_t)blk.bi * p.H * p.W * p.Cin + c0 +
                  (threadIdx.x & 3) * 8;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kPatchUnits; idx += kThreads) {
    const PatchUnit pu = patch_unit(p, blk, idx);
    const bf16* src = pu.inside ? x + ((size_t)pu.y * p.W + pu.x) * p.Cin : x;
    if constexpr (kTransform) {
      if (pu.inside) cp_async16(blk.raw + idx * 16, src, true);
    } else {
      cp_async16(sp + swz(pu.pix, pu.px, pu.u), src, pu.inside);
    }
  }
}

// Issue chunk [c0, c0 + kc)'s weight slab into stage `st`: this thread
// copies unit u = threadIdx.x & 3 of output channels n0 + threadIdx.x / 4 and
// n0 + 64 + threadIdx.x / 4, for each tap (rows tap * BN + n; bits 1-2 of
// the row, the swizzle key, are those of threadIdx.x / 4).
__device__ __forceinline__ void load_weights(const Args& p, const Block& blk, int st, int c0,
                                             int kc) {
  const int u = threadIdx.x & 3, n = threadIdx.x >> 2;
  if (u * 8 >= kc) return;
  uint32_t dst = blk.ring + st * kStageBytes + swz(n, n, u);
  const bf16* src = static_cast<const bf16*>(p.w) + (size_t)(blk.n0 + n) * p.Cin + c0 + u * 8;
  const size_t tap_stride = (size_t)p.Cout * p.Cin, half_stride = (size_t)(BN / 2) * p.Cin;
  static_assert(kThreads / 4 == BN / 2, "each thread copies two output channels a tap");
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap, src += tap_stride, dst += BN * kRowBytes) {
    cp_async16(dst, src, true);
    cp_async16(dst + (BN / 2) * kRowBytes, src + half_stride, true);
  }
}

// This thread's 8 channels of a and b for chunk c0 (its unit u is fixed).
struct Affine8 {
  uint4 a, b;
};

template <bool kAffine>
__device__ __forceinline__ Affine8 load_affine(const Args& p, const Block& blk, int c0) {
  Affine8 ab{};
  if constexpr (kAffine) {
    const size_t c = (size_t)blk.bi * p.Cin + c0 + (threadIdx.x & 3) * 8;
    ab.a = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.a) + c));
    ab.b = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.b) + c));
  }
  return ab;
}

// bf16x2 multiply and add, each rounded once to nearest even; the explicit
// .rn keeps ptxas from contracting the pair into one fma.
__device__ __forceinline__ uint32_t bf16x2_mul_rn(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_add_rn(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// silu(z) = z / (1 + 2^(-z log2 e)) with the approximate exp2 and reciprocal
// (a few fp32 ulps; outputs below fp32's normal range flush to 0).
__device__ __forceinline__ float silu_fast(float z) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return z * r;
}

// Eight bf16 through affine -> SiLU, two at a time. The affine is a bf16x2
// multiply and a bf16x2 add, each rounding once to bf16: that is
// __fmul_rn / __fadd_rn in fp32 and a rounding to bf16, because the product
// of two bf16 is exact in fp32, and so is their sum unless the exponents are
// more than 16 apart, when both give the larger operand. SiLU is fp32
// (`silu_fast`: a few fp32 ulps, far below the bf16 rounding that follows).
template <bool kAffine, bool kSilu>
__device__ __forceinline__ uint4 activate8(uint4 raw, const Affine8& ab) {
  uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
  const uint32_t a[4] = {ab.a.x, ab.a.y, ab.a.z, ab.a.w};
  const uint32_t b[4] = {ab.b.x, ab.b.y, ab.b.z, ab.b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kAffine) v[j] = bf16x2_add_rn(bf16x2_mul_rn(v[j], a[j]), b[j]);
    if constexpr (kSilu) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[j]));
      const __nv_bfloat162 h = __floats2bfloat162_rn(silu_fast(f.x), silu_fast(f.y));
      v[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Unit i of the units this thread copied into the raw buffer for chunk
// `c0`, activated into stage `st`, zero outside the image. Branch-free, so
// that it schedules between the products: a unit outside the image or past
// a short chunk's kc holds stale bytes, which are computed on and then
// zeroed (outside) or never read (past kc). Call after this thread's patch
// copies have landed, for a unit that exists (idx < kPatchUnits); it reads
// only what this thread copied.
template <bool kAffine, bool kSilu>
__device__ __forceinline__ void activate_unit(const Args& p, const Block& blk, int st, int i,
                                              const Affine8& ab) {
  const int idx = threadIdx.x + i * kThreads;
  const PatchUnit pu = patch_unit(p, blk, idx);
  uint4 v = activate8<kAffine, kSilu>(lds128(blk.raw + idx * 16), ab);
  if (!pu.inside) v = make_uint4(0u, 0u, 0u, 0u);
  sts128(blk.ring + st * kStageBytes + kWBytes + swz(pu.pix, pu.px, pu.u), v);
}

// All of this thread's units of a chunk (the prologue's first chunk).
template <bool kAffine, bool kSilu>
__device__ __forceinline__ void activate_units(const Args& p, const Block& blk, int st, int c0) {
  const Affine8 ab = load_affine<kAffine>(p, blk, c0);
#pragma unroll 1
  for (int i = 0; i < kPatchIters; ++i)
    if (threadIdx.x + i * kThreads < kPatchUnits) activate_unit<kAffine, kSilu>(p, blk, st, i, ab);
}

// The residual tile (kTile x kTile pixels x BN channels, 256-byte rows, the
// 16-byte unit XORed with the pixel's column & 7 so that the epilogue's 8
// pixels of a read fall in 8 bank groups), into stage memory at `dst`.
// Pixels outside the image are not read (their outputs are not stored).
__device__ __forceinline__ void load_residual(const Args& p, const Block& blk, uint32_t dst) {
  constexpr int kUnitsRow = BN / 8;
  const bf16* res = static_cast<const bf16*>(p.res);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kTile * kTile * kUnitsRow; idx += kThreads) {
    const int pix = idx / kUnitsRow, u = idx % kUnitsRow;
    const int y = blk.y0 + pix / kTile, x = blk.x0 + pix % kTile;
    if (y < p.H && x < p.W)
      cp_async16(dst + pix * BN * 2 + ((u ^ (x & 7)) << 4),
                 res + (((size_t)blk.bi * p.H + y) * p.W + x) * p.Cout + blk.n0 + u * 8, true);
  }
}

// This warp's lane offsets for ldmatrix, in bytes from the stage (weights) or
// from its patch. B: output channel row 64wn + (lane & 7) + 8 (lane >> 4) of
// tap 0, unit 2s + ((lane >> 3) & 1); a tap and an n16 pair add
// (tap * BN + 16 j) rows, which keeps the swizzle key. A: patch row 4wm,
// column (lane & 15) + dx, unit 2s + (lane >> 4); a tap row dy and an m16
// tile mt add (mt + dy) patch rows, which keeps the key (a column's).
struct LaneOffsets {
  uint32_t b[2];
  uint32_t a[3][2];
};

__device__ __forceinline__ LaneOffsets lane_offsets(int wm, int wn, int lane) {
  LaneOffsets o;
  const int bn = wn * 64 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    o.b[s] = swz(bn, bn, 2 * s + ((lane >> 3) & 1));
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int px = (lane & 15) + dx;
      o.a[dx][s] = kWBytes + swz(4 * wm * kPatch + px, px, 2 * s + (lane >> 4));
    }
  }
  return o;
}

// One tap of one chunk in stage memory `stage`: `ksteps` k16 steps (2, or 1
// for a short chunk) of 4 m16 x 8 n8 products each.
__device__ __forceinline__ void mma_tap(float (&acc)[4][8][4], uint32_t stage,
                                        const LaneOffsets& o, int tap, int ksteps) {
  const int dy = tap / 3, dx = tap % 3;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s >= ksteps) break;
    uint32_t bf[8][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t r[4];
      ldmatrix_x4(r, stage + (tap * BN + 16 * j) * kRowBytes + o.b[s]);
      bf[2 * j][0] = r[0];
      bf[2 * j][1] = r[1];
      bf[2 * j + 1][0] = r[2];
      bf[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t af[4];
      ldmatrix_x4(af, stage + (mt + dy) * kPatch * kRowBytes + o.a[dx][s]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
    }
  }
}

// kAffine / kSilu: what is applied to the input; with neither, the patch is
// staged by cp.async alone.
template <bool kAffine, bool kSilu>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bf16_kernel(const Args p) {
  constexpr bool kTransform = kAffine || kSilu;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nblk = p.Cout / BN;  // output-channel blocks are the fastest index,
  const int tile = blockIdx.x / nblk;  // so the blocks of one tile share its patch in L2
  const int per_image = p.tiles_x * p.tiles_y;
  const int t = tile % per_image;
  Block blk;
  blk.bi = tile / per_image;
  blk.y0 = (t / p.tiles_x) * kTile;
  blk.x0 = (t % p.tiles_x) * kTile;
  blk.n0 = (blockIdx.x - tile * nblk) * BN;
  blk.ring = smem_u32(smem);
  blk.raw = blk.ring + kStages * kStageBytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3;   // tile rows 4wm .. 4wm + 3
  const int wn = warp >> 2;  // channels n0 + 64wn .. + 63
  const LaneOffsets o = lane_offsets(wm, wn, lane);

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int nchunks = (p.Cin + KC - 1) / KC;
  const int kc0 = min(KC, p.Cin);
  load_patch<kTransform>(p, blk, 0, 0, kc0);
  load_weights(p, blk, 0, 0, kc0);
  cp_async_commit();
  cp_async_wait<0>();
  if constexpr (kTransform) activate_units<kAffine, kSilu>(p, blk, 0, 0);
  __syncthreads();

  for (int k = 0; k < nchunks; ++k) {
    const int st = k & 1;
    const int ksteps = min(KC, p.Cin - k * KC) / 16;
    const uint32_t stage = blk.ring + st * kStageBytes;
    if (k + 1 < nchunks) {
      // Chunk k + 1 goes to the other stage, which every warp finished
      // reading before the barrier that ended chunk k - 1: its patch first,
      // in a group of its own, then its weights.
      const int c1 = (k + 1) * KC;
      const int kc1 = min(KC, p.Cin - c1);
      load_patch<kTransform>(p, blk, st ^ 1, c1, kc1);
      cp_async_commit();
      load_weights(p, blk, st ^ 1, c1, kc1);
      cp_async_commit();
      Affine8 ab{};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        mma_tap(acc, stage, o, tap, ksteps);
        // chunk k + 1's patch, activated one unit after each of taps 2..6
        // (and the sixth, which 16 threads have, after the last), so that
        // its ALU work issues between the products
        if constexpr (kTransform) {
          if (tap == 2) {
            cp_async_wait<1>();  // this thread's patch copies have landed
            ab = load_affine<kAffine>(p, blk, c1);
          }
          if (tap >= 2 && tap <= kPatchIters)
            activate_unit<kAffine, kSilu>(p, blk, st ^ 1, tap - 2, ab);
        }
      }
      if constexpr (kTransform) {
        if (threadIdx.x + (kPatchIters - 1) * kThreads < kPatchUnits)
          activate_unit<kAffine, kSilu>(p, blk, st ^ 1, kPatchIters - 1, ab);
      }
    } else {
      // the last chunk stages the residual in the other stage instead
      if (p.res != nullptr) load_residual(p, blk, blk.ring + (st ^ 1) * kStageBytes);
      cp_async_commit();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) mma_tap(acc, stage, o, tap, ksteps);
    }
    cp_async_wait<0>();
    __syncthreads();  // chunk k + 1 is staged, and every warp is done with stage st
  }

  // The residual sits in the stage the last chunk did not use. The output
  // tile is rounded into the stage the last chunk used (256-byte pixel rows,
  // swizzled as the residual), then stored in 16-byte units, 16 threads a
  // pixel row.
  const unsigned char* res = smem + (nchunks & 1) * kStageBytes;
  unsigned char* tile_out = smem + ((nchunks - 1) & 1) * kStageBytes;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tx = g + 8 * half;  // column within the tile; x & 7 = g
      const int row = ((4 * wm + mt) * kTile + tx) * BN * 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wn * 64 + nt * 8 + 2 * tg;  // channel within the block
        const int off = row + (((c >> 3) ^ g) << 4) + (c & 7) * 2;
        float v0 = acc[mt][nt][2 * half] + p.bias[blk.n0 + c];
        float v1 = acc[mt][nt][2 * half + 1] + p.bias[blk.n0 + c + 1];
        if (p.res != nullptr) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + off);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(tile_out + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.out);
  constexpr int kUnitsRow = BN / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kTile * kTile * kUnitsRow; idx += kThreads) {
    const int pix = idx / kUnitsRow, u = idx % kUnitsRow;
    const int y = blk.y0 + pix / kTile, x = blk.x0 + pix % kTile;
    if (y < p.H && x < p.W)
      *reinterpret_cast<uint4*>(out + (((size_t)blk.bi * p.H + y) * p.W + x) * p.Cout + blk.n0 +
                                u * 8) =
          *reinterpret_cast<const uint4*>(tile_out + pix * BN * 2 + ((u ^ (x & 7)) << 4));
  }
}

// ============================================================ fp32 path

namespace f32 {

constexpr int TH = 8;            // tile rows
constexpr int TW = 16;           // tile cols
constexpr int PH = TH + 2;       // staged patch rows (1-pixel halo)
constexpr int PW = TW + 2;       // staged patch cols
constexpr int NPIX = PH * PW;    // 180 staged pixels
constexpr int KC = 16;           // input channels per step
constexpr int LD = 17;           // row pitch in floats: odd, so scalar loads of 8 rows miss no bank
constexpr int kThreads = 256;
constexpr size_t kSmem = sizeof(float) * (size_t)(NPIX + 9 * BN) * LD;

// Stage input channels [c0, c0 + 16) of the tile's (PH x PW) patch into `sp`,
// activated, zero outside the image.
__device__ __forceinline__ void stage_patch(const Args& p, float* sp, int bi, int y0, int x0,
                                            int c0) {
  constexpr int PER_PIX = KC / 4;  // 16-byte loads a pixel
  const float* x = static_cast<const float*>(p.x);
  const bool affine = p.a != nullptr, silu = p.silu != 0;
  const float* a = affine ? static_cast<const float*>(p.a) + (size_t)bi * p.Cin : nullptr;
  const float* b = affine ? static_cast<const float*>(p.b) + (size_t)bi * p.Cin : nullptr;
  for (int task = threadIdx.x; task < NPIX * PER_PIX; task += kThreads) {
    const int pix = task / PER_PIX;
    const int part = task % PER_PIX;
    const int y = y0 - 1 + pix / PW;
    const int xx = x0 - 1 + pix % PW;
    float* dst = sp + pix * LD + part * 4;
    if (y >= 0 && y < p.H && xx >= 0 && xx < p.W) {
      const int c = c0 + part * 4;
      const float4 raw = *reinterpret_cast<const float4*>(
          x + (((size_t)bi * p.H + y) * p.W + xx) * p.Cin + c);
      const float rv[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = activate(rv[i], affine ? a[c + i] : 0.f, affine ? b[c + i] : 0.f, affine,
                                 silu);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = 0.f;
    }
  }
}

// Stage weights [tap][n0 + n][c0 .. c0 + 16) for all 9 taps into `sw`
// (row (tap * BN + n), pitch LD).
__device__ __forceinline__ void stage_weights(const Args& p, float* sw, int n0, int c0) {
  constexpr int PER_ROW = KC / 4;
  const float* w = static_cast<const float*>(p.w);
  for (int task = threadIdx.x; task < 9 * BN * PER_ROW; task += kThreads) {
    const int row = task / PER_ROW;
    const int part = task % PER_ROW;
    const int tap = row / BN;
    const int n = row % BN;
    const float4 raw = *reinterpret_cast<const float4*>(
        w + ((size_t)tap * p.Cout + n0 + n) * p.Cin + c0 + part * 4);
    float* dst = sw + row * LD + part * 4;
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
}

}  // namespace f32

__global__ void __launch_bounds__(f32::kThreads)
conv3x3_f32_kernel(const Args p) {
  using f32::TH, f32::TW, f32::PW, f32::NPIX, f32::LD;
  constexpr int KC = f32::KC;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float* sw = sp + NPIX * LD;

  const int per_image = p.tiles_x * p.tiles_y;
  const int t = blockIdx.x % per_image;
  const int bi = blockIdx.x / per_image;
  const int y0 = (t / p.tiles_x) * TH, x0 = (t % p.tiles_x) * TW, n0 = blockIdx.y * BN;
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
    f32::stage_patch(p, sp, bi, y0, x0, c0);
    f32::stage_weights(p, sw, n0, c0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* wt = sw + (tap * BN + warp * 16) * LD;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float av[4], bv[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sp[((2 * i + row0 + dy) * PW + col + dx) * LD + k];
#pragma unroll
        for (int j = 0; j < 16; ++j) bv[j] = wt[j * LD + k];
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
    const int y = y0 + 2 * i + row0;
    const int x = x0 + col;
    if (y >= p.H || x >= p.W) continue;
    const size_t base = (((size_t)bi * p.H + y) * p.W + x) * p.Cout + n0 + warp * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[i][j] + p.bias[n0 + warp * 16 + j];
      if (res != nullptr) v += res[base + j];
      out[base + j] = v;
    }
  }
}

template <typename K>
cudaError_t launch(K kern, size_t smem, dim3 grid, int threads, const Args& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b, residual and out share it);
// bias is fp32. a and b are both null (no affine) or both set; residual may
// be null; silu is 0 or 1. Returns the cudaError_t of the launch
// (cudaGetLastError), 0 on success.
int conv3x3_fused_fwd(const void* x, const void* w, const float* bias, const void* a,
                      const void* b, const void* residual, void* out, int B, int H, int W,
                      int Cin, int Cout, int silu, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 16 != 0 || Cout % BN != 0 ||
      (a == nullptr) != (b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args p{x, w, bias, a, b, residual, out, B, H, W, Cin, Cout, silu,
                 (W + f32::TW - 1) / f32::TW, (H + f32::TH - 1) / f32::TH};
    const long long blocks = (long long)B * p.tiles_y * p.tiles_x;
    if (blocks > 2147483647LL || Cout / BN > 65535) return (int)cudaErrorInvalidValue;
    return (int)launch(conv3x3_f32_kernel, f32::kSmem, dim3((unsigned)blocks, Cout / BN),
                       f32::kThreads, p, s);
  }
  if (dtype == 1) {
    for (const void* ptr : {x, w, a, b, residual, (const void*)out})
      if (ptr != nullptr && !aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
    const Args p{x, w, bias, a, b, residual, out, B, H, W, Cin, Cout, silu,
                 (W + kTile - 1) / kTile, (H + kTile - 1) / kTile};
    const long long blocks = (long long)B * p.tiles_y * p.tiles_x * (Cout / BN);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks);
    const size_t smem = smem_bf16(a != nullptr || silu);
    if (a != nullptr && silu)
      return (int)launch(conv3x3_bf16_kernel<true, true>, smem, grid, kThreads, p, s);
    if (a != nullptr)
      return (int)launch(conv3x3_bf16_kernel<true, false>, smem, grid, kThreads, p, s);
    if (silu) return (int)launch(conv3x3_bf16_kernel<false, true>, smem, grid, kThreads, p, s);
    return (int)launch(conv3x3_bf16_kernel<false, false>, smem, grid, kThreads, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* conv3x3_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
