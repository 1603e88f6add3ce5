// K3: the fused AnimateDiff temporal transformer for Hopper (sm_90a), on
// (B, F, N, C) activations flattened to M = B*F*N rows of C channels.
//
// Replaces the TPU kernel controlanimate_tpu/ops/motion_kernel.py
// `_motion_kernel` (called through `motion_module_fused`). It computes what
// that kernel computes and returns the module's delta (the caller adds the
// outer residual):
//   h = x * gn_a[b, f] + gn_b[b, f]               folded GroupNorm affine
//   h = h @ Win^T + bin                            proj_in
//   2 x { z = LN(h) (+ pe[f]);  q, k, v = z @ Wq^T, Wk^T, Wv^T
//         per (b, n, head): softmax_g(q_f . k_g / sqrt(D)) over the F frames
//         h = h + attn @ Wo^T + ob }
//   z = LN(h);  g = z @ W1^T + b1;  h = h + (g_val * gelu(g_gate)) @ W2^T + b2
//   out = h @ Wout^T + bout
// Numerics, held by the plain version (ops/motion_kernel.py
// `motion_module_plain`): LayerNorm statistics in fp32 (var = E[x^2] - E[x]^2
// clamped at 0, eps 1e-5), the normalize and affine in the input dtype with a
// rounding after every multiply and add; GEMMs on input-dtype operands with
// fp32 accumulation, + bias [+ residual] in fp32 and one rounding; V kept in
// fp32; the logits and the softmax over frames in fp32, the probabilities
// rounded to the input dtype, P V in fp32 against fp32 V; the GELU by erff in
// fp32 (the TPU kernel uses a polynomial only because Mosaic has no erf).
//
// The TPU kernel keeps every weight (22 C^2 values) and a block of positions
// resident in VMEM. On the H100 that is 4.5 MB (C = 320) to 72 MB (C = 1280)
// of bf16 weights against 227 KB of shared memory, so the weights stream and
// the module is a chain of fourteen launches on the caller's stream:
//   norm_gn, proj_in, 2 x (norm, QKV, attention, out-projection + residual),
//   norm_ff, W1 + GEGLU, W2 + residual, proj_out.
// What bounds it on the H100: 44 C^2 + 8 F C FLOPs a token at 989 TFLOP/s
// (bf16) is above the bytes it must move (2 C elements a token and the
// weights) at every main-path shape, so the module is bound by its operations
// and spends them in the seven GEMMs. The chain adds the intermediates (z, h,
// q|k, v, attn, the GEGLU output) written and read back between launches,
// about 98 C bytes a token in bf16, which at C = 320 takes longer at 3.35 TB/s
// than the products at the tensor-core rate (chip_smoke.py `k3_stage_split`).
// The design:
//   - Normalize pass (`motion_normalize_kernel`): one warp a row reads h in
//     16-byte units, takes the LayerNorm statistics in fp32 and writes z in
//     the dtype (LN, affine, + PE), or the folded GroupNorm affine for
//     proj_in. The statistics are taken once a row, not once an output tile,
//     and every GEMM reads a plain A that cp.async copies untouched.
//   - GEMM (`motion_gemm_bf16_kernel`): (M, K) x (Nw, K)^T, both K-contiguous,
//     on the tensor cores as mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//     Output tiles of BM x 160 (BM = 128, or 64 where 128-row tiles would not
//     give every SM a block: the C-wide GEMMs at M = 1024), 8 warps of
//     (BM / 4) x 80. A and W go through a three-stage cp.async ring of
//     BK = 64; a staged row is 128 bytes whose 16-byte units are XORed with
//     the row's low bits, so each ldmatrix 8x8 matrix and each row's 8
//     copies hit 8 different bank groups; the fragments come by ldmatrix.x4,
//     double-buffered across k16 steps. A block's column tile is the fastest
//     grid index, so the blocks that share a row tile of A run together.
//     160 divides 320, 640, 960 and 1280: no GEMM of the main path has a
//     half-empty column tile.
//   - Epilogue: the fp32 products go to shared memory, then out in 16-byte
//     units of the output dtype: + bias; + bias + residual (in place on h);
//     the q|k (dtype) / v (fp32) split; the GEGLU gate (a column tile holds
//     80 value columns of W1 and their 80 gates, `GEGLU_GROUP`).
//   - Frame attention (`motion_frame_attention_kernel`): a block takes P
//     consecutive positions of one sample at a group of heads (all of them
//     unless shared memory is short): at frame f those positions are P
//     consecutive rows of q|k and of v, copied by cp.async in 16-byte units.
//     v's copies land while a thread computes a row of F logits and its
//     fp32 softmax in registers; P V as fp32 FMAs, each v chunk read from
//     shared memory serving four query frames; the output stored 16 bytes
//     a thread.
// fp32 (`motion_gemm_f32_kernel`, the 1e-4 reference runs): the same chain,
// the GEMMs as FMAs on the CUDA cores (no TF32) on 128 x 160 tiles staged
// through shared memory without pipelining, with the same epilogue.
//
// Layouts: x (M, C) contiguous in the dtype; gn_a, gn_b (B*F, C) dtype; pe
// (F, C) dtype or null; weights (out, in) contiguous in the dtype (nn.Linear's
// layout; q, k, v concatenated to (3C, C); W1's rows re-laid in groups of 80
// as [80 value rows | 80 matching gate rows], zero-padded to whole groups);
// biases fp32 (W1's in the same row order); LayerNorm scale / bias (C,) dtype.
// Every pointer 16-byte aligned. C must be a multiple of 8 (16-byte rows), F
// at most 32; N and M are free (ragged tiles are masked).
//
// Interface: plain C functions (no PyTorch headers), built with one nvcc call
// and loaded with ctypes by controlanimate_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;           // 8 warps, every kernel
constexpr int BN = 160;                 // GEMM output columns a block
constexpr int GEGLU_GROUP = BN / 2;     // W1 value rows (then as many gate rows) a group
constexpr int kWarpCols = BN / 2;       // a warp's columns (warps 4 x 2)
constexpr int kPairs = kWarpCols / 16;  // n16 pairs of m16n8 tiles a warp
constexpr int BK = 64;                  // bf16 reduction depth a stage
constexpr int kRowBytes = BK * 2;       // one staged row: 8 units of 16 bytes
constexpr int kRing = 3;                // cp.async stages
constexpr int LDC = BN + 8;             // fp32 product tile pitch (conflict-free float2 stores)
constexpr int BM32 = 128;               // fp32 GEMM rows a block
constexpr int BK32 = 32;                // fp32 reduction depth a stage
constexpr int LDF = BK32 + 1;           // fp32 staging pitch (odd)
constexpr int kMaxFrames = 32;
constexpr int kSmemLimit = 232448;      // shared memory a block may use
constexpr int kAttnBudget = 112640;     // the attention's aim (110 KB): two blocks an SM

template <int MT>  // m16 tiles a warp: BM = 64 * MT
struct Tile {
  static constexpr int BM = 64 * MT;
  static constexpr int kStageBytes = (BM + BN) * kRowBytes;
  static constexpr int kRingBytes = kRing * kStageBytes;
  static constexpr int kOutBytes = BM * LDC * 4;
  static constexpr int kSmem = kRingBytes > kOutBytes ? kRingBytes : kOutBytes;  // aliased
};
constexpr int kSmemF32 = BM32 * LDC * 4 > (BM32 + BN) * LDF * 4 ? BM32 * LDC * 4
                                                                : (BM32 + BN) * LDF * 4;
static_assert(2 * (Tile<1>::kSmem + 1024) <= 233472, "two 64-row bf16 GEMM blocks fit an SM");

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_RES = 1, EPI_QKV = 2, EPI_GEGLU = 3 };
enum Norm { NORM_GN = 0, NORM_LN = 1 };

struct Gemm {
  const void* a;      // (M, K) dtype
  const void* w;      // (Nw, K) dtype
  const float* bias;  // (Nw,) or null
  const void* res;    // (M, ldo) dtype or null; may alias out
  void* out;          // (M, ldo) dtype
  float* out32;       // EPI_QKV: columns >= split, (M, Nw - split) fp32
  int M, K, Nw, ldo, split, epi;
};

struct NormArgs {
  const void* h;   // (M, C) dtype
  void* z;         // (M, C) dtype
  const void* pa;  // GN: (B*F, C) a; LN: (C,) scale
  const void* pb;  // GN: (B*F, C) b; LN: (C,) bias
  const void* pe;  // LN: (F, C) or null
  long long M;
  int C, N, F, mode;
};

struct Attn {
  const void* qk;     // (M, 2C) dtype: q | k
  const float* v;     // (M, C)
  void* out;          // (M, C) dtype
  int F, N, C, D;
  int HG, P;          // heads a block, positions a block
  int groups, tiles;  // head groups, position tiles a sample
  int v_offset;       // bytes: v's staging (after q|k's)
  int p_offset;       // bytes: the probabilities (after v's)
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
// v rounded to T and back: the rounding the plain version takes after each op
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// 8 consecutive elements as floats (16-byte aligned source)
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 floats rounded to T into 16-byte-aligned memory (16 bytes, or 32 in fp32)
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  alignas(16) __nv_bfloat162 h2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h2);
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
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

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ============================================================ normalize pass

// One warp a row: z = LN(h) * scale + bias (+ pe[f]) with fp32 statistics,
// or z = x * gn_a[b, f] + gn_b[b, f]; a rounding to T after every op, in the
// plain version's order. The row is read in 16-byte units (twice for LN, the
// second time mostly from L1).
template <typename T>
__global__ void __launch_bounds__(kThreads) motion_normalize_kernel(const NormArgs a) {
  const long long m = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (m >= a.M) return;
  const int lane = threadIdx.x % 32;
  const T* row = static_cast<const T*>(a.h) + m * a.C;
  T* out = static_cast<T*>(a.z) + m * a.C;
  const long long sample = m / a.N;  // b*F + f
  if (a.mode == NORM_GN) {
    const T* ga = static_cast<const T*>(a.pa) + sample * a.C;
    const T* gb = static_cast<const T*>(a.pb) + sample * a.C;
    for (int k = lane * 8; k < a.C; k += 32 * 8) {
      float v[8], av[8], bv[8];
      load8(row + k, v);
      load8(ga + k, av);
      load8(gb + k, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = rnd<T>(__fmul_rn(v[i], av[i]));
        v[i] = rnd<T>(__fadd_rn(v[i], bv[i]));
      }
      store8(out + k, v);
    }
    return;
  }
  float s = 0.f, s2 = 0.f;
  for (int k = lane * 8; k < a.C; k += 32 * 8) {
    float v[8];
    load8(row + k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      s2 += v[i] * v[i];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s / (float)a.C;
  const float var = fmaxf(s2 / (float)a.C - mean * mean, 0.f);
  const float inv = rsqrtf(var + 1e-5f);
  const float ra = rnd<T>(inv), rb = rnd<T>(-mean * inv);
  const T* sc = static_cast<const T*>(a.pa);
  const T* bi = static_cast<const T*>(a.pb);
  const T* pe = a.pe == nullptr ? nullptr
                                : static_cast<const T*>(a.pe) + (sample % a.F) * a.C;
  for (int k = lane * 8; k < a.C; k += 32 * 8) {
    float v[8], scv[8], biv[8], pev[8];
    load8(row + k, v);
    load8(sc + k, scv);
    load8(bi + k, biv);
    if (pe != nullptr) load8(pe + k, pev);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float z = rnd<T>(__fmul_rn(v[i], ra));
      z = rnd<T>(__fadd_rn(z, rb));
      z = rnd<T>(__fmul_rn(z, scv[i]));
      z = rnd<T>(__fadd_rn(z, biv[i]));
      if (pe != nullptr) z = rnd<T>(__fadd_rn(z, pev[i]));
      v[i] = z;
    }
    store8(out + k, v);
  }
}

// ============================================================ GEMM epilogue

// The block's (BM_ x BN) fp32 products, in shared memory at pitch LDC, out
// to device memory in 16-byte units of T (32 bytes for fp32), masked at the
// ragged M and Nw edges.
template <typename T, int BM_>
__device__ __forceinline__ void epilogue(const Gemm& g, const float* sC, int m0, int n0) {
  T* out = static_cast<T*>(g.out);
  if (g.epi == EPI_GEGLU) {
    // tile columns [0, 80) are value rows n0/2 + c of W1, [80, 160) their gates
    constexpr int kUnits = GEGLU_GROUP / 8;
    for (int idx = threadIdx.x; idx < BM_ * kUnits; idx += kThreads) {
      const int r = idx / kUnits, c = (idx % kUnits) * 8;
      const int m = m0 + r, j = n0 / 2 + c;
      if (m >= g.M || j >= g.ldo) continue;
      float pv[8], pg[8], bv[8], bg[8], o[8];
      load8(sC + r * LDC + c, pv);
      load8(sC + r * LDC + c + GEGLU_GROUP, pg);
      load8(g.bias + n0 + c, bv);
      load8(g.bias + n0 + c + GEGLU_GROUP, bg);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float val = rnd<T>(pv[i] + bv[i]);
        const float gate = rnd<T>(pg[i] + bg[i]);
        const float gl = rnd<T>(0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
        o[i] = val * gl;
      }
      store8(out + (size_t)m * g.ldo + j, o);
    }
    return;
  }
  constexpr int kUnits = BN / 8;
  const T* res = static_cast<const T*>(g.res);
  for (int idx = threadIdx.x; idx < BM_ * kUnits; idx += kThreads) {
    const int r = idx / kUnits, c = (idx % kUnits) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= g.M || n >= g.Nw) continue;
    float v[8];
    load8(sC + r * LDC + c, v);
    if (g.epi == EPI_QKV) {
      if (n < g.split)
        store8(out + (size_t)m * g.ldo + n, v);
      else
        store8(g.out32 + (size_t)m * (g.Nw - g.split) + n - g.split, v);
      continue;
    }
    float bv[8];
    load8(g.bias + n, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += bv[i];
    if (g.epi == EPI_BIAS_RES) {
      float rv[8];
      load8(res + (size_t)m * g.ldo + n, rv);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += rv[i];
    }
    store8(out + (size_t)m * g.ldo + n, v);
  }
}

// ============================================================ bf16 GEMM

// Byte offset of 16-byte unit u of staged row `row`, the unit XORed with the
// row's low 3 bits: the 8 rows of an ldmatrix 8x8 matrix (8 consecutive rows
// at one unit) and the 8 units of a row each fall in 8 different bank groups.
__host__ __device__ constexpr int swz(int row, int u) {
  return row * kRowBytes + ((u ^ (row & 7)) << 4);
}

// Start the copies of k-tile [k0, k0 + BK) of A's rows m0 .. m0 + BM_ and W's
// rows n0 .. n0 + BN into the stage at `stage`: thread t copies unit t & 7 of
// staged rows (t >> 3) + 32 i (A's rows first, then W's; the swizzle key,
// the row's low bits, is the same for all of them); zero outside the
// matrices.
template <int BM_>
__device__ __forceinline__ void load_stage(const Gemm& g, uint32_t stage, int m0, int n0,
                                           int k0) {
  const bf16* A = static_cast<const bf16*>(g.a);
  const bf16* W = static_cast<const bf16*>(g.w);
  const int row0 = threadIdx.x >> 3, u = threadIdx.x & 7, k = k0 + u * 8;
  const bool kin = k < g.K;
  const uint32_t dst = stage + swz(row0, u);
  const bf16* pa = A + (size_t)(m0 + row0) * g.K + k;
#pragma unroll
  for (int i = 0; i < BM_ / 32; ++i) {
    const bool valid = kin && m0 + row0 + 32 * i < g.M;
    cp_async16(dst + i * 32 * kRowBytes, valid ? pa + (size_t)i * 32 * g.K : A, valid);
  }
  const bf16* pw = W + (size_t)(n0 + row0) * g.K + k;
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const bool valid = kin && n0 + row0 + 32 * i < g.Nw;
    cp_async16(dst + (BM_ + 32 * i) * kRowBytes, valid ? pw + (size_t)i * 32 * g.K : W, valid);
  }
}

// The A and B fragments of k16 step ks of the stage at `stage`, by
// ldmatrix.x4 from this lane's offsets (step ks XORs (ks << 5)).
template <int MT>
__device__ __forceinline__ void load_frags(uint32_t stage, int ks, const uint32_t (&a_off)[MT],
                                           uint32_t b_off, uint32_t (&af)[MT][4],
                                           uint32_t (&bfr)[kPairs][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], stage + (a_off[mt] ^ (ks << 5)));
#pragma unroll
  for (int j = 0; j < kPairs; ++j)
    ldmatrix_x4(bfr[j], stage + ((b_off + j * 16 * kRowBytes) ^ (ks << 5)));
}

// Block x takes column tile x % ny and row tile x / ny (ny column tiles):
// the blocks that read one row tile of A run together, so A comes from
// device memory about once and from L2 for the other column tiles.
// Warp (wm, wn) owns rows wm * 16 MT .. + 16 MT and columns wn * 80 .. + 80
// of the block's tile, as MT x 10 m16n8 fp32 accumulators. 64-row tiles run
// two blocks an SM; 128-row tiles one (their 80 accumulators and two sets of
// fragments a thread need more than the 128 registers two blocks leave).
template <int MT>
__global__ void __launch_bounds__(kThreads, 3 - MT) motion_gemm_bf16_kernel(const Gemm g) {
  using Tl = Tile<MT>;
  constexpr int BM_ = Tl::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const int ny = (g.Nw + BN - 1) / BN;
  const int m0 = (blockIdx.x / ny) * BM_, n0 = (blockIdx.x % ny) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int ktiles = (g.K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < ktiles) load_stage<BM_>(g, ring + s * Tl::kStageBytes, m0, n0, s * BK);
    cp_async_commit();
  }

  // ldmatrix lane offsets at k16 step 0; step ks XORs (ks << 5), because the
  // swizzled unit of 2 ks + hi is (hi ^ key) ^ 2 ks. A: row (lane & 15), unit
  // hi = lane >> 4 (matrices: rows 0-7 | 8-15 at k 0-7, then at k 8-15). B
  // (W's rows, the col operand): row (lane & 7) + 8 (lane >> 4), unit
  // hi = (lane >> 3) & 1 (matrices: n 0-7 at k 0-7 | 8-15, then n 8-15).
  const int key = lane & 7;
  uint32_t a_off[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    a_off[mt] = (wm * 16 * MT + mt * 16 + (lane & 15)) * kRowBytes + (((lane >> 4) ^ key) << 4);
  const uint32_t b_off = (BM_ + wn * kWarpCols + (lane & 7) + ((lane >> 4) << 3)) * kRowBytes +
                         ((((lane >> 3) & 1) ^ key) << 4);

  float acc[MT][2 * kPairs][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kPairs; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // fragments double-buffered: step ks + 1's are read while step ks's
  // products run (the asm is volatile, so the order written is the order run)
  uint32_t af[2][MT][4], bfr[2][kPairs][4];
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kRing - 2>();  // k-tile kt has landed (this thread's copies)
    __syncthreads();             // ... everyone's, and k-tile kt - 1's stage is free
    const uint32_t stage = ring + (kt % kRing) * Tl::kStageBytes;
    load_frags<MT>(stage, 0, a_off, b_off, af[0], bfr[0]);
    const int next = kt + kRing - 1;
    if (next < ktiles)
      load_stage<BM_>(g, ring + (next % kRing) * Tl::kStageBytes, m0, n0, next * BK);
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int cur = ks & 1;
      if (ks + 1 < BK / 16) load_frags<MT>(stage, ks + 1, a_off, b_off, af[cur ^ 1], bfr[cur ^ 1]);
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * j], af[cur][mt], bfr[cur][j][0], bfr[cur][j][1]);
          mma_bf16(acc[mt][2 * j + 1], af[cur][mt], bfr[cur][j][2], bfr[cur][j][3]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the product tile overwrites the ring

  float* sC = reinterpret_cast<float*>(smem);
  const int gr = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = wm * 16 * MT + mt * 16 + gr;
#pragma unroll
    for (int nt = 0; nt < 2 * kPairs; ++nt) {
      const int c = wn * kWarpCols + nt * 8 + 2 * tg;
      *reinterpret_cast<float2*>(sC + r * LDC + c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(sC + (r + 8) * LDC + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  epilogue<bf16, BM_>(g, sC, m0, n0);
}

// ============================================================ fp32 GEMM

// 128 x 160 tiles, 32-deep stages through shared memory, thread (ty, tx)
// owning rows ty + 16 i and columns tx + 16 j as FMAs; no pipelining.
__global__ void __launch_bounds__(kThreads) motion_gemm_f32_kernel(const Gemm g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);
  float* sW = sA + BM32 * LDF;
  const float* A = static_cast<const float*>(g.a);
  const float* W = static_cast<const float*>(g.w);
  const int m0 = blockIdx.x * BM32, n0 = blockIdx.y * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][BN / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += BK32) {
    __syncthreads();
    for (int task = threadIdx.x; task < (BM32 + BN) * (BK32 / 4); task += kThreads) {
      const int row = task / (BK32 / 4), kc = (task % (BK32 / 4)) * 4, k = k0 + kc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float* dst;
      if (row < BM32) {
        const int m = m0 + row;
        if (m < g.M && k < g.K) v = *reinterpret_cast<const float4*>(A + (size_t)m * g.K + k);
        dst = sA + row * LDF + kc;
      } else {
        const int n = n0 + row - BM32;
        if (n < g.Nw && k < g.K) v = *reinterpret_cast<const float4*>(W + (size_t)n * g.K + k);
        dst = sW + (row - BM32) * LDF + kc;
      }
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK32; ++k) {
      float av[8], bv[BN / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = sA[(ty + 16 * i) * LDF + k];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) bv[j] = sW[(tx + 16 * j) * LDF + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the product tile overwrites the staging
  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) sC[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
  epilogue<float, BM32>(g, sC, m0, n0);
}

// ============================================================ frame attention

// Positions n0 .. n0 + np of sample b at heads h0 .. h0 + HG (the group's
// CW = HG * D columns of q, k, v and the output). q | k of the F frames are
// staged as (F, P) rows of [q | k] at pitch 2 CW + one 16-byte unit, v as
// (F, P, CW) fp32 rows after them (its copies land while the logits are
// computed), then the probabilities (P, HG, F, F + 1). A warp copies a row,
// its lanes 16 bytes each. One thread computes a row (p, h, f) of F logits
// in registers, q's 8-element chunk converted once for all F key frames, and
// its softmax in fp32; probabilities rounded to T; P V in fp32, a thread
// taking 8 columns of kFQ query frames so that each v chunk it reads from
// shared memory serves kFQ outputs; the output rounded to T and stored 16
// bytes a thread. kF: F rounded up to 8, 16 or 32 (the logits' registers).
constexpr int kFQ = 4;

template <typename T, int kF>
__global__ void __launch_bounds__(kThreads) motion_frame_attention_kernel(const Attn a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kU = 16 / sizeof(T);  // elements a 16-byte unit
  const int CW = a.HG * a.D;
  const int lq = 2 * CW + kU;
  const T* sqk = reinterpret_cast<const T*>(smem);
  const float* sv = reinterpret_cast<const float*>(smem + a.v_offset);
  float* sp = reinterpret_cast<float*>(smem + a.p_offset);
  const int group = blockIdx.x % a.groups;
  const int tile = (blockIdx.x / a.groups) % a.tiles;
  const long long b = blockIdx.x / a.groups / a.tiles;
  const int n0 = tile * a.P, np = min(a.P, a.N - n0);
  const int c0 = group * CW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(smem);
  const T* qk = static_cast<const T*>(a.qk);
  const long long row0 = b * a.F * a.N + n0;  // frame f, position p: row0 + f N + p

  // q | k, then v: at frame f the positions are np consecutive rows
  const int half_units = CW / kU;
  for (int r = warp; r < a.F * np; r += kThreads / 32) {
    const int f = r / np, p = r - f * np;
    const T* src = qk + (row0 + (long long)f * a.N + p) * 2 * a.C + c0;
    const uint32_t dst = base + (f * a.P + p) * lq * (int)sizeof(T);
    for (int u = lane; u < 2 * half_units; u += 32) {
      const int half = u >= half_units, e = (u - half * half_units) * kU;
      cp_async16(dst + (half * CW + e) * (int)sizeof(T), src + half * a.C + e, true);
    }
  }
  cp_async_commit();
  for (int r = warp; r < a.F * np; r += kThreads / 32) {
    const int f = r / np, p = r - f * np;
    const float* src = a.v + (row0 + (long long)f * a.N + p) * a.C + c0;
    const uint32_t dst = base + a.v_offset + (f * a.P + p) * CW * 4;
    for (int u = lane; u < CW / 4; u += 32) cp_async16(dst + u * 16, src + u * 4, true);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q | k have landed
  __syncthreads();

  // logits and softmax: thread r takes row (p, h, f), f fastest
  for (int r = threadIdx.x; r < np * a.HG * a.F; r += kThreads) {
    const int ph = r / a.F, f = r - ph * a.F;
    const int p = ph / a.HG, h = ph - p * a.HG;
    const T* q = sqk + (f * a.P + p) * lq + h * a.D;
    const T* k = sqk + p * lq + CW + h * a.D;  // key frame g at + g * P * lq
    const int kstride = a.P * lq;
    float s[kF];
#pragma unroll
    for (int g = 0; g < kF; ++g) s[g] = 0.f;
    if (sizeof(T) == 2 && a.D % 8 == 0) {
      for (int d = 0; d < a.D; d += 8) {
        float qv[8];
        load8(reinterpret_cast<const bf16*>(q + d), qv);
#pragma unroll
        for (int g = 0; g < kF; ++g) {
          if (g < a.F) {
            float kv[8];
            load8(reinterpret_cast<const bf16*>(k + g * kstride + d), kv);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[g] = fmaf(qv[e], kv[e], s[g]);
          }
        }
      }
    } else {
      for (int d = 0; d < a.D; ++d) {
        const float qd = to_f(q[d]);
#pragma unroll
        for (int g = 0; g < kF; ++g)
          if (g < a.F) s[g] = fmaf(qd, to_f(k[g * kstride + d]), s[g]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < kF; ++g)
      if (g < a.F) {
        s[g] *= a.scale;
        mx = fmaxf(mx, s[g]);
      }
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < kF; ++g)
      if (g < a.F) {
        s[g] = expf(s[g] - mx);
        sum += s[g];
      }
    float* pr = sp + r * (a.F + 1);
#pragma unroll
    for (int g = 0; g < kF; ++g)
      if (g < a.F) pr[g] = rnd<T>(s[g] / sum);
  }
  cp_async_wait<0>();  // v has landed
  __syncthreads();

  // P V: task (kFQ query frames, p, 8 output columns), the columns
  // fastest; each v chunk read from shared memory serves the kFQ frames
  T* out = static_cast<T*>(a.out);
  const int units = CW / 8, fgroups = (a.F + kFQ - 1) / kFQ;
  const int head_stride = a.F * (a.F + 1);  // between heads in the probabilities
  for (int i = threadIdx.x; i < fgroups * np * units; i += kThreads) {
    const int r = i / units, c = (i - r * units) * 8;
    const int fg = r / np, p = r - fg * np, f0 = fg * kFQ;
    const float* vrow = sv + p * CW + c;  // key frame g at + g * P * CW
    // query frame f0 + j at head h: + j (F + 1) + h head_stride
    const float* prow = sp + (p * a.HG * a.F + f0) * (a.F + 1);
    const bool one_head = c / a.D == (c + 7) / a.D;
    float o[kFQ][8];
#pragma unroll
    for (int j = 0; j < kFQ; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[j][e] = 0.f;
    for (int g = 0; g < a.F; ++g) {
      float v8[8];
      load8(vrow + g * a.P * CW, v8);
#pragma unroll
      for (int j = 0; j < kFQ; ++j) {
        if (f0 + j >= a.F) continue;
        const float* pj = prow + j * (a.F + 1) + g;
        if (one_head) {
          const float w = pj[(c / a.D) * head_stride];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[j][e] = fmaf(w, v8[e], o[j][e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[j][e] = fmaf(pj[((c + e) / a.D) * head_stride], v8[e], o[j][e]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFQ; ++j)
      if (f0 + j < a.F) store8(out + (row0 + (long long)(f0 + j) * a.N + p) * a.C + c0 + c, o[j]);
  }
}

// The attention's plan, for `item`-byte elements: HG heads a block, the most
// that divide H, give the group a multiple of 8 columns (whole 16-byte units
// and 8-column P V tasks) and fit one position in kAttnBudget (else in
// kSmemLimit); P positions a block, as many as fit kAttnBudget (at least 1,
// at most N). False when nothing fits. Exported as `motion_attention_plan`.
struct AttnPlan {
  int HG, P, v_offset, p_offset, smem;
};

bool attention_plan(int F, int C, int H, int N, int item, AttnPlan* plan) {
  const int D = C / H;
  for (const long long limit : {(long long)kAttnBudget, (long long)kSmemLimit}) {
    for (int hg = H; hg >= 1; --hg) {
      if (H % hg != 0 || (hg * D) % 8 != 0) continue;
      const long long qk = (long long)F * (2LL * hg * D * item + 16);
      const long long v = 4LL * F * hg * D;
      const long long per = qk + v + 4LL * hg * F * (F + 1);
      if (per > limit) continue;
      long long P = kAttnBudget / per;
      P = P < 1 ? 1 : (P > N ? N : P);
      plan->HG = hg;
      plan->P = (int)P;
      plan->v_offset = (int)(P * qk);
      plan->p_offset = (int)(P * (qk + v));
      plan->smem = (int)(P * per);
      return true;
    }
  }
  return false;
}

template <typename T>
cudaError_t launch_attention(const Attn& a, int smem, long long blocks, cudaStream_t stream) {
  auto kernel = a.F <= 8 ? motion_frame_attention_kernel<T, 8>
                         : (a.F <= 16 ? motion_frame_attention_kernel<T, 16>
                                      : motion_frame_attention_kernel<T, 32>);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaSuccess;
}

// ============================================================ the chain

// Indices into the pointer table of motion_module_fwd (the wrapper's order).
enum Ptr {
  P_X, P_GN_A, P_GN_B, P_PE, P_WIN, P_BIN,
  P_LS0, P_LB0, P_WQKV0, P_WO0, P_OB0,
  P_LS1, P_LB1, P_WQKV1, P_WO1, P_OB1,
  P_LSF, P_LBF, P_W1, P_B1, P_W2, P_B2, P_WOUT, P_BOUT,
  P_H, P_Z, P_QK, P_V, P_ATTN, P_GG, P_OUT, P_COUNT
};
constexpr int kLaunches = 14;  // launches of one module, in the order of `run`

template <typename T> cudaError_t allow_gemm_smem();
template <> cudaError_t allow_gemm_smem<float>() {
  return allow_smem(motion_gemm_f32_kernel, kSmemF32);
}
template <> cudaError_t allow_gemm_smem<bf16>() {
  const cudaError_t err = allow_smem(motion_gemm_bf16_kernel<1>, Tile<1>::kSmem);
  return err != cudaSuccess ? err : allow_smem(motion_gemm_bf16_kernel<2>, Tile<2>::kSmem);
}

template <typename T> void launch_gemm(const Gemm& g, int sms, cudaStream_t stream);
template <> void launch_gemm<float>(const Gemm& g, int, cudaStream_t stream) {
  const dim3 grid((unsigned)((g.M + BM32 - 1) / BM32), (unsigned)((g.Nw + BN - 1) / BN));
  motion_gemm_f32_kernel<<<grid, kThreads, kSmemF32, stream>>>(g);
}
// 128-row tiles when they give every SM a block, else 64-row tiles
template <> void launch_gemm<bf16>(const Gemm& g, int sms, cudaStream_t stream) {
  const long long ny = (g.Nw + BN - 1) / BN;
  const long long blocks128 = (g.M + 127) / 128 * ny;
  if (blocks128 >= sms) {
    motion_gemm_bf16_kernel<2><<<(unsigned)blocks128, kThreads, Tile<2>::kSmem, stream>>>(g);
  } else {
    const unsigned blocks = (unsigned)((g.M + 63) / 64 * ny);
    motion_gemm_bf16_kernel<1><<<blocks, kThreads, Tile<1>::kSmem, stream>>>(g);
  }
}

template <typename T>
cudaError_t run(const void* const* t, int B, int F, int N, int C, int H, cudaStream_t stream,
                cudaEvent_t* ev) {
  AttnPlan plan;
  if (!attention_plan(F, C, H, N, (int)sizeof(T), &plan)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_gemm_smem<T>();
  if (err != cudaSuccess) return err;

  const long long M = (long long)B * F * N;
  const int inner = 4 * C;
  const int w1_rows = (inner + GEGLU_GROUP - 1) / GEGLU_GROUP * BN;
  void* h = const_cast<void*>(t[P_H]);
  void* z = const_cast<void*>(t[P_Z]);
  int launched = 0;
  // after a launch: its error, and the launch's event when timed
  auto mark = [&]() -> cudaError_t {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || ev == nullptr) return e;
    return cudaEventRecord(ev[++launched], stream);
  };
  auto norm = [&](const void* src, int mode, const void* pa, const void* pb,
                  const void* pe) -> cudaError_t {
    const NormArgs a{src, z, pa, pb, pe, M, C, N, F, mode};
    const long long blocks = (M + kThreads / 32 - 1) / (kThreads / 32);
    motion_normalize_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
    return mark();
  };
  auto gemm = [&](const void* a, const void* w, const void* bias, const void* res, void* out,
                  void* out32, int K, int Nw, int ldo, int split, int epi) -> cudaError_t {
    const Gemm g{a, w, static_cast<const float*>(bias), res, out, static_cast<float*>(out32),
                 (int)M, K, Nw, ldo, split, epi};
    launch_gemm<T>(g, sms, stream);
    return mark();
  };
  auto attention = [&]() -> cudaError_t {
    const int tiles = (N + plan.P - 1) / plan.P;
    const Attn a{t[P_QK], static_cast<const float*>(t[P_V]), const_cast<void*>(t[P_ATTN]),
                 F, N, C, C / H, plan.HG, plan.P, H / plan.HG, tiles, plan.v_offset,
                 plan.p_offset, 1.f / sqrtf((float)(C / H))};
    const cudaError_t e =
        launch_attention<T>(a, plan.smem, (long long)B * tiles * (H / plan.HG), stream);
    return e != cudaSuccess ? e : mark();
  };

  if (ev != nullptr && (err = cudaEventRecord(ev[0], stream)) != cudaSuccess) return err;
  if ((err = norm(t[P_X], NORM_GN, t[P_GN_A], t[P_GN_B], nullptr)) != cudaSuccess) return err;
  if ((err = gemm(z, t[P_WIN], t[P_BIN], nullptr, h, nullptr, C, C, C, 0, EPI_BIAS)) !=
      cudaSuccess)
    return err;
  for (int blk = 0; blk < 2; ++blk) {
    const int o = blk * (P_LS1 - P_LS0);
    if ((err = norm(h, NORM_LN, t[P_LS0 + o], t[P_LB0 + o], t[P_PE])) != cudaSuccess) return err;
    err = gemm(z, t[P_WQKV0 + o], nullptr, nullptr, const_cast<void*>(t[P_QK]),
               const_cast<void*>(t[P_V]), C, 3 * C, 2 * C, 2 * C, EPI_QKV);
    if (err != cudaSuccess || (err = attention()) != cudaSuccess) return err;
    // out-projection + residual, in place on h (each element is read and
    // written by the same thread)
    err = gemm(t[P_ATTN], t[P_WO0 + o], t[P_OB0 + o], h, h, nullptr, C, C, C, 0, EPI_BIAS_RES);
    if (err != cudaSuccess) return err;
  }
  if ((err = norm(h, NORM_LN, t[P_LSF], t[P_LBF], nullptr)) != cudaSuccess) return err;
  err = gemm(z, t[P_W1], t[P_B1], nullptr, const_cast<void*>(t[P_GG]), nullptr, C, w1_rows, inner,
             0, EPI_GEGLU);
  if (err != cudaSuccess) return err;
  err = gemm(t[P_GG], t[P_W2], t[P_B2], h, h, nullptr, inner, C, C, 0, EPI_BIAS_RES);
  if (err != cudaSuccess) return err;
  return gemm(h, t[P_WOUT], t[P_BOUT], nullptr, const_cast<void*>(t[P_OUT]), nullptr, C, C, C, 0,
              EPI_BIAS);
}

int check(const void* const* t, int B, int F, int N, int C, int H) {
  if (B <= 0 || F <= 0 || N <= 0 || C <= 0 || H <= 0 || C % 8 != 0 || C % H != 0 ||
      F > kMaxFrames || (long long)B * F * N > 2147483647LL || (long long)B * N > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < P_COUNT; ++i) {
    if (i != P_PE && t[i] == nullptr) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(t[i]) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  }
  return 0;
}

int dispatch(const void* const* t, int B, int F, int N, int C, int H, int dtype, void* stream,
             cudaEvent_t* ev) {
  const int err = check(t, B, F, N, C, H);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(t, B, F, N, C, H, s, ev);
  if (dtype == 1) return (int)run<bf16>(t, B, F, N, C, H, s, ev);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// t: P_COUNT device pointers in the order of `Ptr` (pe may be null), each
// 16-byte aligned; dtype: 0 = float32, 1 = bfloat16. Launches the fourteen
// kernels of one module on `stream` and returns the first cudaError_t
// (cudaGetLastError after each launch), 0 on success.
int motion_module_fwd(const void* const* t, int B, int F, int N, int C, int H, int dtype,
                      void* stream) {
  return dispatch(t, B, F, N, C, H, dtype, stream, nullptr);
}

// The same chain `reps` times, with an event recorded before the first
// launch and after each launch; ms[i] gets launch i's mean time over the
// reps (CUDA events); n_ms must be the chain's kLaunches. Synchronizes the
// stream. For measurement only.
int motion_module_fwd_timed(const void* const* t, int B, int F, int N, int C, int H, int dtype,
                            void* stream, float* ms, int n_ms, int reps) {
  if (n_ms != kLaunches || reps <= 0) return (int)cudaErrorInvalidValue;
  cudaEvent_t ev[kLaunches + 1];
  int made = 0;
  cudaError_t err = cudaSuccess;
  while (made <= kLaunches && (err = cudaEventCreate(&ev[made])) == cudaSuccess) ++made;
  for (int i = 0; i < kLaunches; ++i) ms[i] = 0.f;
  for (int r = 0; r < reps && err == cudaSuccess; ++r) {
    err = (cudaError_t)dispatch(t, B, F, N, C, H, dtype, stream, ev);
    if (err == cudaSuccess) err = cudaEventSynchronize(ev[kLaunches]);
    for (int i = 0; i < kLaunches && err == cudaSuccess; ++i) {
      float e = 0.f;
      err = cudaEventElapsedTime(&e, ev[i], ev[i + 1]);
      ms[i] += e / reps;
    }
  }
  for (int i = 0; i < made; ++i) cudaEventDestroy(ev[i]);
  return (int)err;
}

// The frame attention's plan for F frames, C channels in H heads, N
// positions and `item`-byte elements: out[0..2] = heads a block, positions
// a block, shared memory bytes; returns 1, or 0 when one position does not
// fit shared memory (the chain then refuses the shape).
int motion_attention_plan(int F, int C, int H, int N, int item, int* out) {
  AttnPlan plan;
  if (F <= 0 || C <= 0 || H <= 0 || N <= 0 || C % H != 0 ||
      !attention_plan(F, C, H, N, item, &plan))
    return 0;
  out[0] = plan.HG;
  out[1] = plan.P;
  out[2] = plan.smem;
  return 1;
}

const char* motion_module_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
