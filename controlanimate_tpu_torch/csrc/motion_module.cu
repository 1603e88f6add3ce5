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
// rounded to the input dtype; the GELU by erff in fp32 (the TPU kernel uses a
// polynomial only because Mosaic has no erf).
//
// The TPU kernel keeps every weight (22 C^2 values) and a block of positions
// resident in VMEM. On the H100 that is 4.5 MB (C = 320) to 72 MB (C = 1280)
// of bf16 weights against 227 KB of shared memory, so the weights stream:
// the module is a chain of ten launches on the caller's stream, one tiled GEMM
// kernel with fused prologues (GroupNorm affine, or LayerNorm with the row
// statistics computed by the block, + the PE row) and epilogues (bias,
// residual, the q/k | v split, the GEGLU gate), and one frame-attention kernel:
//   proj_in, 2 x (QKV, attention, out-projection + residual), W1 + GEGLU,
//   W2 + residual, proj_out.
// Bound on the H100: 44 C^2 + 8 F C FLOPs a token at 989 TFLOP/s (bf16) is
// above the bytes it must move (2 C elements a token and the weights) at every
// main-path shape, so the module is compute-bound; it spends its time in the
// GEMMs. bf16 GEMMs run on the tensor cores as mma.sync m16n8k16 (fp32
// accumulate) out of shared memory, 128 x 128 output tiles, 8 warps of 32 x 64;
// fp32 GEMMs as FMAs on the CUDA cores (no TF32). This first version has no
// cp.async / TMA pipelining and no wgmma, so loads and products do not
// overlap, and the intermediates (h, q|k, v, attn, the GEGLU output) pass
// through device memory between launches.
//
// Layouts: x (M, C) contiguous in the dtype; gn_a, gn_b (B*F, C) dtype; pe
// (F, C) dtype or null; weights (out, in) contiguous in the dtype (nn.Linear's
// layout; q, k, v concatenated to (3C, C); W1's rows re-laid in groups of 64
// as [64 value rows | 64 matching gate rows], zero-padded to whole groups);
// biases fp32 (W1's in the same row order); LayerNorm scale / bias (C,) dtype.
// C must be a multiple of 8 (16-byte rows), F at most 32 (one warp per softmax
// row); N and M are free (ragged tiles are masked).
//
// Interface: plain C functions (no PyTorch headers), built with one nvcc call
// and loaded with ctypes by controlanimate_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // GEMM rows (tokens) per block
constexpr int BN = 128;          // GEMM output columns per block
constexpr int BK = 32;           // reduction depth per stage
constexpr int kThreads = 256;    // 8 warps
constexpr int LDH = BK + 8;      // bf16 staging pitch: 40 halves = 20 words, conflict-free fragments
constexpr int LDF = BK + 1;      // fp32 staging pitch (odd)
constexpr int LDC = BN + 4;      // fp32 output tile pitch
constexpr int GEGLU_GROUP = BN / 2;  // value rows (then as many gate rows) per W1 row group
constexpr int kAttnThreads = 128;
constexpr int kMaxFrames = 32;

constexpr size_t kStageBf16 = sizeof(__nv_bfloat16) * (size_t)(BM + BN) * LDH;
constexpr size_t kStageF32 = sizeof(float) * (size_t)(BM + BN) * LDF;
constexpr size_t kTileBytes = sizeof(float) * (size_t)BM * LDC;
static_assert(kTileBytes >= kStageBf16 && kTileBytes >= kStageF32, "tile aliases the staging");
constexpr size_t kGemmSmem = kTileBytes + 2 * BM * sizeof(float);  // + LayerNorm row terms

enum Prologue { PRO_NONE = 0, PRO_GN = 1, PRO_LN = 2 };
enum Epilogue { EPI_BIAS = 0, EPI_BIAS_RES = 1, EPI_QKV = 2, EPI_GEGLU = 3 };

struct Gemm {
  const void* a;      // (M, K) dtype
  const void* w;      // (Nw, K) dtype
  const float* bias;  // (Nw,) or null
  const void* res;    // (M, ldo) dtype or null; may alias out
  void* out;          // (M, ldo) dtype
  float* out32;       // EPI_QKV: columns >= split, (M, Nw - split) fp32
  const void* pa;     // GN: (B*F, K) a; LN: (K,) scale
  const void* pb;     // GN: (B*F, K) b; LN: (K,) bias
  const void* pe;     // LN: (F, K) or null
  int M, K, Nw, ldo, split, N, F, pro, epi;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back: the rounding the plain version takes after each op
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// 8 consecutive elements as floats (16-byte aligned source)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
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

// 8 floats into shared memory as T at a staging row (pitch LDH / LDF)
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  alignas(16) __nv_bfloat162 h2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h2);
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = v[i];
}

template <typename T> struct Pitch;
template <> struct Pitch<__nv_bfloat16> { static constexpr int value = LDH; };
template <> struct Pitch<float> { static constexpr int value = LDF; };

// LayerNorm row terms of rows m0 .. m0 + BM: ra = inv, rb = -mean * inv, each
// rounded to T (fp32 statistics over the K channels of the row).
template <typename T>
__device__ void row_stats(const Gemm& g, int m0, float* ra, float* rb) {
  const T* A = static_cast<const T*>(g.a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int m = m0 + r;
    float s = 0.f, s2 = 0.f;
    if (m < g.M) {
      const T* row = A + (size_t)m * g.K;
      for (int k = lane * 8; k < g.K; k += 32 * 8) {
        float v[8];
        load8(row + k, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s += v[i];
          s2 += v[i] * v[i];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const float mean = s / (float)g.K;
      const float var = fmaxf(s2 / (float)g.K - mean * mean, 0.f);
      const float inv = rsqrtf(var + 1e-5f);
      ra[r] = rnd<T>(inv);
      rb[r] = rnd<T>(-mean * inv);
    }
  }
}

// Stage A[m0 .. m0+BM, k0 .. k0+BK) through the prologue and W[n0 .., k0 ..)
// into shared memory, zero outside the matrices.
template <typename T>
__device__ __forceinline__ void stage(const Gemm& g, T* sA, T* sW, int m0, int n0, int k0,
                                      const float* ra, const float* rb) {
  constexpr int LD = Pitch<T>::value;
  constexpr int CHUNKS = BK / 8;  // 8-element chunks per staged row
  const T* A = static_cast<const T*>(g.a);
  const T* W = static_cast<const T*>(g.w);
  for (int task = threadIdx.x; task < (BM + BN) * CHUNKS; task += kThreads) {
    const bool is_a = task < BM * CHUNKS;
    const int t = is_a ? task : task - BM * CHUNKS;
    const int r = t / CHUNKS;
    const int kc = (t % CHUNKS) * 8;
    const int k = k0 + kc;
    float v[8];
    if (is_a) {
      const int m = m0 + r;
      if (m < g.M && k < g.K) {
        load8(A + (size_t)m * g.K + k, v);
        if (g.pro == PRO_GN) {
          const size_t s = (size_t)(m / g.N) * g.K + k;  // sample b*F + f
          float a[8], b[8];
          load8(static_cast<const T*>(g.pa) + s, a);
          load8(static_cast<const T*>(g.pb) + s, b);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[i] = rnd<T>(__fmul_rn(v[i], a[i]));
            v[i] = rnd<T>(__fadd_rn(v[i], b[i]));
          }
        } else if (g.pro == PRO_LN) {
          float sc[8], bi[8], pe[8];
          load8(static_cast<const T*>(g.pa) + k, sc);
          load8(static_cast<const T*>(g.pb) + k, bi);
          if (g.pe != nullptr)
            load8(static_cast<const T*>(g.pe) + (size_t)((m / g.N) % g.F) * g.K + k, pe);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float z = rnd<T>(__fmul_rn(v[i], ra[r]));
            z = rnd<T>(__fadd_rn(z, rb[r]));
            z = rnd<T>(__fmul_rn(z, sc[i]));
            z = rnd<T>(__fadd_rn(z, bi[i]));
            if (g.pe != nullptr) z = rnd<T>(__fadd_rn(z, pe[i]));
            v[i] = z;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      store8(sA + r * LD + kc, v);
    } else {
      const int n = n0 + r;
      if (n < g.Nw && k < g.K) {
        load8(W + (size_t)n * g.K + k, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      store8(sW + r * LD + kc, v);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The (BM x BN) fp32 product tile of this block into sC (pitch LDC).
__device__ __forceinline__ void product_tile(const Gemm& g, __nv_bfloat16* smem, float* sC,
                                             int m0, int n0, const float* ra, const float* rb) {
  __nv_bfloat16* sA = smem;
  __nv_bfloat16* sW = smem + BM * LDH;
  const uint32_t* Aw = reinterpret_cast<const uint32_t*>(sA);
  const uint32_t* Ww = reinterpret_cast<const uint32_t*>(sW);
  constexpr int LDW = LDH / 2;  // pitch in 32-bit words
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3;   // rows wm*32 .. +32
  const int wn = warp >> 2;  // columns wn*64 .. +64
  const int gr = lane >> 2, tg = lane & 3;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    __syncthreads();
    stage<__nv_bfloat16>(g, sA, sW, m0, n0, k0, ra, rb);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK / 2; kw += 8) {  // two k16 steps, in words
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + gr;
        af[mt][0] = Aw[r * LDW + kw + tg];
        af[mt][1] = Aw[(r + 8) * LDW + kw + tg];
        af[mt][2] = Aw[r * LDW + kw + tg + 4];
        af[mt][3] = Aw[(r + 8) * LDW + kw + tg + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = wn * 64 + nt * 8 + gr;
        const uint32_t b0 = Ww[n * LDW + kw + tg], b1 = Ww[n * LDW + kw + tg + 4];
        mma_bf16(acc[0][nt], af[0], b0, b1);
        mma_bf16(acc[1][nt], af[1], b0, b1);
      }
    }
  }
  __syncthreads();  // the tile overwrites the staging buffers
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wm * 32 + mt * 16 + gr;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = wn * 64 + nt * 8 + 2 * tg;
      sC[r * LDC + c] = acc[mt][nt][0];
      sC[r * LDC + c + 1] = acc[mt][nt][1];
      sC[(r + 8) * LDC + c] = acc[mt][nt][2];
      sC[(r + 8) * LDC + c + 1] = acc[mt][nt][3];
    }
  }
}

__device__ __forceinline__ void product_tile(const Gemm& g, float* smem, float* sC, int m0,
                                             int n0, const float* ra, const float* rb) {
  float* sA = smem;
  float* sW = smem + BM * LDF;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // rows ty + 16 i, cols tx + 16 j
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    __syncthreads();
    stage<float>(g, sA, sW, m0, n0, k0, ra, rb);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = sA[(ty + 16 * i) * LDF + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sW[(tx + 16 * j) * LDF + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sC[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) motion_gemm_kernel(const Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sC = reinterpret_cast<float*>(smem_raw);
  float* ra = sC + BM * LDC;
  float* rb = ra + BM;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  if (g.pro == PRO_LN) {
    row_stats<T>(g, m0, ra, rb);
    __syncthreads();
  }
  product_tile(g, reinterpret_cast<T*>(smem_raw), sC, m0, n0, ra, rb);
  __syncthreads();

  T* out = static_cast<T*>(g.out);
  if (g.epi == EPI_GEGLU) {
    // tile columns [0, 64) are value rows n0/2 + c of W1, [64, 128) their gates
    for (int idx = threadIdx.x; idx < BM * GEGLU_GROUP; idx += kThreads) {
      const int r = idx / GEGLU_GROUP, c = idx % GEGLU_GROUP;
      const int m = m0 + r, j = n0 / 2 + c;
      if (m >= g.M || j >= g.ldo) continue;
      const float val = rnd<T>(sC[r * LDC + c] + g.bias[n0 + c]);
      const float gate = rnd<T>(sC[r * LDC + c + GEGLU_GROUP] + g.bias[n0 + c + GEGLU_GROUP]);
      const float gl = rnd<T>(0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
      out[(size_t)m * g.ldo + j] = from_f<T>(val * gl);
    }
    return;
  }
  const T* res = static_cast<const T*>(g.res);
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= g.M || n >= g.Nw) continue;
    const float acc = sC[r * LDC + c];
    if (g.epi == EPI_QKV) {
      if (n < g.split)
        out[(size_t)m * g.ldo + n] = from_f<T>(acc);
      else
        g.out32[(size_t)m * (g.Nw - g.split) + n - g.split] = acc;
      continue;
    }
    float v = acc + g.bias[n];
    if (g.epi == EPI_BIAS_RES) v += to_f(res[(size_t)m * g.ldo + n]);
    out[(size_t)m * g.ldo + n] = from_f<T>(v);
  }
}

// Frame attention for one (b, n) position and one head: q, k (input dtype,
// the q | k halves of a (M, 2C) buffer) and v (fp32, (M, C)) of the F frames
// at that position, softmax over key frames in fp32, probabilities rounded to
// T, output rounded to T into (M, C).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
motion_frame_attention_kernel(const T* qk, const float* v, T* out, int F, int N, int C, int D,
                              float scale) {
  extern __shared__ float sm[];
  const int DP = D + 1;  // odd pitch: a warp reading 32 frames' rows hits 32 banks
  const int FP = F + 1;
  float* sq = sm;
  float* sk = sq + F * DP;
  float* sv = sk + F * DP;
  float* sp = sv + F * DP;  // (F, FP) logits, then probabilities
  const int pos = blockIdx.x, head = blockIdx.y;
  const size_t b = pos / N, n = pos % N;
  const int col = head * D;

  for (int i = threadIdx.x; i < F * D; i += kAttnThreads) {
    const int f = i / D, d = i % D;
    const size_t row = (b * F + f) * N + n;
    sq[f * DP + d] = to_f(qk[row * 2 * C + col + d]);
    sk[f * DP + d] = to_f(qk[row * 2 * C + C + col + d]);
    sv[f * DP + d] = v[row * C + col + d];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < F * F; i += kAttnThreads) {
    const int f = i / F, g = i % F;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(sq[f * DP + d], sk[g * DP + d], s);
    sp[f * FP + g] = s * scale;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int f = warp; f < F; f += kAttnThreads / 32) {
    const float l = lane < F ? sp[f * FP + lane] : -INFINITY;
    float mx = l;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e = lane < F ? expf(l - mx) : 0.f;
    float sum = e;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane < F) sp[f * FP + lane] = rnd<T>(e / sum);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < F * D; i += kAttnThreads) {
    const int f = i / D, d = i % D;
    float o = 0.f;
    for (int g = 0; g < F; ++g) o = fmaf(sp[f * FP + g], sv[g * DP + d], o);
    out[((b * F + f) * N + n) * C + col + d] = from_f<T>(o);
  }
}

size_t attention_smem(int F, int D) {
  return sizeof(float) * ((size_t)3 * F * (D + 1) + (size_t)F * (F + 1));
}

// Indices into the pointer table of motion_module_fwd (the wrapper's order).
enum Ptr {
  P_X, P_GN_A, P_GN_B, P_PE, P_WIN, P_BIN,
  P_LS0, P_LB0, P_WQKV0, P_WO0, P_OB0,
  P_LS1, P_LB1, P_WQKV1, P_WO1, P_OB1,
  P_LSF, P_LBF, P_W1, P_B1, P_W2, P_B2, P_WOUT, P_BOUT,
  P_H, P_QK, P_V, P_ATTN, P_GG, P_OUT, P_COUNT
};

template <typename T>
cudaError_t run(const void* const* t, int B, int F, int N, int C, int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(motion_gemm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  const int D = C / H;
  const size_t attn_smem = attention_smem(F, D);
  err = cudaFuncSetAttribute(motion_frame_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)attn_smem);
  if (err != cudaSuccess) return err;

  const long long M = (long long)B * F * N;
  const int inner = 4 * C;
  const int w1_rows = (inner + GEGLU_GROUP - 1) / GEGLU_GROUP * BN;
  auto gemm = [&](const void* a, const void* w, const void* bias, const void* res, void* out,
                  void* out32, int pro, const void* pa, const void* pb, const void* pe, int K,
                  int Nw, int ldo, int split, int epi) -> cudaError_t {
    const Gemm g{a, w, static_cast<const float*>(bias), res, out, static_cast<float*>(out32),
                 pa, pb, pe, (int)M, K, Nw, ldo, split, N, F, pro, epi};
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Nw + BN - 1) / BN));
    motion_gemm_kernel<T><<<grid, kThreads, kGemmSmem, stream>>>(g);
    return cudaGetLastError();
  };

  // proj_in on the folded GroupNorm affine
  err = gemm(t[P_X], t[P_WIN], t[P_BIN], nullptr, const_cast<void*>(t[P_H]), nullptr, PRO_GN,
             t[P_GN_A], t[P_GN_B], nullptr, C, C, C, 0, EPI_BIAS);
  if (err != cudaSuccess) return err;
  void* h = const_cast<void*>(t[P_H]);
  for (int blk = 0; blk < 2; ++blk) {
    const int o = blk * (P_LS1 - P_LS0);
    err = gemm(h, t[P_WQKV0 + o], nullptr, nullptr, const_cast<void*>(t[P_QK]),
               const_cast<void*>(t[P_V]), PRO_LN, t[P_LS0 + o], t[P_LB0 + o], t[P_PE], C, 3 * C,
               2 * C, 2 * C, EPI_QKV);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((long long)B * N), (unsigned)H);
    motion_frame_attention_kernel<T><<<grid, kAttnThreads, attn_smem, stream>>>(
        static_cast<const T*>(t[P_QK]), static_cast<const float*>(t[P_V]),
        static_cast<T*>(const_cast<void*>(t[P_ATTN])), F, N, C, D, 1.f / sqrtf((float)D));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // out-projection + residual, in place on h (each element is read and
    // written by the same thread)
    err = gemm(t[P_ATTN], t[P_WO0 + o], t[P_OB0 + o], h, h, nullptr, PRO_NONE, nullptr, nullptr,
               nullptr, C, C, C, 0, EPI_BIAS_RES);
    if (err != cudaSuccess) return err;
  }
  err = gemm(h, t[P_W1], t[P_B1], nullptr, const_cast<void*>(t[P_GG]), nullptr, PRO_LN,
             t[P_LSF], t[P_LBF], nullptr, C, w1_rows, inner, 0, EPI_GEGLU);
  if (err != cudaSuccess) return err;
  err = gemm(t[P_GG], t[P_W2], t[P_B2], h, h, nullptr, PRO_NONE, nullptr, nullptr, nullptr, inner,
             C, C, 0, EPI_BIAS_RES);
  if (err != cudaSuccess) return err;
  return gemm(h, t[P_WOUT], t[P_BOUT], nullptr, const_cast<void*>(t[P_OUT]), nullptr, PRO_NONE,
              nullptr, nullptr, nullptr, C, C, C, 0, EPI_BIAS);
}

}  // namespace

extern "C" {

// t: P_COUNT device pointers in the order of `Ptr` (pe may be null); dtype:
// 0 = float32, 1 = bfloat16. Launches the ten kernels of one module on
// `stream` and returns the first cudaError_t (cudaGetLastError after each
// launch), 0 on success.
int motion_module_fwd(const void* const* t, int B, int F, int N, int C, int H, int dtype,
                      void* stream) {
  if (B <= 0 || F <= 0 || N <= 0 || C <= 0 || H <= 0 || C % 8 != 0 || C % H != 0 ||
      F > kMaxFrames || (long long)B * F * N > 2147483647LL || (long long)B * N > 2147483647LL ||
      H > 65535 || attention_smem(F, C / H) > 232448)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < P_COUNT; ++i)
    if (i != P_PE && t[i] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(t, B, F, N, C, H, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(t, B, F, N, C, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* motion_module_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
