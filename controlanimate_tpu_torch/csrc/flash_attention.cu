// Flash attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V, no mask.
//
// Replaces the TPU kernel controlanimate_tpu/ops/flash_attention.py
// `_attn_kernel` (called through `flash_attention`). It computes what that
// kernel computes, not its blocking: the TPU kernel keeps the whole K/V of one
// (batch, head) in VMEM and pads D to 128 lanes; here one thread block owns a
// tile of query rows of one (batch, head) and walks K/V in tiles staged
// through shared memory. Nothing of size Nq x Nk ever reaches device memory.
//
// Layout: q, k, v, o are (B, N, H, D) tensors read and written in place by
// their strides (the innermost dimension must be contiguous); no transpose or
// padding pass.
//
// Bound on the H100: 4*B*H*Nq*Nk*D FLOPs at 989 TFLOP/s (bf16 tensor cores)
// against 2*B*H*(Nq + Nk)*D elements moved at 3.35 TB/s. At the main path's
// shapes (B*F, Nq = Nk, H, D) that is, in ms: (16, 4096, 8, 40) 0.347,
// (16, 1024, 8, 80) 0.0434, (16, 256, 8, 160) 0.00543, (16, 4096, 1, 512)
// 0.556 and (8, 4096, 1, 512) 0.278, all by operations; (16, 64, 8, 160) is
// bound by its bytes (0.0031). So the products must run on the tensor cores
// and the loads must hide behind them. The depth annotators' ViTs (DPT and
// DPT-hybrid, fp32) run it at D = 64 over 577 tokens (a 24 x 24 grid and
// the class token), which is no multiple of any tile: the last K/V tile
// and the last query block are ragged on every launch. GLPN's efficient
// attention (fp32) runs it with fewer keys than queries (Nk = Nq / sr^2),
// at D = 64 at the published MiT-b4 widths and D = 32 at the b0 ones.
//
// bf16 (dtype 1), the main path. What the design does about that bound:
//   - Both products are mma.sync m16n8k16 bf16 with fp32 sums (D = 40 adds
//     one m16n8k8 step for the depth's last 8); fragments come from shared
//     memory by ldmatrix (.trans for V).
//   - Two passes over K. The first finds each row's exact max of S; the
//     second computes P = exp2(S * scale * log2(e) - max) and P V. So P is
//     rounded to bf16 against the row's final max, exactly where the TPU
//     kernel rounds it at every main-path shape (its one-pass branch: Nk <=
//     its 4096-key block), and where the plain version rounds it. An online
//     softmax (one pass, a running max and exp(m_old - m_new) rescales)
//     would save the first pass's QK^T, but rounds P against a running max
//     that changes until the row's largest score has been seen: those
//     roundings differ from the one-pass ones, and at the main path's 4096
//     keys the output then leaves the bf16 gate that holds this kernel to
//     the plain version (chip_smoke.py `k1_mismatch`).
//   - D <= 160 (`attn_bf16_rows_kernel`): each warp owns 32 (D = 32, 40, 64, 80) or
//     16 (D = 160) query rows, two m16 tiles or one. Its Q fragments stay in registers for both
//     passes; its S tile stays in registers, and the row max and sums run
//     there with quad shuffles (the 4 lanes that hold one row). The m16n8
//     accumulator layout of S is the A fragment layout of m16n8k16, so P is
//     rounded to bf16 in registers and fed straight into the PV product: P
//     never touches shared memory. Two m16 tiles a warp (D = 40, 64, 80) read
//     each K and V fragment from shared memory once for 32 rows, which
//     halves the ldmatrix traffic that bounds the small head dims.
//   - D = 512 (`attn_bf16_wide_kernel`): a warp cannot hold a 16 x 512 fp32
//     output (256 registers a lane), so D is split over the warps for PV.
//     8 warps share BQ = 64 query rows; warp w owns output columns
//     64w..64w+63 for all 64 rows (4 x 8 m16n8 tiles, 128 registers a lane).
//     Q (64 x 512) stays in shared memory; each warp computes a 16 x 16 piece
//     of the 64 x 32 S tile over the full depth, turns it into P and writes
//     that to one bf16 P tile in shared memory, from which every warp reads
//     all 64 rows as its A operand. BK = 32 keeps Q (66.5 KB) and two K/V
//     stages (133 KB) within 227 KB.
//   - K/V tiles are staged by 16-byte cp.async.cg into a ring of two stages
//     (`KVRing`), so tile t+1 loads while tile t is multiplied; the first
//     pass loads K only. Rows past Nk are zero-filled (src-size 0) and their
//     scores set to -inf before the row max; query rows past Nq are zero and
//     never stored.
//   - Shared rows have a pitch of an odd number of 16-byte units (40 bf16 as
//     they are, 32, 64, 80, 160 and 512 padded by 8), so the 8 rows of every ldmatrix
//     8x8 matrix fall in 8 different bank groups: ldmatrix is conflict-free.
//   - log2(e) is folded into the scale and the exponentials are exp2f of one
//     fmaf (S * scale * log2(e) - max). That differs from the plain version's
//     exp(S * scale - max) only by rounding.
//   - Rounding follows the TPU kernel: S in fp32, P rounded to bf16 before PV,
//     PV summed in fp32, the row sum taken over the unrounded fp32 P, and the
//     output divided by it once at the end and stored in bf16.
//   16-byte cp.async needs 16-byte-aligned base pointers and (B, N, H)
//   strides; the wrapper (ops/flash_attention.py) refuses anything else, and
//   the entry point returns cudaErrorMisalignedAddress for it.
//
// fp32 (dtype 0) keeps the first version's kernel (`attn_fp32_kernel`): fp32
// FMAs on the CUDA cores out of shared memory, with an online softmax. It
// serves the fp32 reference runs and their 1e-4 gates, which the tensor cores
// cannot meet without TF32.
//
// Interface: a plain C function (no PyTorch headers), built by nvcc and
// loaded with ctypes by controlanimate_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ============================================================ fp32 path

constexpr int kFmaThreads = 128;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared-memory plan of one block, in floats. Rows of Q and K are padded by
// one float so that threads reading different rows at the same d hit
// different banks (D + 1 is odd for every supported D).
template <int D, int BQ, int BK>
struct Smem {
  static constexpr int LD = D + 1;
  static constexpr int LS = BK + 1;
  static constexpr int q = 0;
  static constexpr int k = q + BQ * LD;
  static constexpr int v = k + BK * LD;
  static constexpr int s = v + BK * D;
  static constexpr int m = s + BQ * LS;
  static constexpr int l = m + BQ;
  static constexpr int corr = l + BQ;
  static constexpr int total = corr + BQ;
  static constexpr size_t bytes = sizeof(float) * total;
};

// One block: BQ query rows of one (batch, head), 128 threads.
//   output tile (BQ x D): thread (tr, tc) owns rows tr + i*TR, cols tc + j*TC;
//   score tile (BQ x BK): thread (sr, sc) owns rows sr + i*STR, cols sc + j*SC.
template <int D, int BQ, int BK, int TC>
__global__ void __launch_bounds__(kFmaThreads)
attn_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int Nq, int Nk,
                 int sqb, int sqn, int sqh, int skb, int skn, int skh,
                 int svb, int svn, int svh, int sob, int son, int soh, float scale) {
  using S = Smem<D, BQ, BK>;
  constexpr int TR = kFmaThreads / TC;
  constexpr int RPT = BQ / TR;
  constexpr int CPT = D / TC;
  constexpr int SC = BK < 32 ? BK : 32;
  constexpr int STR = kFmaThreads / SC;
  constexpr int SRPT = BQ / STR;
  constexpr int SCPT = BK / SC;
  static_assert(kFmaThreads % TC == 0 && BQ % TR == 0 && D % TC == 0, "output tiling");
  static_assert(BK % SC == 0 && BQ % STR == 0, "score tiling");
  static_assert(BK <= 64, "softmax pass handles at most 64 columns per lane pair");

  extern __shared__ float smem[];
  float* Qs = smem + S::q;
  float* Ks = smem + S::k;
  float* Vs = smem + S::v;
  float* Ss = smem + S::s;
  float* Ms = smem + S::m;
  float* Ls = smem + S::l;
  float* Cs = smem + S::corr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;

  const float* qb = q + (int64_t)b * sqb + (int64_t)h * sqh;
  const float* kb = k + (int64_t)b * skb + (int64_t)h * skh;
  const float* vb = v + (int64_t)b * svb + (int64_t)h * svh;
  float* ob = o + (int64_t)b * sob + (int64_t)h * soh;

  // stage this block's query rows (rows past Nq read as zero, never stored)
  for (int idx = tid; idx < BQ * D; idx += kFmaThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = q0 + r;
    Qs[r * S::LD + d] = row < Nq ? qb[(int64_t)row * sqn + d] : 0.f;
  }
  for (int r = tid; r < BQ; r += kFmaThreads) {
    Ms[r] = -INFINITY;
    Ls[r] = 0.f;
  }

  const int tc = tid % TC;
  const int tr = tid / TC;
  const int sc = tid % SC;
  const int sr = tid / SC;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // previous tile's readers are done with Ks / Vs / Ss
    for (int idx = tid; idx < BK * D; idx += kFmaThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      const int row = k0 + r;
      const bool ok = row < Nk;
      Ks[r * S::LD + d] = ok ? kb[(int64_t)row * skn + d] : 0.f;
      Vs[r * D + d] = ok ? vb[(int64_t)row * svn + d] : 0.f;
    }
    __syncthreads();

    // scores: S = (Q K^T) * scale, fp32
    {
      float s[SRPT][SCPT];
#pragma unroll
      for (int i = 0; i < SRPT; ++i)
#pragma unroll
        for (int j = 0; j < SCPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[SRPT], kv[SCPT];
#pragma unroll
        for (int i = 0; i < SRPT; ++i) qv[i] = Qs[(sr + i * STR) * S::LD + d];
#pragma unroll
        for (int j = 0; j < SCPT; ++j) kv[j] = Ks[(sc + j * SC) * S::LD + d];
#pragma unroll
        for (int i = 0; i < SRPT; ++i)
#pragma unroll
          for (int j = 0; j < SCPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < SRPT; ++i)
#pragma unroll
        for (int j = 0; j < SCPT; ++j) {
          const int col = sc + j * SC;
          Ss[(sr + i * STR) * S::LS + col] = (k0 + col < Nk) ? s[i][j] * scale : -INFINITY;
        }
    }
    __syncthreads();

    // online softmax, one warp per row: p = exp(s - m_new), rescale factor
    // exp(m_old - m_new) for the running sum and output
    for (int r = warp; r < BQ; r += kFmaThreads / 32) {
      float* row = Ss + r * S::LS;
      const float s0 = lane < BK ? row[lane] : -INFINITY;
      const float s1 = lane + 32 < BK ? row[lane + 32] : -INFINITY;
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < BK ? __expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < BK ? __expf(s1 - m_new) : 0.f;
      if (lane < BK) row[lane] = p0;
      if (lane + 32 < BK) row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float c = __expf(m_old - m_new);  // 0 on the first tile
        Cs[r] = c;
        Ls[r] = Ls[r] * c + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    // output: acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float c = Cs[tr + i * TR];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ss[(tr + i * TR) * S::LS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = Vs[kk * D + tc + j * TC];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + i * TR;
    const int row = q0 + r;
    if (row >= Nq) continue;
    const float inv = 1.f / Ls[r];
    float* orow = ob + (int64_t)row * son;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[tc + j * TC] = acc[i][j] * inv;
  }
}

template <int D, int BQ, int BK, int TC>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Nq, int Nk, const int* st, float scale, cudaStream_t stream) {
  auto kern = attn_fp32_kernel<D, BQ, BK, TC>;
  const size_t smem = Smem<D, BQ, BK>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BQ - 1) / BQ, B * H);
  kern<<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

// Tile plan per head dim: (BQ, BK, TC) keep the fp32 output tile in registers
// (RPT * CPT values a thread) and shared memory at or under ~100 KB, so two
// blocks fit on an SM. The grid is (query blocks, B * H), so a launch with
// few heads and a long query (GLPN's first stage: B * H = 16, 24576 rows at
// 512x768) still spreads over every SM.
cudaError_t dispatch_fp32(const void* q, const void* k, const void* v, void* o, int B, int H,
                          int Nq, int Nk, int D, const int* st, float scale,
                          cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fp32<32, 64, 64, 8>(q, k, v, o, B, H, Nq, Nk, st, scale, stream);
    case 40: return launch_fp32<40, 64, 64, 8>(q, k, v, o, B, H, Nq, Nk, st, scale, stream);
    case 64: return launch_fp32<64, 64, 64, 16>(q, k, v, o, B, H, Nq, Nk, st, scale, stream);
    case 80: return launch_fp32<80, 64, 64, 16>(q, k, v, o, B, H, Nq, Nk, st, scale, stream);
    case 160: return launch_fp32<160, 64, 32, 32>(q, k, v, o, B, H, Nq, Nk, st, scale, stream);
    case 512: return launch_fp32<512, 16, 16, 32>(q, k, v, o, B, H, Nq, Nk, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ============================================================ bf16 path

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;  // K/V ring depth

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// two fp32 -> one register of two bf16 (lo in the low half, as the fragments want)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// c (16x8, fp32) += a (16x8, bf16, row) * b (8x8, bf16, col): the k8 tail of
// a depth that is 8 more than a multiple of 16 (D = 40)
__device__ __forceinline__ void mma_bf16_k8(float* c, const uint32_t* a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Row pitch in bf16 of a shared tile of `cols` columns: an odd number of
// 16-byte units, so that the 8 rows of every ldmatrix 8x8 matrix fall in 8
// different bank groups (conflict-free). 40 columns (5 units) need no pad,
// 32, 64, 80, 160 and 512 get 8 more (32 columns: a 64-byte row in an
// 80-byte pitch).
__host__ __device__ constexpr int padded_pitch(int cols) {
  return (cols / 8) % 2 == 1 ? cols : cols + 8;
}

// Issue one K tile, and with kWithV the V tile beside it (BK rows of D bf16
// from row k0), into a ring stage; rows past Nk are zero-filled.
template <int D, int BK, int LDS, int NT, bool kWithV>
__device__ __forceinline__ void load_kv_tile(bf16* ks, bf16* vs, const bf16* kb, const bf16* vb,
                                             int skn, int svn, int k0, int Nk) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < BK * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 8;
    const int row = k0 + r;
    const bool ok = row < Nk;
    const int64_t src = ok ? row : 0;
    cp_async16(smem_u32(ks + r * LDS + c), kb + src * skn + c, ok);
    if constexpr (kWithV) cp_async16(smem_u32(vs + r * LDS + c), vb + src * svn + c, ok);
  }
}

// The K/V ring of both bf16 kernels: two stages of K (and V) tiles. Step t
// makes tile t resident in stage t % 2 and has tile t + 1 loading into the
// other stage while tile t is used. Both passes walk the ring; the first
// loads K only.
template <int D, int BK, int LDS, int NT>
struct KVRing {
  bf16* ks;
  bf16* vs;
  const bf16* kb;
  const bf16* vb;
  int skn, svn, Nk, ntiles;
  static constexpr int tile = BK * LDS;

  template <bool kWithV>
  __device__ __forceinline__ void load(int t) const {
    load_kv_tile<D, BK, LDS, NT, kWithV>(ks + (t & 1) * tile, vs + (t & 1) * tile, kb, vb, skn,
                                         svn, t * BK, Nk);
  }

  // the first tile of a pass, once the block is done with the ring
  template <bool kWithV>
  __device__ __forceinline__ void start() const {
    load<kWithV>(0);
    cp_async_commit();
  }

  template <bool kWithV>
  __device__ __forceinline__ void step(int t) const {
    __syncthreads();  // every warp is done with the other stage (read at t - 1)
    if (t + 1 < ntiles) load<kWithV>(t + 1);
    cp_async_commit();   // possibly empty: keeps one group per step
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // ... and everyone's
  }

  // after a pass: nothing in flight, and every warp done with the ring
  __device__ __forceinline__ void drain() const {
    cp_async_wait<0>();
    __syncthreads();
  }

  __device__ __forceinline__ const bf16* k_tile(int t) const { return ks + (t & 1) * tile; }
  __device__ __forceinline__ const bf16* v_tile(int t) const { return vs + (t & 1) * tile; }
};

// ---- D <= 160: each warp owns 16 * MT query rows, everything per row in
// ---- registers

template <int kD, int kNW, int kMT, int kBK>
struct RowsPlan {
  static constexpr int D = kD, NW = kNW, MT = kMT, BK = kBK;
  static constexpr int LDS = padded_pitch(D);
  static constexpr int BQ = 16 * MT * NW;
  static constexpr size_t bytes = sizeof(bf16) * 2 * kStages * BK * LDS;
  static_assert(D % 8 == 0 && BK % 32 == 0, "tile shape");
};

template <int D, int NW, int MT, int BK>
__global__ void __launch_bounds__(NW * 32)
attn_bf16_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Nq, int Nk,
                      int sqb, int sqn, int sqh, int skb, int skn, int skh, int svb, int svn,
                      int svh, int sob, int son, int soh, float scale_log2) {
  using P = RowsPlan<D, NW, MT, BK>;
  constexpr int NT = NW * 32;
  constexpr int KS = D / 16;           // k16 steps of QK^T
  constexpr bool kTail = D % 16 == 8;  // and one k8 step after them (D = 40)
  constexpr int NS = BK / 8;           // n8 tiles of S
  constexpr int NO = D / 8;            // n8 tiles of the output
  constexpr int LDS = P::LDS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kStages * BK * LDS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row within an m16 tile (and g + 8)
  const int tg = lane & 3;  // column pair within an n8 tile
  const int mi = lane >> 3;  // ldmatrix: this lane addresses matrix mi of an x4,
  const int lr = lane & 7;   // row lr within it
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const bf16* qb = q + (int64_t)b * sqb + (int64_t)h * sqh;
  bf16* ob = o + (int64_t)b * sob + (int64_t)h * soh;
  const KVRing<D, BK, LDS, NT> ring{Ks, Vs, k + (int64_t)b * skb + (int64_t)h * skh,
                                    v + (int64_t)b * svb + (int64_t)h * svh, skn, svn, Nk,
                                    (Nk + BK - 1) / BK};
  ring.template start<false>();

  // this warp's Q as A fragments, rows row0 + 16 * mt (and + 8); rows past
  // Nq are zero
  const int row0 = blockIdx.x * P::BQ + warp * 16 * MT + g;
  auto q_pair = [&](int r, int d) -> uint32_t {
    return r < Nq ? *reinterpret_cast<const uint32_t*>(qb + (int64_t)r * sqn + d) : 0u;
  };
  uint32_t qf[MT][KS][4];
  uint32_t qt[MT][2];  // the k8 tail (D = 40)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + 16 * mt;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        qf[mt][kk][2 * half] = q_pair(r, kk * 16 + half * 8 + 2 * tg);
        qf[mt][kk][2 * half + 1] = q_pair(r + 8, kk * 16 + half * 8 + 2 * tg);
      }
    if constexpr (kTail) {
      qt[mt][0] = q_pair(r, KS * 16 + 2 * tg);
      qt[mt][1] = q_pair(r + 8, KS * 16 + 2 * tg);
    }
  }

  // S = Q K^T for tile t (16 * MT x BK a warp), fp32 sums, unscaled; keys
  // past Nk (only in the last tile) at -inf
  auto scores = [&](float (&s)[MT][NS][4], int t) {
    const bf16* Kt = ring.k_tile(t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bfr[4];  // keys np*16 + (0..7 | 8..15), depth (lo | hi) half
        ldmatrix_x4(bfr, smem_u32(Kt + (np * 16 + (mi >> 1) * 8 + lr) * LDS + kk * 16 +
                                  (mi & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kk], bfr[0], bfr[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bfr[2], bfr[3]);
        }
      }
    if constexpr (kTail) {
#pragma unroll
      for (int nq = 0; nq < NS / 4; ++nq) {
        uint32_t bfr[4];  // keys nq*32 + 8*u.., the depth's last 8
        ldmatrix_x4(bfr, smem_u32(Kt + (nq * 32 + mi * 8 + lr) * LDS + KS * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_bf16_k8(s[mt][4 * nq + u], qt[mt], bfr[u]);
      }
    }
    const int k0 = t * BK;
    if (k0 + BK > Nk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + 2 * tg + (e & 1) >= Nk) s[mt][j][e] = -INFINITY;
    }
  };

  // pass 1: each row's exact max; e = 0, 1 of an accumulator are row r,
  // e = 2, 3 row r + 8
  float m[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = -INFINITY;
  for (int t = 0; t < ring.ntiles; ++t) {
    ring.template step<false>(t);
    float s[MT][NS][4];
    scores(s, t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        m[mt][0] = fmaxf(m[mt][0], fmaxf(s[mt][j][0], s[mt][j][1]));
        m[mt][1] = fmaxf(m[mt][1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
  }
  // to log2 units: max(s) * c == max(s * c) for c > 0, rounding is monotonic
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = quad_max(m[mt][0]) * scale_log2;
    m[mt][1] = quad_max(m[mt][1]) * scale_log2;
  }
  ring.drain();
  ring.template start<true>();

  // pass 2: P = exp2(s * scale_log2 - m), rounded to bf16 in registers (the
  // S accumulators of n8 tiles 2j, 2j+1 are the A fragment of PV's k16 step
  // j); the row sums take the unrounded P
  float acc[MT][NO][4];
  float l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }
  for (int t = 0; t < ring.ntiles; ++t) {
    ring.template step<true>(t);
    const bf16* Vt = ring.v_tile(t);
    float s[MT][NS][4];
    scores(s, t);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float p[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[u][e] = exp2f(fmaf(s[mt][2 * j + u][e], scale_log2, -m[mt][e >> 1]));
            l[mt][e >> 1] += p[u][e];
          }
        a[mt][0] = pack_bf16(p[0][0], p[0][1]);
        a[mt][1] = pack_bf16(p[0][2], p[0][3]);
        a[mt][2] = pack_bf16(p[1][0], p[1][1]);
        a[mt][3] = pack_bf16(p[1][2], p[1][3]);
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bfr[4];  // keys j*16 + (lo | hi), output columns np*16 + (0..7 | 8..15)
        ldmatrix_x4_trans(bfr, smem_u32(Vt + (j * 16 + (mi & 1) * 8 + lr) * LDS + np * 16 +
                                        (mi >> 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
        }
      }
      if constexpr (NO % 2 == 1) {
        uint32_t bfr[2];
        ldmatrix_x2_trans(bfr, smem_u32(Vt + (j * 16 + (mi & 1) * 8 + lr) * LDS + (NO - 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][NO - 1], a[mt], bfr[0], bfr[1]);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit (the last group is empty)

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + 16 * mt + 8 * hr;
      const float sum = quad_sum(l[mt][hr]);
      if (r >= Nq) continue;
      bf16* orow = ob + (int64_t)r * son + 2 * tg;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16(acc[mt][j][2 * hr] / sum, acc[mt][j][2 * hr + 1] / sum);
    }
}

template <class P>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Nq, int Nk, const int* st, float scale_log2, cudaStream_t stream) {
  auto kern = attn_bf16_rows_kernel<P::D, P::NW, P::MT, P::BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + P::BQ - 1) / P::BQ, B * H);
  kern<<<grid, P::NW * 32, P::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2);
  return cudaGetLastError();
}

// ---- D = 512: D split over the warps for PV, P through shared memory

struct WidePlan {
  static constexpr int D = 512;
  static constexpr int NW = 8;
  static constexpr int BQ = 64;
  static constexpr int BK = 32;
  static constexpr int LDS = padded_pitch(D);   // Q, K, V rows (bf16)
  static constexpr int LDP = padded_pitch(BK);  // P rows (bf16)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * BQ * LDS;
  static constexpr size_t v_off = k_off + sizeof(bf16) * kStages * BK * LDS;
  static constexpr size_t p_off = v_off + sizeof(bf16) * kStages * BK * LDS;
  static constexpr size_t m_off = p_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t l_off = m_off + sizeof(float) * 2 * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * 2 * BQ;  // 205,824
  static_assert(bytes <= 232448, "shared memory of one block on the H100");
  static_assert(NW * 64 == D && (BQ / 16) * (BK / 16) == NW, "warp roles");
};

__global__ void __launch_bounds__(WidePlan::NW * 32, 1)
attn_bf16_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Nq, int Nk,
                      int sqb, int sqn, int sqh, int skb, int skn, int skh, int svb, int svn,
                      int svh, int sob, int son, int soh, float scale_log2) {
  using P = WidePlan;
  constexpr int D = P::D, BQ = P::BQ, BK = P::BK, LDS = P::LDS, LDP = P::LDP;
  constexpr int NT = P::NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + P::q_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + P::p_off);
  float* Ms = reinterpret_cast<float*>(smem_raw + P::m_off);  // [key half][row]
  float* Ls = reinterpret_cast<float*>(smem_raw + P::l_off);  // [key half][row]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int mi = lane >> 3;
  const int lr = lane & 7;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const bf16* qb = q + (int64_t)b * sqb + (int64_t)h * sqh;
  bf16* ob = o + (int64_t)b * sob + (int64_t)h * soh;
  const KVRing<D, BK, LDS, NT> ring{reinterpret_cast<bf16*>(smem_raw + P::k_off),
                                    reinterpret_cast<bf16*>(smem_raw + P::v_off),
                                    k + (int64_t)b * skb + (int64_t)h * skh,
                                    v + (int64_t)b * svb + (int64_t)h * svh, skn, svn, Nk,
                                    (Nk + BK - 1) / BK};

  // Q (rows past Nq zero-filled) joins the first K tile's group
  for (int idx = tid; idx < BQ * (D / 8); idx += NT) {
    const int r = idx / (D / 8);
    const int c = (idx - r * (D / 8)) * 8;
    const bool ok = q0 + r < Nq;
    cp_async16(smem_u32(Qs + r * LDS + c), qb + (int64_t)(ok ? q0 + r : 0) * sqn + c, ok);
  }
  ring.start<false>();

  // this warp's piece of the 64 x 32 S tile: rows 16*sm + (g, g + 8), keys
  // 16*sn.. (two n8 tiles); for PV it owns output columns 64*warp..
  const int sm = warp >> 1;
  const int sn = warp & 1;
  const int r0 = sm * 16 + g;

  // S piece for tile t over the full depth, unscaled; keys past Nk at -inf
  auto scores = [&](float (&s)[2][4], int t) {
    const bf16* qa = Qs + (sm * 16 + (mi & 1) * 8 + lr) * LDS + (mi >> 1) * 8;
    const bf16* ka = ring.k_tile(t) + (sn * 16 + (mi >> 1) * 8 + lr) * LDS + (mi & 1) * 8;
#pragma unroll
    for (int u = 0; u < 2; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t afr[4], bfr[4];
      ldmatrix_x4(afr, smem_u32(qa + kk * 16));
      ldmatrix_x4(bfr, smem_u32(ka + kk * 16));
      mma_bf16(s[0], afr, bfr[0], bfr[1]);
      mma_bf16(s[1], afr, bfr[2], bfr[3]);
    }
    const int col = t * BK + sn * 16 + 2 * tg;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + u * 8 + (e & 1) >= Nk) s[u][e] = -INFINITY;
  };

  // pass 1: the exact max of rows r0 and r0 + 8 over this warp's key half,
  // then over both halves through shared memory
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int t = 0; t < ring.ntiles; ++t) {
    ring.step<false>(t);
    float s[2][4];
    scores(s, t);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      m0 = fmaxf(m0, fmaxf(s[u][0], s[u][1]));
      m1 = fmaxf(m1, fmaxf(s[u][2], s[u][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  if (tg == 0) {
    Ms[sn * BQ + r0] = m0;
    Ms[sn * BQ + r0 + 8] = m1;
  }
  ring.drain();
  ring.start<true>();
  // to log2 units: max(s) * c == max(s * c) for c > 0, rounding is monotonic
  m0 = fmaxf(Ms[r0], Ms[BQ + r0]) * scale_log2;
  m1 = fmaxf(Ms[r0 + 8], Ms[BQ + r0 + 8]) * scale_log2;

  // pass 2: each warp turns its S piece into P (bf16, to shared) and its part
  // of the row sums; then every warp multiplies all 64 rows of P by its 64
  // columns of V
  float acc[BQ / 16][8][4];
#pragma unroll
  for (int i = 0; i < BQ / 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ring.ntiles; ++t) {
    ring.step<true>(t);  // its first barrier also ends the last step's reads of Ps
    float s[2][4];
    scores(s, t);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2f(fmaf(s[u][e], scale_log2, e < 2 ? -m0 : -m1));
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      bf16* pr = Ps + r0 * LDP + sn * 16 + u * 8 + 2 * tg;
      *reinterpret_cast<uint32_t*>(pr) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(pr + 8 * LDP) = pack_bf16(p[2], p[3]);
    }
    __syncthreads();

    const bf16* Vt = ring.v_tile(t);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t afr[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 16; ++i)
        ldmatrix_x4(afr[i], smem_u32(Ps + (i * 16 + (mi & 1) * 8 + lr) * LDP + kk * 16 +
                                     (mi >> 1) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_u32(Vt + (kk * 16 + (mi & 1) * 8 + lr) * LDS + warp * 64 +
                                        np * 16 + (mi >> 1) * 8));
#pragma unroll
        for (int i = 0; i < BQ / 16; ++i) {
          mma_bf16(acc[i][2 * np], afr[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * np + 1], afr[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (tg == 0) {
    Ls[sn * BQ + r0] = l0;
    Ls[sn * BQ + r0 + 8] = l1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BQ / 16; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = i * 16 + g + hr * 8;
      if (q0 + r >= Nq) continue;
      const float sum = Ls[r] + Ls[BQ + r];
      bf16* orow = ob + (int64_t)(q0 + r) * son + warp * 64 + 2 * tg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16(acc[i][j][2 * hr] / sum, acc[i][j][2 * hr + 1] / sum);
    }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Nq, int Nk, const int* st, float scale_log2, cudaStream_t stream) {
  using P = WidePlan;
  cudaError_t err = cudaFuncSetAttribute(attn_bf16_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + P::BQ - 1) / P::BQ, B * H);
  attn_bf16_wide_kernel<<<grid, P::NW * 32, P::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Tile plan per head dim, RowsPlan<D, warps, m16 tiles a warp, BK>: the
// fastest of several timed on the H100 at the main path's shapes. D = 40 and
// 80: 4 warps of 32 rows (BQ = 128): each K/V fragment read from shared
// memory serves two m16 tiles, and each K/V tile read from L2 serves 128
// query rows (168 and 243 registers a thread, 20 and 45 KB of shared
// memory). D = 64 (the depth annotators' ViTs, which run in fp32; this
// plan keeps one set of head dims for both dtypes): D = 80's shape, 64
// output and 32 Q registers a lane, 36 KB (not tuned). D = 32 (GLPN at the
// b0 widths, fp32; kept for the same reason): the same shape, 32 output and
// 16 Q registers a lane, 64-byte rows in 80-byte pitches, 20 KB (not
// tuned). D = 160: 8 warps of
// 16 rows (BQ = 128; 80 output and 40 Q registers a lane, 214 a thread, 86
// KB). D = 512: WidePlan.
using Rows32 = RowsPlan<32, 4, 2, 64>;
using Rows40 = RowsPlan<40, 4, 2, 64>;
using Rows64 = RowsPlan<64, 4, 2, 64>;
using Rows80 = RowsPlan<80, 4, 2, 64>;
using Rows160 = RowsPlan<160, 8, 1, 64>;

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                          int Nq, int Nk, int D, const int* st, float scale,
                          cudaStream_t stream) {
  // 16-byte cp.async: aligned bases, and strides of 8 elements wherever a
  // dimension has more than one entry
  const int sizes[12] = {B, Nq, H, B, Nk, H, B, Nk, H, B, Nq, H};
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorMisalignedAddress;
  for (int i = 0; i < 12; ++i)
    if (sizes[i] > 1 && st[i] % 8 != 0) return cudaErrorMisalignedAddress;
  const float sl = scale * kLog2e;
  switch (D) {
    case 32: return launch_rows<Rows32>(q, k, v, o, B, H, Nq, Nk, st, sl, stream);
    case 40: return launch_rows<Rows40>(q, k, v, o, B, H, Nq, Nk, st, sl, stream);
    case 64: return launch_rows<Rows64>(q, k, v, o, B, H, Nq, Nk, st, sl, stream);
    case 80: return launch_rows<Rows80>(q, k, v, o, B, H, Nq, Nk, st, sl, stream);
    case 160: return launch_rows<Rows160>(q, k, v, o, B, H, Nq, Nk, st, sl, stream);
    case 512: return launch_wide(q, k, v, o, B, H, Nq, Nk, st, sl, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (B, N, H) dimensions of q, k, v and o in that order. Returns the
// cudaError_t of the launch (cudaGetLastError), 0 on success.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Nq, int Nk, int D, int sqb, int sqn, int sqh, int skb, int skn,
                        int skh, int svb, int svn, int svh, int sob, int son, int soh,
                        float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const int st[12] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_fp32(q, k, v, o, B, H, Nq, Nk, D, st, scale, s);
  if (dtype == 1) return (int)dispatch_bf16(q, k, v, o, B, H, Nq, Nk, D, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the bf16 kernel for head dim D (0
// for an unsupported D); nothing is launched.
int flash_attention_bf16_smem_bytes(int D) {
  switch (D) {
    case 32: return (int)Rows32::bytes;
    case 40: return (int)Rows40::bytes;
    case 64: return (int)Rows64::bytes;
    case 80: return (int)Rows80::bytes;
    case 160: return (int)Rows160::bytes;
    case 512: return (int)WidePlan::bytes;
    default: return 0;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
