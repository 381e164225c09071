// Masked multi-head attention core for Hopper (sm_90a):
//
//   out[b, i, h*hd + c] = sum_j P[b, h, i, j] * v[b, j, h*hd + c]
//   P[b, h, i, :] = softmax_j( (q[b, i, h*hd:(h+1)*hd] . k[b, j, h*hd:(h+1)*hd]) * hd^-0.5,
//                              keys with mask[b, j] != 0 set to -1e30 )
//
// Replaces the TPU kernel tools/bench_attn.py:79 pallas_attention (body
// attn_kernel, :57-76).
//
// Bound on the card. In bfloat16 the bytes: q, k, v and out move once
// (144 MB at B 640, L 110, D 256) while the 4*B*H*Lq*Lk*hd operations are a
// few microseconds of tensor-core work. In float32 the operations, if they
// run on the FMA pipes; as 3xTF32 on the tensor cores they drop under the
// bytes as well. So the design moves q, k, v and out once, in wide pieces,
// and keeps everything else on the chip:
//   * a block owns one window and a group of heads whose columns make rows
//     of up to 256 bytes (4 heads of 32 in bfloat16, 2 in float32), and up
//     to 128 query rows. Q, K and V rows of the group are staged once by
//     16-byte cp.async into shared memory in their own type (a warp's copy
//     instruction covers two whole 256-byte rows), and two blocks of eight
//     warps share an SM, so one block's loads overlap the other's
//     arithmetic. Rows are padded by 16 bytes: ldmatrix and the scalar
//     fragment loads hit 32 different banks. Key rows are staged up to the
//     instance's 16 KT, zero past Lk, so no loop over key tiles needs a
//     condition (a branch per tile keeps the compiler from overlapping one
//     tile's loads with another's products);
//   * both products run on the tensor cores. bfloat16:
//     mma.sync.m16n8k16, Q and K fragments by ldmatrix (K row-major is the
//     "col" operand as it lies), V by ldmatrix.trans. float32: 3xTF32 on
//     mma.sync.m16n8k8, every operand split into a TF32 high part and a
//     residual, hi*hi + hi*lo + lo*hi summed in fp32;
//   * a warp's item is 16 query rows of one head, items go round-robin over
//     the warps; Lk <= 256 lets the whole row of logits live in registers,
//     so the softmax is the plain one: scale the fp32 logits, mask, max,
//     exp, sum, normalise (the max and the sum cross the four lanes of a
//     row by two shuffles);
//   * the weights go from the S accumulators straight into the A operand
//     of P.V in registers: in bfloat16 two adjacent 8-key accumulator
//     tiles are one k16 fragment (rounded to bfloat16 after normalising, as
//     the TPU kernel casts them to v's type); in float32 the k index of an
//     8-key step is permuted (slot t <-> key 2t, slot t+4 <-> key 2t+1) on
//     both operands, which a sum over k does not see. No weight touches
//     shared memory or a shuffle;
//   * a warp parks its 16 x hd output tile in the shared-memory place of
//     the Q tile it has just consumed and writes it out in 16-byte pieces;
//   * masked keys and keys past Lk sit at the finite -1e30 and get weight
//     0; a window whose keys are all masked gives uniform weights over its
//     Lk keys, as the plain masked_fill + softmax does (it is recognised
//     once per block from the mask's bits, its logits are set equal and
//     only the keys past Lk stay out);
//   * what a block does once (staging without a division per piece, the
//     mask gathered as eight ballot words) is kept lean: at 3.5 items a
//     warp it was a seventh of the kernel.
// KT, the 16-key tiles the registers hold (4, 7, 8, 16 for Lk <= 64, 112,
// 128, 256), is the one template parameter beside the type: eight
// instances.
//
// C interface, loaded with ctypes. The launch goes on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKeys = 256;
constexpr int kMaxHeadDim = 128;
constexpr int kQChunk = 128;    // query rows a block stages
constexpr int kRowBytes = 256;  // columns of a head group, in bytes
constexpr int kPadBytes = 16;
constexpr int kMaskBytes = 32;    // the window's mask as bits, a word per warp
constexpr int kMaxSmem = 232448;  // opt-in dynamic shared memory of a block
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// heads a block owns: as many as fill a 256-byte row, at least one
__host__ __device__ inline int heads_per_block(int hd, int H, int item) {
  int hb = kRowBytes / (hd * item);
  hb = hb < 1 ? 1 : hb;
  return hb > H ? H : hb;
}

// KT, the 16-key tiles an instance holds in registers and stages rows for.
// 7 is the fine stage's window of 110 tokens: an eighth less of every
// product and exponential than the instance of 8 would spend on it.
__host__ __device__ inline int key_tiles(int Lk) {
  return Lk <= 64 ? 4 : (Lk <= 112 ? 7 : (Lk <= 128 ? 8 : 16));
}

__host__ __device__ inline size_t smem_bytes_of(int Lq, int Lk, int hd, int H, int item) {
  const int q_rows = 16 * ceil_div(Lq < kQChunk ? Lq : kQChunk, 16);
  const size_t row = (size_t)heads_per_block(hd, H, item) * hd * item + kPadBytes;
  return (size_t)(q_rows + 2 * 16 * key_tiles(Lk)) * row + kMaskBytes;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo exactly, hi on TF32's 11 significant bits: Veltkamp's split
// with 2^13 + 1, three fp32 operations at the full rate (cvt.rna.tf32.f32
// issues at a fraction of it). The tensor core drops lo's low 13 bits
// itself, an error of 2^-21 |x| at most.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.f);
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// S = Q K^T of one warp's 16 query rows against the head's 16 KT key rows
// (rows past Lk are zero). s[n] is the accumulator tile of keys 8n..8n+7:
// s[n][0..1] row g, keys 2t, 2t+1; s[n][2..3] row g+8. The loops over key
// tiles carry no condition: a branch per tile would fence the loads and
// products of one tile off from the next.
template <typename T, int KT>
__device__ __forceinline__ void logits(float (&s)[2 * KT][4], const T* q_t,
                                       const T* k_h, int ld, int hd, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
    const T* a_p = q_t + (lane & 15) * ld + (lane >> 4) * 8;
    const T* b_p = k_h + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
    for (int ks = 0; ks < hd / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, a_p + ks * 16);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t b[4];
        ldmatrix_x4(b, b_p + kt * 16 * ld + ks * 16);
        mma_bf16(s[2 * kt], a, b[0], b[1]);
        mma_bf16(s[2 * kt + 1], a, b[2], b[3]);
      }
    }
  } else {
    const float* a_p = reinterpret_cast<const float*>(q_t) + g * ld + t;
    const float* b_p = reinterpret_cast<const float*>(k_h) + g * ld + t;
    for (int ks = 0; ks < hd / 8; ++ks) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(a_p[ks * 8], a_hi[0], a_lo[0]);
      split_tf32(a_p[ks * 8 + 8 * ld], a_hi[1], a_lo[1]);
      split_tf32(a_p[ks * 8 + 4], a_hi[2], a_lo[2]);
      split_tf32(a_p[ks * 8 + 8 * ld + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(b_p[n * 8 * ld + ks * 8], b_hi[0], b_lo[0]);
        split_tf32(b_p[n * 8 * ld + ks * 8 + 4], b_hi[1], b_lo[1]);
        mma_tf32(s[n], a_lo, b_hi[0], b_hi[1]);
        mma_tf32(s[n], a_hi, b_lo[0], b_lo[1]);
        mma_tf32(s[n], a_hi, b_hi[0], b_hi[1]);
      }
    }
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// In place: s becomes the normalised softmax weights of rows g and g+8.
// Bit (2n + e) of `ign` is set where key 8n + 2t + e is masked or lies past
// Lk: it sits at the finite -1e30 and gets weight 0 as long as one key of
// the row is live (the caller hands a fully masked window equal logits).
// The scale goes into the exponent's one fused multiply-add, to base 2
// (scale2 = scale * log2 e), so the exponential is one ex2.approx, 2 ulp:
// far inside either type's tolerance.
template <int KT>
__device__ __forceinline__ void softmax_rows(float (&s)[2 * KT][4], float scale2,
                                             uint64_t ign) {
  float m0 = kNegInf, m1 = kNegInf;
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if ((ign >> (2 * n + e)) & 1) s[n][e] = s[n][e + 2] = kNegInf;
      m0 = fmaxf(m0, s[n][e]);
      m1 = fmaxf(m1, s[n][e + 2]);
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, 2));
  m0 *= scale2;
  m1 *= scale2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = exp2_approx(fmaf(s[n][e], scale2, -m0));
      s[n][e + 2] = exp2_approx(fmaf(s[n][e + 2], scale2, -m1));
      sum0 += s[n][e];
      sum1 += s[n][e + 2];
    }
  }
  sum0 += __shfl_xor_sync(kFull, sum0, 1);
  sum0 += __shfl_xor_sync(kFull, sum0, 2);
  sum1 += __shfl_xor_sync(kFull, sum1, 1);
  sum1 += __shfl_xor_sync(kFull, sum1, 2);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] *= inv0;
      s[n][e + 2] *= inv1;
    }
  }
}

// 8 NT output columns of O = P V for the warp's 16 rows, parked at o_c (in
// the warp's consumed Q tile, row stride ld). bfloat16: p holds the weights
// as A fragments, one per 16 keys. float32: the weights are s itself.
template <typename T, int KT, int NT>
__device__ __forceinline__ void weighted_values(const float (&s)[2 * KT][4],
                                                const uint32_t (&p)[KT][4], T* o_c,
                                                const T* v_c, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
    const T* b_p = v_c + (lane & 15) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_p + kt * 16 * ld + n * 8);
        mma_bf16(o[n], p[kt], b[0], b[1]);
        mma_bf16(o[n + 1], p[kt], b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t* d = reinterpret_cast<uint32_t*>(o_c + g * ld + n * 8 + 2 * t);
      d[0] = pack_bf16(o[n][0], o[n][1]);
      d[4 * ld] = pack_bf16(o[n][2], o[n][3]);  // 8 rows of ld bf16 = 4 ld words
    }
  } else {
    const float* b_p = reinterpret_cast<const float*>(v_c) + 2 * t * ld + g;
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      // k slot t is key 8j + 2t, slot t + 4 is key 8j + 2t + 1
      uint32_t a_hi[4], a_lo[4];
      split_tf32(s[j][0], a_hi[0], a_lo[0]);
      split_tf32(s[j][2], a_hi[1], a_lo[1]);
      split_tf32(s[j][1], a_hi[2], a_lo[2]);
      split_tf32(s[j][3], a_hi[3], a_lo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(b_p[j * 8 * ld + 8 * n], b_hi[0], b_lo[0]);
        split_tf32(b_p[j * 8 * ld + ld + 8 * n], b_hi[1], b_lo[1]);
        mma_tf32(o[n], a_lo, b_hi[0], b_hi[1]);
        mma_tf32(o[n], a_hi, b_lo[0], b_lo[1]);
        mma_tf32(o[n], a_hi, b_hi[0], b_hi[1]);
      }
    }
    float* o_f = reinterpret_cast<float*>(o_c);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* d = o_f + g * ld + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(d) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(d + 8 * ld) = make_float2(o[n][2], o[n][3]);
    }
  }
}

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads, KT <= 8 ? 2 : 1)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ mask,
                        T* __restrict__ out, int H, int Lq, int Lk, int D,
                        int hd, int hb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPiece = 16 / sizeof(T);       // elements of a 16-byte piece
  constexpr int kKeyRows = 16 * KT;            // key rows staged, zero past Lk
  const int ld = hb * hd + kPiece;             // row stride, elements
  const int q0 = blockIdx.z * kQChunk;         // first query row of the block
  const int n_q = min(Lq - q0, kQChunk);
  const int q_rows = 16 * ceil_div(n_q, 16);
  uint32_t* mask_bits = reinterpret_cast<uint32_t*>(smem_raw);  // (kWarps,)
  T* q_s = reinterpret_cast<T*>(smem_raw + kMaskBytes);         // (q_rows, ld)
  T* k_s = q_s + (size_t)q_rows * ld;          // (kKeyRows, ld)
  T* v_s = k_s + (size_t)kKeyRows * ld;        // (kKeyRows, ld)

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * hb;
  const int nh = min(hb, H - h0);              // heads of this block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;

  const T* q_b = q + ((size_t)b * Lq + q0) * D + h0 * hd;
  const T* k_b = k + (size_t)b * Lk * D + h0 * hd;
  const T* v_b = v + (size_t)b * Lk * D + h0 * hd;
  T* out_b = out + ((size_t)b * Lq + q0) * D + h0 * hd;

  // stage whole rows of the head group; rows past the real ones are zero
  const int ppr = nh * hd / kPiece;  // 16-byte pieces of a row
  // (row, piece) walk an array kThreads pieces at a time, without a
  // division per piece
  const int row_step = kThreads / ppr, piece_step = kThreads - row_step * ppr;
  auto stage = [&](T* dst0, const T* src0, int n_rows, int n_real) {
    for (int r = tid / ppr, piece = tid - r * ppr; r < n_rows;) {
      T* dst = dst0 + (size_t)r * ld + piece * kPiece;
      if (r < n_real)
        cp_async16(dst, src0 + (size_t)r * D + piece * kPiece);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      r += row_step;
      piece += piece_step;
      if (piece >= ppr) {
        piece -= ppr;
        ++r;
      }
    }
  };
  stage(q_s, q_b, q_rows, n_q);
  stage(k_s, k_b, kKeyRows, Lk);
  stage(v_s, v_b, kKeyRows, Lk);
  cp_async_commit();

  // the window's mask as bits while the rows land: thread j votes for key j
  // (masked, or past Lk), a warp's ballot is one word
  static_assert(kThreads == kMaxKeys && kWarps * 4 == kMaskBytes, "one thread per key");
  {
    const bool masked = tid >= Lk || (mask != nullptr && mask[(size_t)b * Lk + tid] != 0);
    const uint32_t word = __ballot_sync(kFull, masked);
    if (lane == 0) mask_bits[warp] = word;
  }
  cp_async_wait_all();
  __syncthreads();

  // this lane's keys: bit (2n + e) of ign says key 8n + 2t + e is masked or
  // past Lk. A window whose keys are all masked attends uniformly: its real
  // keys are cleared and its logits scaled to zero.
  uint64_t ign = 0;
  uint32_t all = ~0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all &= mask_bits[w];
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) {
    const int key = 8 * n + 2 * t;  // keys key, key + 1 lie in one word
    ign |= (uint64_t)((mask_bits[key >> 5] >> (key & 31)) & 3u) << (2 * n);
  }
  const float scale2 = scale * 1.4426950408889634f;  // to base 2
  const bool all_masked = all == ~0u;
  if (all_masked) {
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * n + 2 * t + e < Lk) ign &= ~(1ull << (2 * n + e));
    }
  }

  // a warp's item: 16 query rows of one head
  const int mtiles = q_rows / 16;
  const int pph = hd / kPiece;  // 16-byte pieces of a head's row
  for (int item = warp; item < nh * mtiles; item += kWarps) {
    const int hh = item / mtiles;
    const int mt = item - hh * mtiles;
    T* q_t = q_s + (size_t)mt * 16 * ld + hh * hd;
    const T* v_h = v_s + hh * hd;
    float s[2 * KT][4];
    if (all_masked) {  // equal logits: uniform weights over the keys left in
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    } else {
      logits<T, KT>(s, q_t, k_s + hh * hd, ld, hd, lane);
    }
    softmax_rows<KT>(s, scale2, ign);
    uint32_t p[KT][4];  // bfloat16: the weights as A fragments, one per 16 keys
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        p[kt][0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        p[kt][1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        p[kt][2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        p[kt][3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      }
    }
    __syncwarp();  // every lane has read the Q tile: it now takes the output
    for (int c0 = 0; c0 < hd; c0 += 32) {
      if (hd - c0 >= 32)
        weighted_values<T, KT, 4>(s, p, q_t + c0, v_h + c0, ld, lane);
      else  // a head width of 16 or 48: the last 16 columns
        weighted_values<T, KT, 2>(s, p, q_t + c0, v_h + c0, ld, lane);
    }
    __syncwarp();
    for (int i = lane; i < 16 * pph; i += 32) {
      const int r = i / pph;
      const int c = (i - r * pph) * kPiece;
      if (mt * 16 + r < n_q)
        *reinterpret_cast<uint4*>(out_b + (size_t)(mt * 16 + r) * D + hh * hd + c) =
            *reinterpret_cast<const uint4*>(q_t + (size_t)r * ld + c);
    }
  }
}

template <typename T, int KT>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* mask, void* out, int B, int H, int Lq, int Lk,
           int D, int hd, float scale, cudaStream_t stream) {
  const int hb = heads_per_block(hd, H, sizeof(T));
  const size_t smem = smem_bytes_of(Lq, Lk, hd, H, sizeof(T));
  // once per instance and device: shared memory above 48 KB is opted into,
  // and the SM's largest shared-memory split asked for, so that two blocks
  // fit an SM
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !opted_in[dev]) {
    e = cudaFuncSetAttribute(masked_attention_kernel<T, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(masked_attention_kernel<T, KT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const dim3 grid(B, ceil_div(H, hb), ceil_div(Lq, kQChunk));
  masked_attention_kernel<T, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), H, Lq, Lk, D, hd,
      hb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_keys(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, int B, int H, int Lq,
                int Lk, int D, int hd, float scale, cudaStream_t stream) {
  switch (key_tiles(Lk)) {
    case 4: return launch<T, 4>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, stream);
    case 7: return launch<T, 7>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, stream);
    case 8: return launch<T, 8>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, stream);
    default: return launch<T, 16>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, stream);
  }
}

}  // namespace

extern "C" {

// Limits of the kernel, for the wrapper's checks.
int masked_attention_max_keys() { return kMaxKeys; }
int masked_attention_max_head_dim() { return kMaxHeadDim; }

// Dynamic shared memory a block needs, in bytes; item = bytes of an element.
size_t masked_attention_smem_bytes(int Lq, int Lk, int hd, int H, int item) {
  return smem_bytes_of(Lq, Lk, hd, H, item);
}

const char* masked_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out (B, Lq, D); k, v (B, Lk, D); all contiguous, 16-byte aligned and of
// one type: dtype 0 = float32, 1 = bfloat16. mask (B, Lk) bytes, non-zero =
// ignore the key, or null. D = H * hd, hd a multiple of 16 up to 128,
// Lk <= 256. scale multiplies the fp32 logits (the caller passes hd^-0.5).
int masked_attention(const void* q, const void* k, const void* v,
                     const unsigned char* mask, void* out, int B, int Lq,
                     int Lk, int D, int H, int dtype, float scale,
                     void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 1 || D % H != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = D / H;
  if (hd > kMaxHeadDim || hd % 16 != 0 || Lk > kMaxKeys || H > 65535 ||
      ceil_div(Lq, kQChunk) > 65535 ||
      smem_bytes_of(Lq, Lk, hd, H, dtype == 0 ? 4 : 2) > (size_t)kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_keys<float>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, s);
  return launch_keys<__nv_bfloat16>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, s);
}

}  // extern "C"
