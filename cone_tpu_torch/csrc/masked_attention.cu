// Masked multi-head attention core for Hopper (sm_90a):
//
//   out[b, i, h*hd + c] = sum_j P[b, h, i, j] * v[b, j, h*hd + c]
//   P[b, h, i, :] = softmax_j( (q[b, i, h*hd:(h+1)*hd] * hd^-0.5) . k[b, j, h*hd:(h+1)*hd],
//                              keys with mask[b, j] != 0 set to -1e30 )
//
// Replaces the TPU kernel tools/bench_attn.py:79 pallas_attention (body
// attn_kernel, :57-76).
//
// Bound on the card. In float32 the operations: 4*B*H*Lq*Lk*hd flops run on
// the FMA pipes (no tensor core takes fp32 operands at full precision),
// while q, k, v and out move once. In bfloat16 the same operations would be
// tensor-core work, and the bound is the bytes. This kernel is a plain FMA
// kernel in both types, so what limits it in practice is the shared-memory
// and shuffle traffic that feeds the FMAs. The design:
//   * one block per (window, head); K_h and V_h (Lk x hd) are staged once
//     in shared memory as fp32, rows padded by one float so that lanes
//     reading different keys hit different banks;
//   * a warp carries kRows query rows together, so every K or V value read
//     from shared memory feeds kRows FMAs; a lane holds the logits of keys
//     lane, lane+32, ... in registers, the row max and sum go by shuffles;
//   * in P.V a lane owns the output columns lane, lane+32, ... of the head,
//     the weights are broadcast by shuffle, and the result goes straight to
//     out[b, row, h*hd + col]: the (B, H, Lq, Lk) logits and weights never
//     reach device memory and no head is concatenated afterwards;
//   * logits, softmax and both sums are fp32. For bfloat16 inputs the
//     weights are rounded to bfloat16 before P.V (as the TPU kernel casts
//     them to v's type) and the output is rounded once;
//   * a fully masked row gives uniform weights over all keys, as the plain
//     masked_fill + softmax does: the mask value is the finite -1e30, so
//     x - max = 0 for every key and nothing becomes NaN.
//
// C interface, loaded with ctypes. The launch goes on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;          // query rows a warp carries together
constexpr int kMaxKeyGroups = 8;  // Lk <= 256: a lane holds one logit per group
constexpr int kMaxColGroups = 4;  // hd <= 128: a lane owns one column per group
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The softmax weight as P.V sees it: v's type.
template <typename T> __device__ __forceinline__ float round_weight(float p) {
  return to_float(from_float<T>(p));
}

__host__ __device__ inline size_t smem_floats(int Lk, int hd) {
  return (size_t)2 * Lk * (hd + 1) + (size_t)kWarps * kRows * hd;
}

// G = key groups of 32 (Lk <= 32 G), C = column groups of 32 (hd <= 32 C).
template <typename T, int G, int C>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ mask,
                        T* __restrict__ out, int H, int Lq, int Lk, int D,
                        int hd, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 1;
  float* k_s = smem;                       // (Lk, hd + 1)
  float* v_s = k_s + (size_t)Lk * ld;      // (Lk, hd + 1)
  float* q_s = v_s + (size_t)Lk * ld;      // (kWarps, kRows, hd)

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* q_b = q + (size_t)b * Lq * D + h * hd;
  const T* k_b = k + (size_t)b * Lk * D + h * hd;
  const T* v_b = v + (size_t)b * Lk * D + h * hd;
  T* out_b = out + (size_t)b * Lq * D + h * hd;

  for (int i = tid; i < Lk * hd; i += kThreads) {
    const int r = i / hd;
    const int c = i - r * hd;
    k_s[r * ld + c] = to_float(k_b[(size_t)r * D + c]);
    v_s[r * ld + c] = to_float(v_b[(size_t)r * D + c]);
  }

  // this lane's keys: which exist, which are masked, and where their rows
  // start in shared memory (absent keys read the last row, and are dropped)
  bool exists[G], ignore[G];
  int k_off[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = g * 32 + lane;
    exists[g] = j < Lk;
    ignore[g] = exists[g] && mask != nullptr && mask[(size_t)b * Lk + j] != 0;
    k_off[g] = min(j, Lk - 1) * ld;
  }
  __syncthreads();

  float* q_w = q_s + warp * kRows * hd;
  for (int r0 = warp * kRows; r0 < Lq; r0 += kWarps * kRows) {
    __syncwarp();  // the previous rows' reads of q_w are done
    for (int i = lane; i < kRows * hd; i += 32) {
      const int r = i / hd;
      const int c = i - r * hd;
      const int row = r0 + r;
      q_w[i] = row < Lq ? to_float(q_b[(size_t)row * D + c]) * scale : 0.f;
    }
    __syncwarp();

    // logits: s[r][g] = (q[row] * scale) . k[g * 32 + lane]
    float s[kRows][G];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) s[r][g] = 0.f;
    for (int c = 0; c < hd; ++c) {
      float kv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) kv[g] = k_s[k_off[g] + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = q_w[r * hd + c];
#pragma unroll
        for (int g = 0; g < G; ++g) s[r][g] = fmaf(qv, kv[g], s[r][g]);
      }
    }

    // softmax over the keys of each row; weights end up in s
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = kNegInf;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (ignore[g]) s[r][g] = kNegInf;
        if (exists[g]) m = fmaxf(m, s[r][g]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[r][g] = exists[g] ? expf(s[r][g] - m) : 0.f;
        sum += s[r][g];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
#pragma unroll
      for (int g = 0; g < G; ++g) s[r][g] = round_weight<T>(s[r][g] / sum);
    }

    // P.V: this lane's columns are lane, lane + 32, ...
    float o[kRows][C];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < C; ++cc) o[r][cc] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = min(32, Lk - g * 32);  // the same for the whole warp
      for (int l = 0; l < n; ++l) {
        const float* v_row = v_s + (g * 32 + l) * ld;
        float vv[C];
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int col = cc * 32 + lane;
          vv[cc] = col < hd ? v_row[col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = __shfl_sync(kFull, s[r][g], l);
#pragma unroll
          for (int cc = 0; cc < C; ++cc) o[r][cc] = fmaf(p, vv[cc], o[r][cc]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r;
      if (row < Lq) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int col = cc * 32 + lane;
          if (col < hd) out_b[(size_t)row * D + col] = from_float<T>(o[r][cc]);
        }
      }
    }
  }
}

template <typename T, int G, int C>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* mask, void* out, int B, int H, int Lq, int Lk,
           int D, int hd, float scale, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_attention_kernel<T, G, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  masked_attention_kernel<T, G, C><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), H, Lq, Lk, D, hd,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_cols(int col_groups, const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, int B, int H, int Lq,
                int Lk, int D, int hd, float scale, size_t smem,
                cudaStream_t stream) {
  switch (col_groups) {
    case 1: return launch<T, G, 1>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, smem, stream);
    case 2: return launch<T, G, 2>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, smem, stream);
    default: return launch<T, G, 4>(q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, smem, stream);
  }
}

template <typename T>
int launch_keys(int key_groups, int col_groups, const void* q, const void* k,
                const void* v, const unsigned char* mask, void* out, int B,
                int H, int Lq, int Lk, int D, int hd, float scale, size_t smem,
                cudaStream_t stream) {
  if (key_groups <= 1)
    return launch_cols<T, 1>(col_groups, q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, smem, stream);
  if (key_groups <= 2)
    return launch_cols<T, 2>(col_groups, q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, smem, stream);
  if (key_groups <= 4)
    return launch_cols<T, 4>(col_groups, q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, smem, stream);
  return launch_cols<T, 8>(col_groups, q, k, v, mask, out, B, H, Lq, Lk, D, hd, scale, smem, stream);
}

}  // namespace

extern "C" {

// Limits of the kernel, for the wrapper's checks.
int masked_attention_max_keys() { return 32 * kMaxKeyGroups; }
int masked_attention_max_head_dim() { return 32 * kMaxColGroups; }

// Dynamic shared memory the launch needs, in bytes.
size_t masked_attention_smem_bytes(int Lk, int hd) {
  return smem_floats(Lk, hd) * sizeof(float);
}

const char* masked_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out (B, Lq, D); k, v (B, Lk, D); all contiguous and of one type:
// dtype 0 = float32, 1 = bfloat16. mask (B, Lk) bytes, non-zero = ignore the
// key, or null. D = H * hd, hd <= 128, Lk <= 256. scale multiplies q before
// the product (the caller passes hd^-0.5 rounded to fp32 as PyTorch does).
int masked_attention(const void* q, const void* k, const void* v,
                     const unsigned char* mask, void* out, int B, int Lq,
                     int Lk, int D, int H, int dtype, float scale,
                     void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 1 || D % H != 0 ||
      (dtype != 0 && dtype != 1) || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = D / H;
  if (hd > 32 * kMaxColGroups || Lk > 32 * kMaxKeyGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = masked_attention_smem_bytes(Lk, hd);
  const int key_groups = (Lk + 31) / 32;
  const int col_groups = hd <= 32 ? 1 : (hd <= 64 ? 2 : 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_keys<float>(key_groups, col_groups, q, k, v, mask, out, B, H,
                              Lq, Lk, D, hd, scale, smem, s);
  return launch_keys<__nv_bfloat16>(key_groups, col_groups, q, k, v, mask, out,
                                    B, H, Lq, Lk, D, hd, scale, smem, s);
}

}  // extern "C"
