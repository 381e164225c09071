// Coarse-stage scoring for Hopper (sm_90a): per-stride-segment max of the
// frame <-> query similarity, without materializing the (Q, L) score matrix.
//
//   out[b, q, s] = max_{f in [s*stride, (s+1)*stride), f < min(ctx_l[b], L)}
//                    sum_d feats[b, f, d] * cls[b, q, d]
//   and -1e30 for a segment with no valid frame.
//
// Replaces the TPU kernel cone_tpu/ops/pallas_coarse.py:66
// coarse_segment_max (body _kernel, :31-62).
//
// Bound on the card: the feature stream. Every frame row is read once
// (MAD: 36864 x 512 fp32 = 75.5 MB) against 2*Q*D flops per frame, about
// 16 flops per byte at Q = 32, so the least time is the stream's. A kernel
// reaches it only if nothing else is slower than the stream, and on the
// fp32 FMA pipes the product is: both operands come from shared memory.
// The design:
//   * the product runs on the tensor cores as 3xTF32: every fp32 operand is
//     split into a TF32 high part and a residual, and mma.sync.m16n8k8 adds
//     hi*hi + hi*lo + lo*hi in fp32 (what is dropped is about 2^-20 of
//     |f||c|, inside the 1e-5 tolerance). Frames are M, queries N, D is K;
//   * a block owns a run of `segs_per_block` consecutive segments of one
//     video and stages the query matrix once for the whole run (rows of
//     D + 4 floats: fragment loads hit 32 different banks). One block per
//     SM, sixteen warps (eight when a warp carries more than 32 queries);
//   * a warp's work item is 16 frames x NTW 8-query tiles; it walks D in
//     chunks of 32 columns (128-byte row pieces) through a ring of three
//     buffers of its own in shared memory, filled by 16-byte cp.async: two
//     chunks are in flight while the third is multiplied (deeper rings and
//     wider chunks measured no faster: sixteen warps an SM keep enough
//     bytes in flight). The ring is private to the warp, so the loop over
//     the stream has no block-wide barrier, only cp.async.wait_group and
//     __syncwarp. Items go round-robin over the warps, and a warp streams
//     straight on from one item into the next;
//   * NTW is the one template parameter (1, 2, 4, 8, 16). The launcher
//     takes the smallest that still gives every item a warp of its own: at
//     MAD a warp carries all 32 queries of its frames, at Ego4D (one
//     45-frame segment per block) the 4 query tiles of a frame tile go to 4
//     warps, so 12 warps share the segment instead of 3;
//   * tiles do not align with segments (strides 45 and 62 are no multiples
//     of 16): a 16-frame tile that touches at most two segments reduces
//     both maxima across its lanes by shuffles, any other takes the
//     element-wise path; either way the (segment, query) maxima of the
//     run meet in shared memory by an order-free float atomic max, and the
//     block writes them once. Blocks never share a segment, so out needs
//     no pre-fill and the result is deterministic;
//   * frames at or past min(ctx_l, L) are neither loaded nor counted; the
//     caller never pads the feature stream.
//
// C interface, loaded with ctypes. The launch goes on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileD = 32;           // columns per chunk: four k-steps of 8
constexpr int kTileLd = kTileD + 4;  // padded chunk row, floats
constexpr int kStageFloats = 16 * kTileLd;  // one stage: 16 frames of a chunk
constexpr int kStages = 3;           // two chunks in flight while a warp multiplies the third
constexpr int kMaxQ = 128;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;     // opt-in dynamic shared memory of a block
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// warps of a block: sixteen while a warp's sums fit 128 registers a thread
__host__ __device__ inline int warps_of(int ntw) { return ntw <= 4 ? 16 : 8; }

struct Layout {
  int ntw, warps, qpad, cls_ld;
  size_t bytes;
};

__host__ __device__ inline Layout layout_with(int ntw, int Q, int D, int spb) {
  Layout lay;
  lay.ntw = ntw;
  lay.warps = warps_of(ntw);
  lay.qpad = ceil_div(ceil_div(Q, 8), ntw) * ntw * 8;
  lay.cls_ld = ceil_div(D, kTileD) * kTileD + 4;
  lay.bytes = 4 * ((size_t)lay.qpad * lay.cls_ld + (size_t)spb * lay.qpad +
                   (size_t)lay.warps * kStages * kStageFloats);
  return lay;
}

// NTW, the 8-query tiles of a warp's item: all of them (rounded up to a
// power of two) when the run has enough 16-frame tiles for every warp, else
// halved while every (frame tile, query group) item still gets its own warp
// and the block's shared memory still holds the layout.
__host__ __device__ inline Layout layout_of(int Q, int D, int L, int stride, int spb) {
  const int n_qt = ceil_div(Q, 8);
  int ntw = 1;
  while (ntw < n_qt) ntw *= 2;
  const long long run = (long long)spb * stride;
  const int m_tiles = ceil_div((int)(run < L ? run : L), 16);
  while (ntw > 1 && m_tiles * ceil_div(n_qt, ntw / 2) <= warps_of(ntw / 2) &&
         layout_with(ntw / 2, Q, D, spb).bytes <= (size_t)kMaxSmem)
    ntw /= 2;
  return layout_with(ntw, Q, D, spb);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// max into a shared float, whatever the signs: ints order non-negative
// floats, unsigned ints order negative ones the other way round
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

template <int NTW>
__global__ void __launch_bounds__(32 * (NTW <= 4 ? 16 : 8))
coarse_segment_max_kernel(const float* __restrict__ feats,
                          const float* __restrict__ cls,
                          const int* __restrict__ ctx_l,
                          float* __restrict__ out, int L, int D, int Q,
                          int stride, int n_seg, int spb, int qpad) {
  extern __shared__ __align__(16) float smem[];
  const int n_warps = blockDim.x >> 5;
  const int kchunks = ceil_div(D, kTileD);
  const int cls_ld = kchunks * kTileD + 4;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float* cls_s = smem;                                  // (qpad, cls_ld)
  float* red_s = cls_s + (size_t)qpad * cls_ld;         // (spb, qpad)
  float* ring_s = red_s + (size_t)spb * qpad            // (warps, kStages, 16, kTileLd)
                  + (size_t)warp * kStages * kStageFloats;

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * spb;
  const float* feats_b = feats + (size_t)b * L * D;
  const float* cls_b = cls + (size_t)b * Q * D;

  const int f0 = s0 * stride;  // first frame of the run
  // one past the last frame that counts: the run's end, the stream's end
  // and the video's length
  const int lim = min(min((s0 + spb) * stride, L), max(ctx_l[b], 0));
  const int n_qt = ceil_div(Q, 8);        // query tiles that hold a query
  const int n_groups = qpad / (8 * NTW);  // query groups: items per frame tile
  const int n_items = lim > f0 ? ceil_div(lim - f0, 16) * n_groups : 0;
  // this warp's items are warp, warp + n_warps, ...; a step is one chunk of one
  const int my_items = n_items > warp ? ceil_div(n_items - warp, n_warps) : 0;
  const int n_steps = my_items * kchunks;

  // the query matrix, once per block; rows past Q and columns past D zero
  {
    const int c4 = cls_ld / 4 - 1;  // 16-byte pieces per row, padding left out
    for (int i = tid; i < qpad * c4; i += blockDim.x) {
      const int q = i / c4;
      const int c = (i - q * c4) * 4;
      float* d = cls_s + q * cls_ld + c;
      if (q < Q && c < D)
        cp_async16(d, cls_b + (size_t)q * D + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < spb * qpad; i += blockDim.x) red_s[i] = kNegInf;
  }

  // The loader runs kStages - 1 steps ahead of the multiplier. A chunk is 16 rows of
  // 8 pieces: this lane copies the piece at column ld_c of rows ld_r,
  // ld_r + 4, ld_r + 8, ld_r + 12.
  const int ld_r = lane >> 3, ld_c = (lane & 7) * 4;
  const size_t four_rows = 4 * (size_t)D;
  float* ld_dst = ring_s + ld_r * kTileLd + ld_c;  // in stage 0; the others kStageFloats apart
  int ld_item = warp, ld_kc = 0, ld_slot = 0, ld_left = n_steps;
  int ld_fr = f0 + (ld_item / n_groups) * 16 + ld_r;        // this lane's first frame of the item
  const float* ld_src = feats_b + (size_t)ld_fr * D + ld_c;  // ... its piece of chunk 0
  auto issue_next = [&]() {
    if (ld_left > 0) {
      float* d = ld_dst + ld_slot * kStageFloats;
      if (ld_kc * kTileD + ld_c < D) {
        const float* src = ld_src + ld_kc * kTileD;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ld_fr + 4 * i < lim) cp_async16(d + 4 * i * kTileLd, src + i * four_rows);
      } else {  // columns past D meet zeros, never stale bits
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(d + 4 * i * kTileLd) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      --ld_left;
      if (++ld_slot == kStages) ld_slot = 0;
      if (++ld_kc == kchunks) {
        ld_kc = 0;
        ld_item += n_warps;
        ld_fr = f0 + (ld_item / n_groups) * 16 + ld_r;
        ld_src = feats_b + (size_t)ld_fr * D + ld_c;
      }
    }
    cp_async_commit();  // one group per step, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue_next();
  cp_async_wait<0>();
  __syncthreads();  // the query matrix and the maxima's start values are in place

  float acc_hi[NTW][4], acc_lo[NTW][4];  // hi*hi, and hi*lo + lo*hi
  int item = warp, kc = 0, slot = 0;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // this step's chunk landed; the stage refilled next is read out
    issue_next();
    const int m_tile = item / n_groups;
    const int qt0 = (item - m_tile * n_groups) * NTW;  // first query tile of the item
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_hi[n][e] = acc_lo[n][e] = 0.f;
    }
    {
      const float* a_s = ring_s + slot * kStageFloats + g * kTileLd + t;
      const float* b_s = cls_s + (size_t)(qt0 * 8 + g) * cls_ld + kc * kTileD + t;
#pragma unroll
      for (int ks = 0; ks < kTileD / 8; ++ks) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(a_s[ks * 8], a_hi[0], a_lo[0]);
        split_tf32(a_s[ks * 8 + 8 * kTileLd], a_hi[1], a_lo[1]);
        split_tf32(a_s[ks * 8 + 4], a_hi[2], a_lo[2]);
        split_tf32(a_s[ks * 8 + 8 * kTileLd + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          // no condition on the query tile: tiles past Q meet zero rows, and
          // a branch here would fence one tile's loads off from the next
          uint32_t b_hi[2], b_lo[2];
          split_tf32(b_s[(size_t)n * 8 * cls_ld + ks * 8], b_hi[0], b_lo[0]);
          split_tf32(b_s[(size_t)n * 8 * cls_ld + ks * 8 + 4], b_hi[1], b_lo[1]);
          mma_tf32(acc_lo[n], a_lo, b_hi[0], b_hi[1]);
          mma_tf32(acc_lo[n], a_hi, b_lo[0], b_lo[1]);
          mma_tf32(acc_hi[n], a_hi, b_hi[0], b_hi[1]);
        }
      }
    }
    if (kc == kchunks - 1) {
      // rows g and g + 8 of the frame tile are frames fa and fb; columns 2t
      // and 2t + 1 of query tile n are queries q and q + 1
      const int fr_mt = f0 + m_tile * 16;
      const int fa = fr_mt + g;
      const int fb = fa + 8;
      const int j0 = (fr_mt - f0) / stride;       // first segment touched
      const int edge = f0 + (j0 + 1) * stride;     // first frame of the next
      const int last = min(fr_mt + 16, lim) - 1;   // last frame that counts
      if (last < edge + stride) {
        // at most two segments: reduce both maxima across the eight lanes
        // that share a query, then one atomic per (segment, query)
        const int cut = min(edge, lim);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          if (qt0 + n < n_qt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float va = acc_hi[n][e] + acc_lo[n][e];
              const float vb = acc_hi[n][e + 2] + acc_lo[n][e + 2];
              float lo_m = fmaxf(fa < cut ? va : kNegInf, fb < cut ? vb : kNegInf);
              float hi_m = fmaxf(fa >= edge && fa < lim ? va : kNegInf,
                                 fb >= edge && fb < lim ? vb : kNegInf);
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) {
                lo_m = fmaxf(lo_m, __shfl_xor_sync(kFull, lo_m, o));
                hi_m = fmaxf(hi_m, __shfl_xor_sync(kFull, hi_m, o));
              }
              if (g == 0) {
                const int q = (qt0 + n) * 8 + 2 * t + e;
                atomic_max_float(red_s + j0 * qpad + q, lo_m);
                if (last >= edge) atomic_max_float(red_s + (j0 + 1) * qpad + q, hi_m);
              }
            }
          }
        }
      } else {
        // a stride below 16: a tile spans several segments, element by element
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          if (qt0 + n < n_qt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int f = e < 2 ? fa : fb;
              const int q = (qt0 + n) * 8 + 2 * t + (e & 1);
              if (f < lim)
                atomic_max_float(red_s + ((f - f0) / stride) * qpad + q,
                                 acc_hi[n][e] + acc_lo[n][e]);
            }
          }
        }
      }
    }
    if (++kc == kchunks) { kc = 0; item += n_warps; }
    if (++slot == kStages) slot = 0;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < spb * Q; i += blockDim.x) {
    const int j = i / Q;
    const int q = i - j * Q;
    if (s0 + j < n_seg) out[((size_t)b * Q + q) * n_seg + s0 + j] = red_s[j * qpad + q];
  }
}

template <int NTW>
int launch(const float* feats, const float* cls, const int* ctx_l, float* out,
           int B, int L, int D, int Q, int stride, int n_seg, int spb,
           const Layout& lay, cudaStream_t stream) {
  // shared memory above 48 KB is opted into once per instance and device
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !opted_in[dev]) {
    e = cudaFuncSetAttribute(coarse_segment_max_kernel<NTW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const dim3 grid(ceil_div(n_seg, spb), B);
  coarse_segment_max_kernel<NTW><<<grid, 32 * lay.warps, lay.bytes, stream>>>(
      feats, cls, ctx_l, out, L, D, Q, stride, n_seg, spb, lay.qpad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The layout the launcher derives from a shape: query tiles per item (the
// template instance), warps and the dynamic shared memory of a block in
// bytes (a shape that needs more than a block may have is refused).
void coarse_segment_max_layout(int Q, int D, int L, int stride, int segs_per_block,
                               int* ntw, int* warps, size_t* bytes) {
  const Layout lay = layout_of(Q, D, L, stride, segs_per_block);
  *ntw = lay.ntw;
  *warps = lay.warps;
  *bytes = lay.bytes;
}

const char* coarse_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// feats (B, L, D) fp32, cls (B, Q, D) fp32, ctx_l (B,) int32, out
// (B, Q, n_seg) fp32 with n_seg = ceil(L / stride); all contiguous, device
// pointers 16-byte aligned, D % 4 == 0, 1 <= Q <= 128. A block owns
// segs_per_block consecutive segments of one video (the caller's plan).
int coarse_segment_max_f32(const float* feats, const float* cls,
                           const int* ctx_l, float* out, int B, int L, int D,
                           int Q, int stride, int n_seg, int segs_per_block,
                           void* stream) {
  if (B < 1 || L < 1 || D < 4 || (D & 3) || Q < 1 || Q > kMaxQ || stride < 1 ||
      n_seg != (L + stride - 1) / stride || B > 65535 || segs_per_block < 1 ||
      segs_per_block > n_seg)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout_of(Q, D, L, stride, segs_per_block);
  if (lay.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lay.ntw) {
    case 1: return launch<1>(feats, cls, ctx_l, out, B, L, D, Q, stride, n_seg, segs_per_block, lay, s);
    case 2: return launch<2>(feats, cls, ctx_l, out, B, L, D, Q, stride, n_seg, segs_per_block, lay, s);
    case 4: return launch<4>(feats, cls, ctx_l, out, B, L, D, Q, stride, n_seg, segs_per_block, lay, s);
    case 8: return launch<8>(feats, cls, ctx_l, out, B, L, D, Q, stride, n_seg, segs_per_block, lay, s);
    default: return launch<16>(feats, cls, ctx_l, out, B, L, D, Q, stride, n_seg, segs_per_block, lay, s);
  }
}

}  // extern "C"
