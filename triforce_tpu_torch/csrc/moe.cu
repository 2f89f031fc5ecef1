// Sparse (mixture-of-experts) MLP layers for Hopper (sm_90a): the router and
// the experts at decode shapes. The arithmetic is ops/moe.py's (its module
// docstring); the plain versions there define it and the card is held to
// them (tests/test_torch_kernels_cuda.py, chip_smoke.py).
//
// tf_moe_route: one CTA of 256 threads a token. The token's hidden state is
// staged in shared memory as fp32; warp w takes experts w, w + 8, ..., each
// a dot product over the router row (16-byte loads, fp32 FMAs, a butterfly
// sum); warp 0 then takes the softmax (fp32, the row maximum subtracted),
// picks the top k by k rounds of a warp argmax (the larger probability, a
// tie to the lower index), renormalises and writes the ids and weights.
//
// tf_moe_experts: the experts of up to MAX_TOK tokens, three launches on a
// fixed grid, so that a CUDA graph replays them whatever the routing:
//   moe_gate_up_kernel  grid (expert, 64-row tile of I). Warp 0 lists the
//       (token, slot) pairs routed to the CTA's expert (a ballot a 32
//       pairs, in pair order); a CTA with none exits before it reads a
//       weight. Otherwise the routed tokens' rows of h go to shared memory
//       (up to TG = 8 at a time, so once at the decode shapes), and each
//       warp takes 8 rows of the tile: it streams the gate row and the up
//       row once (16-byte loads, U of them in flight a lane), accumulates
//       every routed token's two dot products in fp32, sums them over the
//       warp and writes bf16(silu(g) * u) with silu_mul's rounding
//       (csrc/layer_glue.cu): g and u rounded to bf16, silu rounded, the
//       product rounded.
//   moe_down_kernel     grid (expert, 64-row tile of H): the same over the
//       down rows, the routed pairs' activations staged instead; writes
//       y[pair] = bf16(a . W_down row).
//   moe_combine_kernel  grid (H / 256, token): out = bf16(sum_k w_k y_k),
//       fp32 products and sums in k order (no float atomics: a replay
//       repeats bit for bit).
// Tile 0 of the gate/up grid adds 1 to counts[0] for its expert (the
// distinct experts a layer call read; integer atomics, so the count does
// not depend on the order); the router adds the pairs routed and the layer
// call. counts may be null.
//
// What bounds it: at decode shapes a chosen expert's 3 x I x H bf16 weights
// are read once and used for one FMA a weight a routed token (1 to 8), so
// the layer is bound by the bytes of the experts read over HBM. The grid
// fills the card with CTAs of the chosen experts (42 of 64 at 8 tokens and
// top 8, 14 tiles each: ~4.5 CTAs an SM), each lane keeping 2 U 16-byte
// loads in flight.
//
// tf_moe_combine: the combine alone, for the prefill chunks' grouped GEMM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TOK = 64;   // tokens of one call (ops/moe.py DECODE_TOKENS)
constexpr int TG = 8;         // routed tokens a pass holds
constexpr int ROWS = 64;      // output rows a CTA (8 a warp)
constexpr int U = 3;          // 16-byte loads a lane keeps in flight a row
constexpr int MAX_EXPERTS = 256;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct ExpertArgs {
  const __nv_bfloat16* h;      // [N, H]
  const int* idx;              // [N, K] expert ids
  const float* w;              // [N, K] weights
  const __nv_bfloat16* wg;     // [E, I, H]
  const __nv_bfloat16* wu;     // [E, I, H]
  const __nv_bfloat16* wd;     // [E, H, I]
  __nv_bfloat16* act;          // [N * K, I]
  __nv_bfloat16* y;            // [N * K, H]
  __nv_bfloat16* out;          // [N, H]
  unsigned long long* counts;  // [3] or null
  int n, k, hidden, inter;
};

// The pairs (token * K + slot) routed to expert e, in pair order, into
// list; every thread gets their count. Warp 0 scans, a ballot a 32 pairs.
__device__ __forceinline__ int routed_pairs(const int* idx, int npairs, int e, int* list,
                                            int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int p0 = 0; p0 < npairs; p0 += 32) {
      const int p = p0 + lane;
      const bool hit = p < npairs && idx[p] == e;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      const int at = base + __popc(m & ((1u << lane) - 1u));
      if (hit && at < MAX_TOK) list[at] = p;
      base += __popc(m);
    }
    if (lane == 0) *count = min(base, MAX_TOK);
  }
  __syncthreads();
  return *count;
}

// Stage the rows src[list[g0 + t] / div] (len values each, 16-byte chunks)
// of the pass's ng routed pairs into xs [TG][len].
__device__ __forceinline__ void stage_rows(__nv_bfloat16* xs, const __nv_bfloat16* src,
                                           const int* list, int g0, int ng, int div,
                                           int len) {
  const int nch = len / 8;
  for (int c = threadIdx.x; c < ng * nch; c += THREADS) {
    const int t = c / nch, ch = c % nch;
    const long long row = list[g0 + t] / div;
    reinterpret_cast<uint4*>(xs)[t * nch + ch] =
        reinterpret_cast<const uint4*>(src + row * len)[ch];
  }
}

// One warp's dot products of weight rows (a row: nch 16-byte chunks) with
// the ng staged rows xs, NR rows (a and, NR = 2, b) at once.
template <int NR>
__device__ __forceinline__ void dots(const uint4* ra, const uint4* rb, const __nv_bfloat16* xs,
                                     int nch, int ng, float (&acc)[NR][TG]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int t = 0; t < TG; ++t) acc[r][t] = 0.f;
  for (int c0 = lane; c0 < nch; c0 += 32 * U) {
    uint4 wv[NR][U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int c = c0 + 32 * q;
      if (c < nch) {
        wv[0][q] = __ldg(ra + c);
        if constexpr (NR == 2) wv[NR - 1][q] = __ldg(rb + c);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int c = c0 + 32 * q;
      if (c >= nch) break;
      float wf[NR][8];
#pragma unroll
      for (int r = 0; r < NR; ++r) unpack8(wv[r][q], wf[r]);
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        if (t < ng) {
          float xf[8];
          unpack8(reinterpret_cast<const uint4*>(xs)[t * nch + c], xf);
#pragma unroll
          for (int r = 0; r < NR; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][t] = fmaf(wf[r][i], xf[i], acc[r][t]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int t = 0; t < TG; ++t)
      if (t < ng) acc[r][t] = warp_sum(acc[r][t]);
}

__global__ void __launch_bounds__(THREADS) moe_gate_up_kernel(ExpertArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list[MAX_TOK];
  __shared__ int count;
  const int e = blockIdx.x;
  const int n = routed_pairs(A.idx, A.n * A.k, e, list, &count);
  if (n == 0) return;
  if (blockIdx.y == 0 && threadIdx.x == 0 && A.counts) atomicAdd(A.counts, 1ull);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = A.hidden / 8;
  const long long per_e = (long long)A.inter * A.hidden;
  for (int g0 = 0; g0 < n; g0 += TG) {
    const int ng = min(TG, n - g0);
    __syncthreads();   // the previous pass is done with xs
    stage_rows(xs, A.h, list, g0, ng, A.k, A.hidden);
    __syncthreads();
    for (int r = 0; r < ROWS / WARPS; ++r) {
      const int j = blockIdx.y * ROWS + warp * (ROWS / WARPS) + r;
      if (j >= A.inter) break;
      const long long off = e * per_e + (long long)j * A.hidden;
      float acc[2][TG];
      dots<2>(reinterpret_cast<const uint4*>(A.wg + off),
              reinterpret_cast<const uint4*>(A.wu + off), xs, nch, ng, acc);
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < TG; ++t) {
          if (t < ng) {
            const float g = bf(acc[0][t]), u = bf(acc[1][t]);
            const float a = bf(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))));
            A.act[(long long)list[g0 + t] * A.inter + j] = __float2bfloat16_rn(a * u);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) moe_down_kernel(ExpertArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list[MAX_TOK];
  __shared__ int count;
  const int e = blockIdx.x;
  const int n = routed_pairs(A.idx, A.n * A.k, e, list, &count);
  if (n == 0) return;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = A.inter / 8;
  const long long per_e = (long long)A.hidden * A.inter;
  for (int g0 = 0; g0 < n; g0 += TG) {
    const int ng = min(TG, n - g0);
    __syncthreads();
    stage_rows(xs, A.act, list, g0, ng, 1, A.inter);
    __syncthreads();
    for (int r = 0; r < ROWS / WARPS; ++r) {
      const int j = blockIdx.y * ROWS + warp * (ROWS / WARPS) + r;
      if (j >= A.hidden) break;
      const uint4* row = reinterpret_cast<const uint4*>(A.wd + e * per_e +
                                                        (long long)j * A.inter);
      float acc[1][TG];
      dots<1>(row, row, xs, nch, ng, acc);
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < TG; ++t)
          if (t < ng)
            A.y[(long long)list[g0 + t] * A.hidden + j] = __float2bfloat16_rn(acc[0][t]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(const __nv_bfloat16* y, const float* w, __nv_bfloat16* out, int k,
                   int hidden) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= hidden) return;
  float acc = 0.f;
  for (int s = 0; s < k; ++s)
    acc = __fadd_rn(acc, __fmul_rn(w[t * k + s],
                                   __bfloat162float(y[((long long)t * k + s) * hidden + c])));
  out[(long long)t * hidden + c] = __float2bfloat16_rn(acc);
}

__global__ void __launch_bounds__(THREADS)
moe_route_kernel(const __nv_bfloat16* h, const __nv_bfloat16* wr, int n, int hidden, int ne,
                 int top_k, int norm, int* idx, float* w, unsigned long long* counts) {
  extern __shared__ float xs[];   // [hidden]
  __shared__ float lg[MAX_EXPERTS];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < hidden; c += THREADS)
    xs[c] = __bfloat162float(h[(long long)t * hidden + c]);
  __syncthreads();
  const int nch = hidden / 8;
  for (int e = warp; e < ne; e += WARPS) {
    const uint4* row = reinterpret_cast<const uint4*>(wr + (long long)e * hidden);
    float acc = 0.f;
    for (int c = lane; c < nch; c += 32) {
      float f[8];
      unpack8(__ldg(row + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(f[i], xs[c * 8 + i], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) lg[e] = acc;
  }
  __syncthreads();
  if (warp != 0) return;
  constexpr int PER = MAX_EXPERTS / 32;
  float p[PER];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    p[i] = e < ne ? lg[e] : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    p[i] = lane + 32 * i < ne ? expf(p[i] - mx) : -1.f;
    sum += fmaxf(p[i], 0.f);
  }
  sum = warp_sum(sum);
  float sel = 0.f, chosen_p = 0.f;
  int chosen_e = 0;
  for (int s = 0; s < top_k; ++s) {
    // this lane's best (a tie to the lower index: i ascending), then the warp's
    float bv = -1.f;
    int be = 1 << 30;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (p[i] > bv) { bv = p[i]; be = lane + 32 * i; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oe = __shfl_xor_sync(0xffffffffu, be, off);
      if (ov > bv || (ov == bv && oe < be)) { bv = ov; be = oe; }
    }
    if ((be & 31) == lane) {
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (lane + 32 * i == be) p[i] = -1.f;
    }
    const float pk = bv / sum;
    sel += pk;
    if (lane == s) { chosen_p = pk; chosen_e = be; }
  }
  if (lane < top_k) {
    idx[t * top_k + lane] = chosen_e;
    w[t * top_k + lane] = norm ? chosen_p / sel : chosen_p;
  }
  if (t == 0 && lane == 0 && counts) {
    atomicAdd(counts + 1, (unsigned long long)n * top_k);
    atomicAdd(counts + 2, 1ull);
  }
}

int smem_attr(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// h [N, H] bf16, wr [E, H] bf16 -> idx [N, top_k] int32, w [N, top_k] fp32;
// counts: int64 [3] or null (adds pairs routed and one layer call)
extern "C" int tf_moe_route(const void* h, const void* wr, int n, int hidden, int ne,
                            int top_k, int norm, void* idx, void* w, void* counts,
                            void* stream) {
  if (n <= 0 || hidden % 8 || ne <= 0 || ne > MAX_EXPERTS || top_k <= 0 || top_k > 32 ||
      top_k > ne)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)hidden * sizeof(float);
  int err = smem_attr((const void*)moe_route_kernel, smem);
  if (err) return err;
  moe_route_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)wr, n, hidden, ne, top_k, norm, (int*)idx,
      (float*)w, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

// The experts of N <= 64 tokens (see the top): h [N, H], idx [N, K] int32,
// w [N, K] fp32, wg / wu [E, I, H], wd [E, H, I] bf16; scratch act
// [N K, I], y [N K, H]; out [N, H]; counts int64 [3] or null
extern "C" int tf_moe_experts(const void* h, const void* idx, const void* w, const void* wg,
                              const void* wu, const void* wd, void* act, void* y, void* out,
                              int n, int k, int hidden, int inter, int ne, void* counts,
                              void* stream) {
  if (n <= 0 || n > MAX_TOK || k <= 0 || hidden % 8 || inter % 8 || ne <= 0 ||
      ne > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ExpertArgs A{(const __nv_bfloat16*)h, (const int*)idx, (const float*)w,
               (const __nv_bfloat16*)wg, (const __nv_bfloat16*)wu,
               (const __nv_bfloat16*)wd, (__nv_bfloat16*)act, (__nv_bfloat16*)y,
               (__nv_bfloat16*)out, (unsigned long long*)counts, n, k, hidden, inter};
  const size_t sa = (size_t)TG * hidden * 2, sb = (size_t)TG * inter * 2;
  int err = smem_attr((const void*)moe_gate_up_kernel, sa);
  if (!err) err = smem_attr((const void*)moe_down_kernel, sb);
  if (err) return err;
  moe_gate_up_kernel<<<dim3(ne, (inter + ROWS - 1) / ROWS), THREADS, sa, st>>>(A);
  moe_down_kernel<<<dim3(ne, (hidden + ROWS - 1) / ROWS), THREADS, sb, st>>>(A);
  moe_combine_kernel<<<dim3((hidden + THREADS - 1) / THREADS, n), THREADS, 0, st>>>(
      A.y, A.w, A.out, k, hidden);
  return (int)cudaGetLastError();
}

// out [N, H] = bf16(sum_k w[:, k] y[:, k]) of y [N, K, H] bf16, w [N, K] fp32
extern "C" int tf_moe_combine(const void* y, const void* w, void* out, int n, int k,
                              int hidden, void* stream) {
  if (n <= 0 || n > 65535 || k <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<dim3((hidden + THREADS - 1) / THREADS, n), THREADS, 0,
                       (cudaStream_t)stream>>>((const __nv_bfloat16*)y, (const float*)w,
                                                (__nv_bfloat16*)out, k, hidden);
  return (int)cudaGetLastError();
}
