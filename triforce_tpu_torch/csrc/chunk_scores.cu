// Fused chunk scoring for the retrieval-cache build on Hopper (sm_90a).
//
// Replaces the TPU kernel triforce_tpu/ops/retrieval_kernel.py::
// chunk_scores_pallas (its Pallas `_kernel`), in both variants. bf16
// (tf_chunk_scores_bf16):
//
//   score[h, c] = mean_{i < chunk} mean_{g < G} ( q[h, g] . k[h, c*chunk + i] )
//
// with q cast to the cache dtype (bf16) and every product accumulated in
// fp32 — q . chunk_mean(k) by the identity the TPU kernel uses, without
// ever materialising a chunk-mean tensor. Only the live prefill
// [0, prefill) is read; the output is fp32 [Hkv, prefill / chunk].
//
// What bounds it on an H100: each prefill key (D bf16 values) is read once
// and used for 2*G*D FLOPs; at G = 1 that is one FLOP per byte, so it is
// bound by HBM bytes (Hkv * prefill * D * 2 over 3.35 TB/s). There is no
// tensor-core work to do at G = 1, so the kernel is a streaming reduction on
// the CUDA cores: a group of D/8 lanes reads one key as 16-byte vectors
// (a warp reads whole 256-byte rows, fully coalesced), reduces its dot
// products with warp shuffles, and the CTA pools its keys' scores into
// chunk means through shared memory.
//
// int8 (tf_chunk_scores_int8, the Pallas `quant` branch): the cache holds
// int8 codes k8 with fp32 per-token scales ks, and q (fp32, never cast to
// bf16 first) is quantized per (head, row) inside the kernel:
//   qs[g] = max(max_d |q[h, g]| / 127, 1e-20),  q8 = clip(rint(q / qs))
//   score[h, c] = mean_i mean_g ((q8[g] . k8_i) * qs[g]) * ks_i
// i.e. each product is scaled by qs * ks before the group mean, as on the
// TPU. The integer dots run as dp4a (four int8 products into an int32), so
// they are exact; a group of D/16 lanes reads one key's D bytes as 16-byte
// vectors. It reads half the bf16 variant's bytes, plus 4 bytes of scale
// per key, and is bound by them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KEYS = 256;     // keys per CTA (rounded down to whole chunks)
constexpr int MAXG = 8;       // most query rows per KV head (GQA group)

template <int D, int G>
__global__ void __launch_bounds__(THREADS)
cs_kernel(const __nv_bfloat16* __restrict__ q,   // [Hkv, G, D] contiguous
          const __nv_bfloat16* __restrict__ k, long long k_sh, long long k_sr,
          float* __restrict__ out,               // [Hkv, C]
          int n_chunks, int chunk, int chunks_per_cta) {
  constexpr int LPK = D / 8;         // lanes per key
  constexpr int KPW = 32 / LPK;      // keys per warp per step
  __shared__ float sc[KEYS];

  const int h = blockIdx.y;
  const int c0 = blockIdx.x * chunks_per_cta;
  const int nc = min(chunks_per_cta, n_chunks - c0);
  const int nkeys = nc * chunk;
  const int key0 = c0 * chunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPK, kw = lane / LPK;

  // this lane's 8 columns of every query row, in fp32
  float qf[G][8];
  const __nv_bfloat16* qh = q + (long long)h * G * D;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qf[gi][e] = __bfloat162float(qh[gi * D + sub * 8 + e]);
  }

  const __nv_bfloat16* kh = k + (long long)h * k_sh;
  const float inv_g = 1.0f / (float)G;
  for (int kl = warp * KPW + kw; kl - kw < nkeys; kl += (THREADS / 32) * KPW) {
    float dot[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) dot[gi] = 0.f;
    if (kl < nkeys) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          kh + (long long)(key0 + kl) * k_sr + sub * 8);
      const __nv_bfloat16* kv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float kx = __bfloat162float(kv[e]);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) dot[gi] += qf[gi][e] * kx;
      }
    }
    // reduce each key's dot products over its LPK lanes
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], off);
    }
    if (sub == 0 && kl < nkeys) {
      float s = 0.f;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) s += dot[gi];
      sc[kl] = s * inv_g;           // GQA group mean
    }
  }
  __syncthreads();
  const float inv_c = 1.0f / (float)chunk;
  for (int c = tid; c < nc; c += THREADS) {
    float s = 0.f;
    for (int i = 0; i < chunk; ++i) s += sc[c * chunk + i] * inv_c;
    out[(long long)h * n_chunks + c0 + c] = s;
  }
}

template <int D>
int launch_d(const void* q, const void* k, long long k_sh, long long k_sr,
             void* out, int g, int n_chunks, int chunk, int cpc, dim3 grid,
             cudaStream_t st) {
#define TF_CS_CASE(GG)                                                      \
  case GG:                                                                  \
    cs_kernel<D, GG><<<grid, THREADS, 0, st>>>(                             \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, k_sh, k_sr,       \
        (float*)out, n_chunks, chunk, cpc);                                 \
    break;
  switch (g) {
    TF_CS_CASE(1) TF_CS_CASE(2) TF_CS_CASE(3) TF_CS_CASE(4)
    TF_CS_CASE(5) TF_CS_CASE(6) TF_CS_CASE(7) TF_CS_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TF_CS_CASE
  return (int)cudaGetLastError();
}

// int8 codes: q fp32 [Hkv, G, D] contiguous; ks fp32 [Hkv, S] scales
template <int D, int G>
__global__ void __launch_bounds__(THREADS)
cs_int8_kernel(const float* __restrict__ q,
               const int8_t* __restrict__ k, long long k_sh, long long k_sr,
               const float* __restrict__ ks, long long ks_sh,
               float* __restrict__ out, int n_chunks, int chunk,
               int chunks_per_cta) {
  constexpr int LPK = D / 16;        // lanes per key, 16 codes each
  constexpr int KPW = 32 / LPK;      // keys per warp per step
  __shared__ float sc[KEYS];

  const int h = blockIdx.y;
  const int c0 = blockIdx.x * chunks_per_cta;
  const int nc = min(chunks_per_cta, n_chunks - c0);
  const int nkeys = nc * chunk;
  const int key0 = c0 * chunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPK, kw = lane / LPK;

  // this lane's 16 columns of every query row as packed int8 codes, and
  // each row's scale (its max |q| reduced over the key's LPK lanes)
  int q8[G][4];
  float qs[G];
  const float* qh = q + (long long)h * G * D;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float x[16];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      x[e] = qh[gi * D + sub * 16 + e];
      amax = fmaxf(amax, fabsf(x[e]));
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    qs[gi] = fmaxf(amax / 127.f, 1e-20f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      int packed = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = (int)fminf(fmaxf(rintf(x[w * 4 + b] / qs[gi]), -127.f), 127.f);
        packed |= (c & 0xff) << (8 * b);
      }
      q8[gi][w] = packed;
    }
  }

  const int8_t* kh = k + (long long)h * k_sh;
  const float* ksh = ks + (long long)h * ks_sh;
  for (int kl = warp * KPW + kw; kl - kw < nkeys; kl += (THREADS / 32) * KPW) {
    int dot[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) dot[gi] = 0;
    if (kl < nkeys) {
      const int4 raw = *reinterpret_cast<const int4*>(
          kh + (long long)(key0 + kl) * k_sr + sub * 16);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        dot[gi] = __dp4a(raw.x, q8[gi][0], dot[gi]);
        dot[gi] = __dp4a(raw.y, q8[gi][1], dot[gi]);
        dot[gi] = __dp4a(raw.z, q8[gi][2], dot[gi]);
        dot[gi] = __dp4a(raw.w, q8[gi][3], dot[gi]);
      }
    }
    // each key's integer dots over its LPK lanes (exact)
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], off);
    }
    if (sub == 0 && kl < nkeys) {
      const float kscale = ksh[key0 + kl];
      float s = 0.f;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) s += ((float)dot[gi] * qs[gi]) * kscale;
      sc[kl] = s / (float)G;        // GQA group mean
    }
  }
  __syncthreads();
  const float inv_c = 1.0f / (float)chunk;
  for (int c = tid; c < nc; c += THREADS) {
    float s = 0.f;
    for (int i = 0; i < chunk; ++i) s += sc[c * chunk + i] * inv_c;
    out[(long long)h * n_chunks + c0 + c] = s;
  }
}

template <int D>
int launch_int8_d(const void* q, const void* k, long long k_sh, long long k_sr,
                  const void* ks, long long ks_sh, void* out, int g,
                  int n_chunks, int chunk, int cpc, dim3 grid, cudaStream_t st) {
#define TF_CS8_CASE(GG)                                                     \
  case GG:                                                                  \
    cs_int8_kernel<D, GG><<<grid, THREADS, 0, st>>>(                        \
        (const float*)q, (const int8_t*)k, k_sh, k_sr, (const float*)ks,    \
        ks_sh, (float*)out, n_chunks, chunk, cpc);                          \
    break;
  switch (g) {
    TF_CS8_CASE(1) TF_CS8_CASE(2) TF_CS8_CASE(3) TF_CS8_CASE(4)
    TF_CS8_CASE(5) TF_CS8_CASE(6) TF_CS8_CASE(7) TF_CS8_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TF_CS8_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_chunk_scores_int8(const void* q, const void* k,
                                    long long k_sh, long long k_sr,
                                    const void* ks, long long ks_sh, void* out,
                                    int hkv, int g, int d, int prefill,
                                    int chunk, void* stream) {
  if (g < 1 || g > MAXG || chunk < 1 || chunk > KEYS || prefill % chunk)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = prefill / chunk;
  if (n_chunks == 0) return (int)cudaSuccess;
  const int cpc = KEYS / chunk;
  dim3 grid((n_chunks + cpc - 1) / cpc, hkv);
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128)
    return launch_int8_d<128>(q, k, k_sh, k_sr, ks, ks_sh, out, g, n_chunks,
                              chunk, cpc, grid, st);
  if (d == 64)
    return launch_int8_d<64>(q, k, k_sh, k_sr, ks, ks_sh, out, g, n_chunks,
                             chunk, cpc, grid, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tf_chunk_scores_bf16(const void* q, const void* k,
                                    long long k_sh, long long k_sr, void* out,
                                    int hkv, int g, int d, int prefill,
                                    int chunk, void* stream) {
  if (g < 1 || g > MAXG || chunk < 1 || chunk > KEYS || prefill % chunk)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = prefill / chunk;
  if (n_chunks == 0) return (int)cudaSuccess;
  const int cpc = KEYS / chunk;
  dim3 grid((n_chunks + cpc - 1) / cpc, hkv);
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128)
    return launch_d<128>(q, k, k_sh, k_sr, out, g, n_chunks, chunk, cpc,
                         grid, st);
  if (d == 64)
    return launch_d<64>(q, k, k_sh, k_sr, out, g, n_chunks, chunk, cpc,
                        grid, st);
  return (int)cudaErrorInvalidValue;
}
