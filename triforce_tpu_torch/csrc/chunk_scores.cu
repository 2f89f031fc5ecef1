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
// int8 (tf_chunk_scores_int8, the Pallas `quant` branch): the cache holds
// int8 codes k8 with fp32 per-token scales ks, and q (read as bf16 or
// fp32 and widened to fp32, never rounded to bf16) is quantized per (head,
// row) inside the kernel:
//   qs[g] = max(max_d |q[h, g]| / 127, 1e-20),  q8 = clip(rint(q / qs))
//   score[h, c] = mean_i mean_g ((q8[g] . k8_i) * qs[g]) * ks_i
// i.e. each product is scaled by qs, then by ks, before the group mean, in
// the order of the plain version (ops/retrieval_kernel.py). The integer
// dots are exact.
//
// What bounds it on an H100: every live key is read once and used for
// 2 * G operations per element: G FLOPs a byte in bf16 (1 at Llama2-7B's
// G = 1, 8 at TinyLlama's G = 8), 2G a byte in int8. The tensor cores need
// ~295 (bf16) and ~590 (int8) a byte before they, not the memory, bound a
// kernel, so at every shape this one is bound by HBM bytes: Hkv * prefill *
// 2D (bf16) or Hkv * prefill * (D + 4) (int8 codes and scales) over
// 3.35 TB/s. At TinyLlama's build (Hkv 4, prefill 32K, D 64) that is 16.8
// or 8.9 MB, a few microseconds, so the launch, the ramp and each block's
// prologue weigh as much as the bytes; at Llama2-7B's (Hkv 32, D 128),
// 268 or 138 MB, only the bytes count.
//
// Design.
// - Grid: Hkv x runs of whole chunks, each run about 64 KB of keys, and
//   at least one wave (the SM count times the CTAs one SM holds, from the
//   occupancy calculator: tf_chunk_scores_ctas_per_sm) where the keys
//   allow. The wrapper computes the plan (chunks a block, blocks a head:
//   ops/retrieval_kernel.py::block_plan) and passes it in; block (b, h)
//   scores chunks [b * cpb, min((b + 1) * cpb, C)) of head h. At
//   TinyLlama's build that is one wave of 336-key runs (88 at a served
//   prefill of 8192); at Llama2-7B's, 2048-4096 blocks of 256 (bf16) or
//   512 (int8) keys. One wave of long runs (2736 keys) measured slower
//   there (chip_smoke.py's "b2 plan sweep"): blocks that stream at unequal
//   rates end unequally, while many short blocks are balanced by the
//   hardware's block scheduler; runs shorter than 64 KB pay the prologue
//   and the ring's fill too often. Where 64 KB blocks make little more
//   than a wave (Llama2-7B int8 at a served prefill of 8192: 1.3 waves),
//   one wave of longer runs measured a quarter faster, and two full waves
//   of shorter ones no faster; the plan does not yet take that case
//   (PERF.md).
// - q once per block, into shared memory: bf16 copied; int8 quantized one
//   row a warp (an IEEE division and rintf, as the plain version does, so
//   the codes are bit-equal to it), the row scales beside the codes. Rows
//   G..7 are zeros (the products' N is 8). The ring's first stages are
//   issued before, so the prologue runs under their latency.
// - A ring of STAGES = 3 stages of 16 KB of keys (64 to 256 keys, as many
//   rows as 16 KB holds), filled by 16-byte cp.async copies STAGES - 1
//   tiles ahead of the tile computed, one __syncthreads a tile; 3 CTAs an
//   SM keep up to ~96-144 KB in flight. (A fourth stage costs the third
//   CTA an SM, which the int8 kernel at Llama2-7B's build measured slower;
//   two stages of 32 KB, likewise.) An int8 stage carries its keys' fp32
//   scales (4-byte copies: a run starts at any key), so a key's scale
//   arrives with its codes. Key rows are padded by 16 bytes so that
//   ldmatrix's 8 rows fall in distinct banks. Rows past the run are
//   zero-filled and read nothing: no key at or past the run's end (at most
//   prefill) is read.
// - Products on the tensor cores at every G: 16 keys of a warp as M, the
//   query rows as N (padded to 8), D as the depth, fp32 (bf16,
//   mma.sync.m16n8k16) or exact s32 (int8, m16n8k32) accumulators. Both
//   take 32 bytes of a key row a step, so one ldmatrix.x4 addressing serves
//   both. At G = 1 the padded columns waste 7/8 of each product, which
//   costs nothing at one FLOP a byte. wgmma is not needed: the kernel sits
//   two orders of magnitude below the tensor-core roofline, so only the
//   bytes count.
// - Epilogue: a lane holds 2 of the 8 columns of 2 keys; int8 scales each
//   column's dot by its qs, then by the key's ks; two quad shuffles sum the
//   group, and the group mean goes into a ring of key scores in shared
//   memory. Each tile's completed chunks are pooled at the next barrier by
//   warps, L lanes a chunk (L the largest power of two up to min(chunk,
//   32)), in a fixed order: no atomics, so every launch on the same inputs
//   gives the same bits (a graphed build matches its eager witness).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 8;              // query rows per KV head: the mma's N
constexpr int MAXCHUNK = 256;
constexpr int STAGES = 3;
constexpr int STAGE_KEY_BYTES = 16384;
// key scores wait in shared memory until their chunk is pooled: the chunks
// pooled at tile t start after (t - 1) * TK - chunk, and tile t writes up to
// (t + 1) * TK, so the ring holds 2 * TK + MAXCHUNK scores at least
constexpr int SCORES = 1024;

template <int D, bool QUANT>
struct Tile {
  static constexpr int RB = D * (QUANT ? 1 : 2);   // bytes of a key row
  static constexpr int ROW = RB + 16;              // padded, in shared memory
  static constexpr int TK = STAGE_KEY_BYTES / RB;  // keys a stage
  static constexpr int KSTEPS = RB / 32;           // 32-byte mma depths a row
  static constexpr int MT = TK / 16 / WARPS;       // 16-key tiles a warp a stage
  static constexpr int KEYS = TK * ROW;
  static constexpr int STAGE = KEYS + (QUANT ? TK * 4 : 0);
  static constexpr int BYTES = STAGES * STAGE + MAXG * ROW + (SCORES + MAXG) * 4;
  static_assert(2 * TK + MAXCHUNK <= SCORES, "score ring too small");
  static_assert(MT >= 1 && TK * RB / 16 % THREADS == 0, "tile shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, asynchronously; a dead copy reads
// nothing and fills zeros (src must still be a valid address). The keys'
// copies carry the L2 prefetch-size hint .L2::128B, which timed faster at
// Llama2-7B's build and the same at TinyLlama's.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 x int8 -> int32 (exact)
__device__ __forceinline__ void mma_s8_k32(int (&c)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const void* q;          // [Hkv, G, D] contiguous: bf16, or (int8) fp32
  int q_bf16;             // int8: q is bf16 (else fp32)
  const uint8_t* k;       // one cache layer [Hkv, S, D]; strides in bytes
  long long k_sh, k_sr;
  const float* ks;        // int8: fp32 scales [Hkv, S], token stride 1
  long long ks_sh;
  float* out;             // [Hkv, n_chunks]
  int g, n_chunks, chunk, cpb;
};

template <int D, bool QUANT>
__global__ void __launch_bounds__(THREADS) cs_kernel(const Args a) {
  using T = Tile<D, QUANT>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sq = smem + STAGES * T::STAGE;                    // q rows
  float* sc = reinterpret_cast<float*>(sq + MAXG * T::ROW);  // key scores
  float* sqs = sc + SCORES;                                  // int8 row scales

  const int h = blockIdx.y;
  const int c0 = blockIdx.x * a.cpb;
  const int nc = min(a.cpb, a.n_chunks - c0);
  const int nkeys = nc * a.chunk;
  const int ntiles = (nkeys + T::TK - 1) / T::TK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long key0 = (long long)c0 * a.chunk;
  const uint8_t* kh = a.k + h * a.k_sh + key0 * a.k_sr;
  const float* ksh = QUANT ? a.ks + h * a.ks_sh + key0 : nullptr;

  // tile t of the run into its stage, as one commit group (empty past the
  // last tile); rows past the run are zero-filled
  auto load = [&](int t) {
    if (t < ntiles) {
      uint8_t* st = smem + (t % STAGES) * T::STAGE;
      constexpr int VPR = T::RB / 16;
#pragma unroll
      for (int i = 0; i < T::TK * VPR / THREADS; ++i) {
        const int v = tid + i * THREADS;
        const int r = v / VPR, col = (v % VPR) * 16;
        const int key = t * T::TK + r;
        const bool live = key < nkeys;
        cp_async16(st + r * T::ROW + col, kh + (live ? key * a.k_sr + col : 0), live);
      }
      if constexpr (QUANT) {
        float* ss = reinterpret_cast<float*>(st + T::KEYS);
#pragma unroll
        for (int r = tid; r < T::TK; r += THREADS) {
          const int key = t * T::TK + r;
          const bool live = key < nkeys;
          cp_async4(ss + r, ksh + (live ? key : 0), live);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load(t);

  // q of head h, once per block; rows G..MAXG-1 are zeros
  if constexpr (QUANT) {
    constexpr int PER = D / 32;                    // values of a row a lane
    const long long q0 = (long long)h * a.g * D;
    const float* qf = static_cast<const float*>(a.q) + q0;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + q0;
    for (int gi = warp; gi < MAXG; gi += WARPS) {
      const bool row = gi < a.g;
      float x[PER];
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = gi * D + lane * PER + e;
        x[e] = !row ? 0.f : a.q_bf16 ? __bfloat162float(qb[i]) : qf[i];
        amax = fmaxf(amax, fabsf(x[e]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float s = fmaxf(amax / 127.f, 1e-20f);
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int c = row ? (int)fminf(fmaxf(rintf(x[e] / s), -127.f), 127.f) : 0;
        packed |= ((uint32_t)c & 0xffu) << (8 * e);
      }
      if constexpr (PER == 4)
        *reinterpret_cast<uint32_t*>(sq + gi * T::ROW + lane * 4) = packed;
      else
        *reinterpret_cast<uint16_t*>(sq + gi * T::ROW + lane * 2) = (uint16_t)packed;
      if (lane == 0) sqs[gi] = row ? s : 0.f;
    }
  } else {
    constexpr int VPR = T::RB / 16;
    const uint8_t* qh = static_cast<const uint8_t*>(a.q) + (long long)h * a.g * T::RB;
    for (int v = tid; v < MAXG * VPR; v += THREADS) {
      const int r = v / VPR, col = (v % VPR) * 16;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < a.g) x = *reinterpret_cast<const uint4*>(qh + r * T::RB + col);
      *reinterpret_cast<uint4*>(sq + r * T::ROW + col) = x;
    }
  }
  __syncthreads();

  // the B operand (q^T, 8 columns) of every depth step, and (int8) the
  // scales of this lane's two columns
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t bq[T::KSTEPS][2];
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk) {
    bq[kk][0] = *reinterpret_cast<const uint32_t*>(sq + gid * T::ROW + kk * 32 + tig * 4);
    bq[kk][1] = *reinterpret_cast<const uint32_t*>(sq + gid * T::ROW + kk * 32 + 16 + tig * 4);
  }
  float qs0 = 0.f, qs1 = 0.f;
  if constexpr (QUANT) {
    qs0 = sqs[2 * tig];
    qs1 = sqs[2 * tig + 1];
  }

  const float inv_g = 1.f / (float)a.g;
  const float inv_c = 1.f / (float)a.chunk;
  int L = 1;                         // lanes a chunk when pooling
  while (2 * L <= min(a.chunk, 32)) L *= 2;

  // chunks [from, to) of the run: L lanes a chunk sum its key scores, then
  // reduce by shuffles, in a fixed order
  auto pool = [&](int from, int to) {
    const int per = 32 / L, sub = lane & (L - 1);
    for (int base = from + warp * per; base < to; base += WARPS * per) {
      const int c = base + lane / L;
      float s = 0.f;
      if (c < to)
        for (int i = sub; i < a.chunk; i += L)
          s += sc[(c * a.chunk + i) & (SCORES - 1)];
      for (int off = L / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (c < to && sub == 0) a.out[(long long)h * a.n_chunks + c0 + c] = s * inv_c;
    }
    return to;
  };

  // this lane's ldmatrix row and 16-byte column within a warp's 16 keys
  const int arow = lane & 15, acol = (lane >> 4) * 16;
  int pooled = 0;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();     // this thread's copies of tile t landed
    __syncthreads();                 // everyone's; and tile t - 1 is done
    load(t + STAGES - 1);            // into the stage tile t - 1 used
    pooled = pool(pooled, t * T::TK / a.chunk);
    const uint8_t* st = smem + (t % STAGES) * T::STAGE;
#pragma unroll
    for (int m = 0; m < T::MT; ++m) {
      const int r0 = (warp * T::MT + m) * 16;
      if (t * T::TK + r0 >= nkeys) break;
      float lo, hi;                  // this lane's two columns, keys gid, gid + 8
      if constexpr (QUANT) {
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          uint32_t r[4];
          ldsm_x4(r, st + (r0 + arow) * T::ROW + kk * 32 + acol);
          mma_s8_k32(c, r, bq[kk][0], bq[kk][1]);
        }
        const float* ss = reinterpret_cast<const float*>(st + T::KEYS);
        const float k_lo = ss[r0 + gid], k_hi = ss[r0 + gid + 8];
        lo = ((float)c[0] * qs0) * k_lo + ((float)c[1] * qs1) * k_lo;
        hi = ((float)c[2] * qs0) * k_hi + ((float)c[3] * qs1) * k_hi;
      } else {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          uint32_t r[4];
          ldsm_x4(r, st + (r0 + arow) * T::ROW + kk * 32 + acol);
          mma_bf16(c, r, bq[kk][0], bq[kk][1]);
        }
        lo = c[0] + c[1];
        hi = c[2] + c[3];
      }
      // the group: the quad's 8 columns
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      if (tig == 0) {
        const int j = t * T::TK + r0 + gid;
        sc[j & (SCORES - 1)] = lo * inv_g;
        sc[(j + 8) & (SCORES - 1)] = hi * inv_g;
      }
    }
  }
  __syncthreads();
  pool(pooled, nc);
}

template <int D, bool QUANT>
int launch(const Args& a, int hkv, int bph, cudaStream_t st) {
  constexpr int bytes = Tile<D, QUANT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      cs_kernel<D, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  cs_kernel<D, QUANT><<<dim3(bph, hkv), THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool QUANT>
int ctas_per_sm() {
  constexpr int bytes = Tile<D, QUANT>::BYTES;
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      cs_kernel<D, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cs_kernel<D, QUANT>,
                                                      THREADS, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

// checks the envelope and the plan (bph blocks of cpb chunks cover the
// chunks of a head, none of them empty), then launches
template <bool QUANT>
int run(Args a, int hkv, int d, int prefill, int bph, void* stream) {
  if (a.g < 1 || a.g > MAXG || a.chunk < 1 || a.chunk > MAXCHUNK ||
      prefill < 0 || prefill % a.chunk || hkv < 1 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  a.n_chunks = prefill / a.chunk;
  if (a.n_chunks == 0) return (int)cudaSuccess;
  if (a.cpb < 1 || bph < 1 || (long long)bph * a.cpb < a.n_chunks ||
      (long long)(bph - 1) * a.cpb >= a.n_chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128) return launch<128, QUANT>(a, hkv, bph, st);
  if (d == 64) return launch<64, QUANT>(a, hkv, bph, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// CTAs of the kernel for head_dim d (int8 codes if quant) that one SM holds
// at once; a negative cudaError_t on failure
extern "C" int tf_chunk_scores_ctas_per_sm(int d, int quant) {
  if (d == 128) return quant ? ctas_per_sm<128, true>() : ctas_per_sm<128, false>();
  if (d == 64) return quant ? ctas_per_sm<64, true>() : ctas_per_sm<64, false>();
  return -(int)cudaErrorInvalidValue;
}

// q bf16 [Hkv, G, D] contiguous; k bf16, strides in elements; the plan:
// cpb chunks a block, bph blocks a head
extern "C" int tf_chunk_scores_bf16(const void* q, const void* k,
                                    long long k_sh, long long k_sr, void* out,
                                    int hkv, int g, int d, int prefill,
                                    int chunk, int cpb, int bph, void* stream) {
  Args a = {q, 1, (const uint8_t*)k, 2 * k_sh, 2 * k_sr, nullptr, 0,
            (float*)out, g, 0, chunk, cpb};
  return run<false>(a, hkv, d, prefill, bph, stream);
}

// q [Hkv, G, D] contiguous, bf16 (q_bf16 = 1) or fp32; k int8 codes
// (strides in elements = bytes); ks fp32 scales [Hkv, S] (token stride 1,
// head stride ks_sh)
extern "C" int tf_chunk_scores_int8(const void* q, int q_bf16, const void* k,
                                    long long k_sh, long long k_sr,
                                    const void* ks, long long ks_sh, void* out,
                                    int hkv, int g, int d, int prefill,
                                    int chunk, int cpb, int bph, void* stream) {
  Args a = {q, q_bf16, (const uint8_t*)k, k_sh, k_sr, (const float*)ks, ks_sh,
            (float*)out, g, 0, chunk, cpb};
  return run<true>(a, hkv, d, prefill, bph, stream);
}
