// Fused decode attention for Hopper (sm_90a): a few query rows per KV head
// against the live prefix of a long bf16 KV cache, fused with the block of
// new tokens being appended by this forward.
//
// Replaces the TPU kernel triforce_tpu/ops/flash_decode.py::flash_decode_append
// (its Pallas `_kernel`, with `_block_scores`, `_block_pv` and
// `_fold_new_and_finalize`), bf16 variant.
//
// What it computes (per KV head h, query row r of GT = G*T rows):
//   q'      = bf16(fp32(q) / sqrt(D))                      (pre-scale, rounded)
//   s_j     = q' . k_j          fp32 accumulation, j in [0, k_len)
//   n_j     = q' . k_new_j + (mask[r, j] ? 0 : -1e30)      j in [0, Tn)
//   m       = max(s, n);  p = exp(s - m), pn = exp(n - m)
//   out     = (bf16(p) . v + bf16(pn) . v_new) / max(sum p + sum pn, 1e-37)
// The output is fp32 [Hkv, GT, D]; the caller casts it to q's dtype.
//
// What bounds it on an H100: at decode shapes (GT <= 8) every cache byte is
// read once and used for a handful of FLOPs, so it is bound by HBM bytes
// (K and V of the live prefix over 3.35 TB/s). At the 512-row prefill tile
// the score and PV products are ~1 KFLOP per cache byte, so it is bound by
// tensor-core operations there.
//
// Design. The TPU kernel walks sequence blocks in order on one core,
// carrying (m, l, acc) in VMEM. Here:
//   phase 1 (fd_split_kernel): grid (split, q-tile, head). Each CTA takes a
//     contiguous share of [0, k_len) and walks it in 64-key tiles staged
//     through shared memory. A warp runs mma.sync m16n8k16 (bf16 in, fp32
//     accumulate) for q.k^T and for p.v on 16 query rows, with an fp32
//     online softmax in registers; p is rounded to bf16 before p.v, as on
//     the TPU. With more than 16 rows each warp owns 16 rows and all keys
//     of a tile; with at most 16 rows (decode) the four warps share the
//     rows and each takes 16 keys of every tile, so a tile costs a quarter
//     of the latency. Every warp-or-CTA writes its partials (m, l, acc) to
//     scratch. Splitting the sequence fills the 132 SMs even at GT = 1.
//   phase 2 (fd_combine_kernel): one CTA per (row, head) merges the splits,
//     folds in the new-token block under the mask bias, and normalises.
// k_len is read from device memory by both phases (no host sync); rows past
// k_len are masked in-kernel, so no cache length needs padding. A layer of
// the stacked [L, B, Hkv, S, D] cache is passed as a pointer plus strides.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int KT = 64;           // keys per shared-memory tile
constexpr int WARPS = 4;         // warps per CTA; each owns 16 query rows
constexpr int QT = 16 * WARPS;   // query rows per CTA
constexpr int PAD = 8;           // bf16 row padding: conflict-free fragments

struct SplitArgs {
  const __nv_bfloat16* q;  long long q_sh, q_sr;
  const __nv_bfloat16* k;  long long k_sh, k_sr;
  const __nv_bfloat16* v;  long long v_sh, v_sr;
  const int* k_len;
  float* m_part;           // [Hkv, GT, nparts]
  float* l_part;           // [Hkv, GT, nparts]
  float* acc_part;         // [Hkv, GT, nparts, D]
  int gt, s, nsplit;       // nsplit CTAs share [0, k_len)
  int nparts;              // partials per row: nsplit (x WARPS if KSPLIT)
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// bf16(fp32(x) * scale): the TPU kernel's pre-scale of q
__device__ __forceinline__ float prescale(__nv_bfloat16 x, float scale) {
  return __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) * scale));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KSPLIT: at most 16 query rows; the warps split each tile's keys
template <int D, bool KSPLIT>
__global__ void __launch_bounds__(WARPS * 32)
fd_split_kernel(SplitArgs P) {
  constexpr int KW = KSPLIT ? KT / WARPS : KT;   // keys per warp per tile
  __shared__ __align__(16) __nv_bfloat16 sK[KT][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 sV[KT][D + PAD];

  const int split = blockIdx.x, qtile = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  int klen = *P.k_len;
  klen = klen < 0 ? 0 : (klen > P.s ? P.s : klen);
  // this CTA's share of [0, klen), a multiple of KT
  int per = (klen + P.nsplit - 1) / P.nsplit;
  per = (per + KT - 1) / KT * KT;
  const int beg = split * per;
  const int end = min(klen, beg + per);

  const int row0 = KSPLIT ? 0 : qtile * QT + warp * 16;
  const bool active = row0 < P.gt;
  const int kw0 = KSPLIT ? warp * KW : 0;        // this warp's tile keys
  const int part = KSPLIT ? split * WARPS + warp : split;
  const int ra = row0 + g, rb = row0 + g + 8;   // this thread's two rows

  // q fragments (A operand, row-major 16 x D) for rows ra / rb
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qh = P.q + (long long)h * P.q_sh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
      const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
      if (ra < P.gt) {
        const __nv_bfloat16* r = qh + (long long)ra * P.q_sr;
        x[0] = prescale(r[c0], P.scale); x[1] = prescale(r[c0 + 1], P.scale);
        x[4] = prescale(r[c1], P.scale); x[5] = prescale(r[c1 + 1], P.scale);
      }
      if (rb < P.gt) {
        const __nv_bfloat16* r = qh + (long long)rb * P.q_sr;
        x[2] = prescale(r[c0], P.scale); x[3] = prescale(r[c0 + 1], P.scale);
        x[6] = prescale(r[c1], P.scale); x[7] = prescale(r[c1 + 1], P.scale);
      }
      qa[kk][0] = pack_bf16(x[0], x[1]);   // (row g,   cols 2t..2t+1)
      qa[kk][1] = pack_bf16(x[2], x[3]);   // (row g+8, cols 2t..2t+1)
      qa[kk][2] = pack_bf16(x[4], x[5]);   // (row g,   cols 2t+8..)
      qa[kk][3] = pack_bf16(x[6], x[7]);   // (row g+8, cols 2t+8..)
    }
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const __nv_bfloat16* kh = P.k + (long long)h * P.k_sh;
  const __nv_bfloat16* vh = P.v + (long long)h * P.v_sh;
  constexpr int VEC = D / 8;   // 16-byte vectors per row

  for (int kb = beg; kb < end; kb += KT) {
    __syncthreads();   // the previous tile is consumed
    for (int c = tid; c < KT * VEC; c += WARPS * 32) {
      const int r = c / VEC, col = (c % VEC) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (kb + r < end) {
        kx = *reinterpret_cast<const uint4*>(kh + (long long)(kb + r) * P.k_sr + col);
        vx = *reinterpret_cast<const uint4*>(vh + (long long)(kb + r) * P.v_sr + col);
      }
      *reinterpret_cast<uint4*>(&sK[r][col]) = kx;
      *reinterpret_cast<uint4*>(&sV[r][col]) = vx;
    }
    __syncthreads();
    if (!active) continue;

    // scores: S[16 x KW] = q'[16 x D] . K^T over this warp's tile keys
    float sc[KW / 8][4];
#pragma unroll
    for (int n = 0; n < KW / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const int kr = kw0 + n * 8 + g;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sK[kr][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sK[kr][kk * 16 + 2 * t + 8]);
        mma_bf16(sc[n], qa[kk], b0, b1);
      }
    }
    // mask keys past the share's end; row maxima over the tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < KW / 8; ++n) {
      const int key = kb + kw0 + n * 8 + 2 * t;
      if (key >= end)     { sc[n][0] = -INFINITY; sc[n][2] = -INFINITY; }
      if (key + 1 >= end) { sc[n][1] = -INFINITY; sc[n][3] = -INFINITY; }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m_r[0], mx0), mn1 = fmaxf(m_r[1], mx1);
    // a row with nothing valid yet keeps alpha 1 and p 0
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = expf(m_r[0] - base0), al1 = expf(m_r[1] - base1);
    m_r[0] = mn0; m_r[1] = mn1;

    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < KW / 8; ++n) {
      sc[n][0] = expf(sc[n][0] - base0); sc[n][1] = expf(sc[n][1] - base0);
      sc[n][2] = expf(sc[n][2] - base1); sc[n][3] = expf(sc[n][3] - base1);
      ls0 += sc[n][0] + sc[n][1];
      ls1 += sc[n][2] + sc[n][3];
    }
    l_r[0] = l_r[0] * al0 + ls0;
    l_r[1] = l_r[1] * al1 + ls1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }

    // acc[16 x D] += bf16(p)[16 x KW] . V[KW x D]
#pragma unroll
    for (int j = 0; j < KW / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const int r0 = kw0 + j * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 =
            (uint32_t)__bfloat16_as_ushort(sV[r0][col]) |
            ((uint32_t)__bfloat16_as_ushort(sV[r0 + 1][col]) << 16);
        const uint32_t b1 =
            (uint32_t)__bfloat16_as_ushort(sV[r0 + 8][col]) |
            ((uint32_t)__bfloat16_as_ushort(sV[r0 + 9][col]) << 16);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  if (!active) return;
  // per-thread row sums -> row sums (the 4 threads t of a row)
  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 1);
  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 2);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 1);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 2);

  const long long hrow = (long long)h * P.gt;
  if (ra < P.gt) {
    const long long o = (hrow + ra) * P.nparts + part;
    if (t == 0) { P.m_part[o] = m_r[0]; P.l_part[o] = l_r[0]; }
    float* a = P.acc_part + o * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      a[n * 8 + 2 * t] = acc[n][0];
      a[n * 8 + 2 * t + 1] = acc[n][1];
    }
  }
  if (rb < P.gt) {
    const long long o = (hrow + rb) * P.nparts + part;
    if (t == 0) { P.m_part[o] = m_r[1]; P.l_part[o] = l_r[1]; }
    float* a = P.acc_part + o * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      a[n * 8 + 2 * t] = acc[n][2];
      a[n * 8 + 2 * t + 1] = acc[n][3];
    }
  }
}

struct CombineArgs {
  const __nv_bfloat16* q;   long long q_sh, q_sr;
  const __nv_bfloat16* kn;  long long kn_sh, kn_sr;
  const __nv_bfloat16* vn;  long long vn_sh, vn_sr;
  const uint8_t* mask;      // [GT, Tn], 1 = attend
  const float* m_part;
  const float* l_part;
  const float* acc_part;
  float* out;               // [Hkv, GT, D]
  int gt, tn, nparts;
  float scale;
};

// one CTA per (row, head); thread d owns output column d
template <int D>
__global__ void __launch_bounds__(128)
fd_combine_kernel(CombineArgs P) {
  extern __shared__ float sn[];           // [Tn] new-token scores
  __shared__ float sq[D];
  __shared__ float red[4];
  const int row = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qr = P.q + (long long)h * P.q_sh + (long long)row * P.q_sr;
  for (int d = tid; d < D; d += 128) sq[d] = prescale(qr[d], P.scale);

  // merge the split partials
  const long long o = ((long long)h * P.gt + row) * P.nparts;
  float M = -INFINITY;
  for (int s = 0; s < P.nparts; ++s) M = fmaxf(M, P.m_part[o + s]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < P.nparts; ++s) {
    const float ms = P.m_part[o + s];
    const float w = ms == -INFINITY ? 0.f : expf(ms - M);
    L += P.l_part[o + s] * w;
    if (tid < D) acc += P.acc_part[(o + s) * D + tid] * w;
  }
  __syncthreads();

  // new-token scores, one warp per new token
  const __nv_bfloat16* knh = P.kn + (long long)h * P.kn_sh;
  for (int j = warp; j < P.tn; j += 4) {
    const __nv_bfloat16* kr = knh + (long long)j * P.kn_sr;
    float part = 0.f;
    for (int d = lane; d < D; d += 32) part += sq[d] * __bfloat162float(kr[d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0)
      sn[j] = part + (P.mask[(long long)row * P.tn + j] ? 0.f : -1e30f);
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = tid; j < P.tn; j += 128) mx = fmaxf(mx, sn[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  const float mn = fmaxf(M, mx);
  const float alpha = expf(M - mn);   // M = -inf (empty cache) -> 0

  float ln = 0.f, an = 0.f;
  const __nv_bfloat16* vnh = P.vn + (long long)h * P.vn_sh;
  for (int j = 0; j < P.tn; ++j) {
    const float p = expf(sn[j] - mn);
    ln += p;
    if (tid < D)
      an += __bfloat162float(__float2bfloat16_rn(p)) *
            __bfloat162float(vnh[(long long)j * P.vn_sr + tid]);
  }
  L = L * alpha + ln;
  acc = acc * alpha + an;
  if (tid < D)
    P.out[((long long)h * P.gt + row) * D + tid] = acc / fmaxf(L, 1e-37f);
}

template <int D>
int launch(const SplitArgs& sa, const CombineArgs& ca, int hkv, cudaStream_t st) {
  const int nq = (sa.gt + QT - 1) / QT;
  if (sa.gt <= 16)
    fd_split_kernel<D, true><<<dim3(sa.nsplit, 1, hkv), WARPS * 32, 0, st>>>(sa);
  else
    fd_split_kernel<D, false><<<dim3(sa.nsplit, nq, hkv), WARPS * 32, 0, st>>>(sa);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)ca.tn * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fd_combine_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fd_combine_kernel<D><<<dim3(ca.gt, hkv), 128, smem, st>>>(ca);
  return (int)cudaGetLastError();
}

// Partials per query row phase 1 writes: one per split, and one per warp of
// each split when the warps split the keys (GT <= 16). The wrapper sizes its
// scratch by tf_flash_decode_parts, so this is the only place it is decided.
int n_parts(int gt, int nsplit) { return gt <= 16 ? nsplit * WARPS : nsplit; }

}  // namespace

extern "C" int tf_flash_decode_parts(int gt, int nsplit) {
  return n_parts(gt, nsplit);
}

extern "C" int tf_flash_decode_bf16(
    const void* q, long long q_sh, long long q_sr,
    const void* k, long long k_sh, long long k_sr,
    const void* v, long long v_sh, long long v_sr,
    const void* kn, long long kn_sh, long long kn_sr,
    const void* vn, long long vn_sh, long long vn_sr,
    const void* mask, const void* k_len,
    void* m_part, void* l_part, void* acc_part, void* out,
    int hkv, int gt, int tn, int s, int d, int nsplit, float scale,
    void* stream) {
  if (hkv <= 0 || gt <= 0 || tn <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  const int nparts = n_parts(gt, nsplit);
  SplitArgs sa{(const __nv_bfloat16*)q, q_sh, q_sr,
               (const __nv_bfloat16*)k, k_sh, k_sr,
               (const __nv_bfloat16*)v, v_sh, v_sr,
               (const int*)k_len, (float*)m_part, (float*)l_part,
               (float*)acc_part, gt, s, nsplit, nparts, scale};
  CombineArgs ca{(const __nv_bfloat16*)q, q_sh, q_sr,
                 (const __nv_bfloat16*)kn, kn_sh, kn_sr,
                 (const __nv_bfloat16*)vn, vn_sh, vn_sr,
                 (const uint8_t*)mask, (const float*)m_part,
                 (const float*)l_part, (const float*)acc_part, (float*)out,
                 gt, tn, nparts, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128) return launch<128>(sa, ca, hkv, st);
  if (d == 64) return launch<64>(sa, ca, hkv, st);
  return (int)cudaErrorInvalidValue;
}
