// Fused decode attention for Hopper (sm_90a): a few query rows per KV head
// against the live prefix of a long KV cache (bf16, or int8 codes with fp32
// per-token scales), fused with the block of new tokens being appended by
// this forward.
//
// Replaces the TPU kernel triforce_tpu/ops/flash_decode.py::flash_decode_append
// (its Pallas `_kernel`, with `_block_scores`, `_block_pv` and
// `_fold_new_and_finalize`), in both variants: bf16 (entry point
// tf_flash_decode_bf16) and int8 KV (tf_flash_decode_int8, the `quant`
// branch), and its row-batched sibling flash_decode_append_batched (Pallas
// `_kernel_batched`): B rows at once, each with its own live length and its
// own mask (tf_flash_decode_batched_bf16 / _int8). The batched entry points
// run the same device code with the row as one more grid index; the
// single-row ones are the case B = 1.
//
// It also replaces triforce_tpu/ops/flash_decode.py::flash_decode_partials
// (Pallas `_kernel_partials`): the same walk over the live prefix WITHOUT the
// new-token fold and WITHOUT the normalisation, returning the online-softmax
// state (m [Hkv, GT], l [Hkv, GT], acc [Hkv, GT, D]) so that the caller can
// merge it with other partials (the tree grow's staged and self blocks; a
// sequence shard's neighbours). Entry points tf_flash_decode_partials_bf16 /
// _int8: phase 1 as below, then a merge that stops before the fold
// (fd_reduce_kernel on the decode path, fd_merge_kernel on the wide one). An
// empty prefix (k_len = 0) returns m = -1e30, l = 0, acc = 0, the state the
// TPU kernel starts from, never -inf: merging two -inf maxima would be NaN.
//
// What it computes (per KV head h, query row r of GT = G*T rows):
//   q'      = bf16(fp32(q) / sqrt(D))                      (pre-scale, rounded)
//   bf16 cache:
//     s_j   = q' . k_j          fp32 accumulation, j in [0, k_len)
//     acc   = bf16(p) . v
//   int8 cache (codes k8/v8, scales ks/vs):
//     qs    = max(max_d |q'| / 127, 1e-20);  q8 = clip(rint(q' / qs))
//     s_j   = ((q8 . k8_j) * qs) * ks_j     (the integer dot is exact)
//     per GROUP = 16 keys of a row, with gm the group's max score:
//     p = exp(s - gm), pf = p * vs, ps = max(max |pf| / 127, 1e-20),
//     p8 = clip(rint(pf / ps)), acc += (p8 . v8) * ps * exp(gm - m)
//     the new-token fold uses q'' = bf16(q8 * qs) in place of q'
//   n_j     = q' . k_new_j + (mask[r, j] ? 0 : -1e30)      j in [0, Tn)
//   m       = max(s, n);  p = exp(s - m), pn = exp(n - m)
//   out     = (acc + bf16(pn) . v_new) / max(sum p + sum pn, 1e-37)
// (l sums the unquantized p.) The output is fp32 [Hkv, GT, D]; the caller
// casts it to q's dtype. The new tokens are always bf16.
//
// The p re-quantization depends on how keys are grouped: the TPU kernel
// takes max |p.vs| per row over its whole DMA block (hundreds to thousands
// of keys, chosen by VMEM). Here the group is 16 keys: the depth of one
// m16n8k16 p.v product, and the slice of a tile one warp owns at decode
// shapes, so its row maximum is four in-quad values and two shuffles, with
// no exchange between warps. ops/flash_decode.py's plain version takes the
// group as a parameter and is held against this kernel at 16. Both
// products are exact in integers (|q8 . k8| <= 127^2 * 128 and |p8 . v8| <=
// 127^2 * 16 stay below 2^22); only codes cross HBM and the cache is never
// dequantized.
//
// What bounds it on an H100: at decode shapes (GT <= 16) every cache byte is
// read once and used for a handful of FLOPs, so it is bound by HBM bytes
// (K and V of the live prefix, plus int8 scales, over 3.35 TB/s): the design
// has to keep enough copies in flight on every SM and spend few
// instructions per byte, int8 most of all, whose bytes carry twice the work
// of bf16's. At the 512-row prefill tile the score and PV products are ~1
// KFLOP per cache byte, so it is bound by tensor-core operations there.
//
// Design. The TPU kernel walks sequence blocks in order on one core,
// carrying (m, l, acc) in VMEM. Here two paths split the live prefix across
// CTAs and merge their partials in a second kernel; k_len is read from
// device memory by both (no host sync), rows past k_len are masked in-kernel
// and never read, so no cache length needs padding. A layer of the stacked
// [L, B, Hkv, S, D] cache (and of its [L, B, Hkv, S] scale planes) is passed
// as a pointer plus strides.
//   The decode path, GT <= 16 (the AR step, the verifies, B3's rows, B4's
//   root): fd_decode_kernel, grid (split, 1, row x head), 4 warps.
//   - A ring of 64-key stages in dynamic shared memory (3 stages in bf16, 4
//     in int8) is filled by 16-byte cp.async copies, STAGES - 1 tiles ahead
//     of the tile computed, one __syncthreads per tile; the ragged end is
//     zero-filled and masked. Key rows are padded by 16 bytes so that
//     ldmatrix reads are free of bank conflicts.
//   - Each warp takes 16 keys of every tile for all 16 query rows: q.k^T and
//     p.v on mma.sync with ldmatrix fragments (.trans for V), the online
//     softmax in registers; p is rounded to bf16 (or re-quantized to int8)
//     before p.v, as on the TPU.
//   - int8 codes stay int8 in shared memory (half the ring's bytes):
//     q8.k8 runs m16n8k32 s8 products, whose B operand is 4 consecutive
//     codes of a key row, the cache's own layout; p8.v8 runs m16n8k16 s8
//     products whose B operand, 4 keys of one column, comes from an
//     ldmatrix.trans of byte pairs split into even and odd columns by prmt
//     (sm_90 has no 8-bit transposing ldmatrix), with the group's keys in
//     the same order on the A side.
//   - The four warps merge their (m, l, acc) in shared memory at the end, so
//     a CTA writes one partial per row.
//   - The grid is one wave: ops/flash_decode.py chooses nsplit from the
//     card's SM count and the kernel's resident CTAs per SM (the occupancy
//     calculator, tf_flash_decode_ctas_per_sm) so that the splits of all
//     heads of a row run at once, from the shape alone (never from B).
//   - fd_reduce_kernel, one CTA per (query row, row x head), is launched as
//     a programmatic dependent of phase 1: it starts while phase 1 runs,
//     computes what needs no partial (the new-token scores), waits
//     (griddepcontrol.wait), then weighs the splits in parallel and sums
//     them in split order (the same result on every run), folds in the
//     new-token block under the mask bias and normalises; for the partials
//     entry points it stops before the fold.
//   The wide path, GT > 16 (the 512-row prefill tile, the tree verify, B4's
//   grow levels): fd_split_kernel, grid (split, q-tile, row x head), each
//   warp owning 16 query rows and all keys of a 64-key tile staged
//   synchronously through shared memory (int8 codes widened to bf16 on the
//   way), then fd_combine_kernel (fd_merge_kernel for the partials), one
//   CTA per (row, head) walking the splits and the new tokens.
//
// Rows (the batched entry points). The TPU kernel's grid is (B, nb), walked
// in order with the scratch re-initialised at the first block of every row.
// Here the row is folded into the head's grid index (b * Hkv + h) of both
// phases, so one launch pair serves all rows. k_len is a [B] device vector
// and each row splits ITS OWN live prefix over the launch's nsplit CTAs; a
// split that holds no key of its row (a short row, or k_len[b] = 0: the
// dead-slot gate) exits before it reads anything and writes no partial, and
// phase 2 merges only the splits that phase 1 ran, which it finds from
// k_len[b] by the same arithmetic (`split_share`). A row with k_len = 0
// therefore costs no cache traffic and its output is the attention over its
// new block alone. The layer of a row-stacked [B, L, Hkv, S, D] cache is a
// strided view: the kernel takes a row stride beside the head and token
// strides and needs no layer index.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int KT = 64;           // keys per shared-memory tile
constexpr int WARPS = 4;         // warps per CTA; each owns 16 query rows
constexpr int QT = 16 * WARPS;   // query rows per CTA
constexpr int PAD = 8;           // bf16 row padding: conflict-free fragments

// Strides are in elements: _sb per batch row, _sh per KV head, _sr per
// query row or token. The single-row entry points pass B = 1.
struct SplitArgs {
  const __nv_bfloat16* q;  long long q_sb, q_sh, q_sr;
  const void* k;           long long k_sb, k_sh, k_sr;   // bf16, or int8 codes
  const void* v;           long long v_sb, v_sh, v_sr;
  const float* ks;         long long ks_sb, ks_sh;  // int8: [B, Hkv, S] scales
  const float* vs;         long long vs_sb, vs_sh;
  const int* k_len;        // [B]
  float* m_part;           // [B, Hkv, GT, nparts]
  float* l_part;           // [B, Hkv, GT, nparts]
  float* acc_part;         // [B, Hkv, GT, nparts, D]
  int hkv, gt, s, nsplit;  // nsplit CTAs share each row's [0, k_len[b])
  int nparts;              // partials per row: nsplit (x WARPS if KSPLIT)
  float scale;
};

// One row's live length clamped into [0, s], and the keys each split takes
// of it (a multiple of KT): split i owns [i * per, min(klen, (i + 1) * per)),
// which is empty from split ceil(klen / per) on. Both phases call this, so
// phase 2 knows which partials phase 1 wrote.
__device__ __forceinline__ int split_share(int klen, int s, int nsplit, int* per) {
  klen = klen < 0 ? 0 : (klen > s ? s : klen);
  int p = (klen + nsplit - 1) / nsplit;
  *per = (p + KT - 1) / KT * KT;
  return klen;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// bf16(fp32(x) * scale): the TPU kernel's pre-scale of q
__device__ __forceinline__ float prescale(__nv_bfloat16 x, float scale) {
  return __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) * scale));
}

// int8 code of x at scale s: clip(rint(x / s), -127, 127), as a float
__device__ __forceinline__ float code(float x, float s) {
  return fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// code(x, s) that skips the division when x is 0 (the same code, 0): a
// zero dividend sends IEEE division down its slow path, and the decode
// kernel quantizes 16 query rows of which all but GT are zeros (~7 us a CTA
// at GT = 1 on an H100). In the key loop, where zeros are rare (masked
// keys), the test costs more than it saves.
__device__ __forceinline__ float code_nz(float x, float s) {
  return x == 0.f ? 0.f : code(x, s);
}

// the row scale of int8 quantization from a row's max |x|
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(amax / 127.f, 1e-20f);
}

// max over the 4 threads of an mma quad (the threads sharing a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 int8 codes -> 16 bf16 values (exact) at a 16-byte aligned dst
__device__ __forceinline__ void store_codes(__nv_bfloat16* dst, uint4 raw) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = pack_bf16((float)c[2 * e], (float)c[2 * e + 1]);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// KSPLIT: at most 16 query rows; the warps split each tile's keys.
// QUANT: int8 codes + fp32 per-token scales (else a bf16 cache).
template <int D, bool KSPLIT, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
fd_split_kernel(SplitArgs P) {
  constexpr int KW = KSPLIT ? KT / WARPS : KT;   // keys per warp per tile
  __shared__ __align__(16) __nv_bfloat16 sK[KT][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 sV[KT][D + PAD];
  __shared__ float sKs[QUANT ? KT : 1];
  __shared__ float sVs[QUANT ? KT : 1];

  const int split = blockIdx.x, qtile = blockIdx.y;
  const int bh = blockIdx.z, b = bh / P.hkv, h = bh % P.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // this CTA's share of its row's [0, klen); an empty share (a short or
  // dead row) reads nothing and writes no partial
  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int beg = split * per;
  const int end = min(klen, beg + per);
  if (beg >= end) return;

  const int row0 = KSPLIT ? 0 : qtile * QT + warp * 16;
  const bool active = row0 < P.gt;
  const int kw0 = KSPLIT ? warp * KW : 0;        // this warp's tile keys
  const int part = KSPLIT ? split * WARPS + warp : split;
  const int ra = row0 + g, rb = row0 + g + 8;   // this thread's two rows

  // q fragments (A operand, row-major 16 x D) for rows ra / rb: the
  // pre-scaled q, or its int8 codes at the row scales qs_a / qs_b
  uint32_t qa[D / 16][4];
  float qs_a = 1.f, qs_b = 1.f;
  {
    const __nv_bfloat16* qh = P.q + (long long)b * P.q_sb + (long long)h * P.q_sh;
    float x[D / 16][8];
    float amax_a = 0.f, amax_b = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[kk][e] = 0.f;
      const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
      if (ra < P.gt) {
        const __nv_bfloat16* r = qh + (long long)ra * P.q_sr;
        x[kk][0] = prescale(r[c0], P.scale); x[kk][1] = prescale(r[c0 + 1], P.scale);
        x[kk][4] = prescale(r[c1], P.scale); x[kk][5] = prescale(r[c1 + 1], P.scale);
      }
      if (rb < P.gt) {
        const __nv_bfloat16* r = qh + (long long)rb * P.q_sr;
        x[kk][2] = prescale(r[c0], P.scale); x[kk][3] = prescale(r[c0 + 1], P.scale);
        x[kk][6] = prescale(r[c1], P.scale); x[kk][7] = prescale(r[c1 + 1], P.scale);
      }
      amax_a = fmaxf(amax_a, fmaxf(fmaxf(fabsf(x[kk][0]), fabsf(x[kk][1])),
                                   fmaxf(fabsf(x[kk][4]), fabsf(x[kk][5]))));
      amax_b = fmaxf(amax_b, fmaxf(fmaxf(fabsf(x[kk][2]), fabsf(x[kk][3])),
                                   fmaxf(fabsf(x[kk][6]), fabsf(x[kk][7]))));
    }
    if constexpr (QUANT) {
      qs_a = row_scale(quad_max(amax_a));
      qs_b = row_scale(quad_max(amax_b));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (QUANT) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x[kk][e] = code(x[kk][e], (e & 2) ? qs_b : qs_a);
      }
      qa[kk][0] = pack_bf16(x[kk][0], x[kk][1]);   // (row g,   cols 2t..2t+1)
      qa[kk][1] = pack_bf16(x[kk][2], x[kk][3]);   // (row g+8, cols 2t..2t+1)
      qa[kk][2] = pack_bf16(x[kk][4], x[kk][5]);   // (row g,   cols 2t+8..)
      qa[kk][3] = pack_bf16(x[kk][6], x[kk][7]);   // (row g+8, cols 2t+8..)
    }
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kb = beg; kb < end; kb += KT) {
    __syncthreads();   // the previous tile is consumed
    if constexpr (QUANT) {
      constexpr int VEC = D / 16;   // 16-byte vectors per int8 row
      const int8_t* kh = (const int8_t*)P.k + (long long)b * P.k_sb + (long long)h * P.k_sh;
      const int8_t* vh = (const int8_t*)P.v + (long long)b * P.v_sb + (long long)h * P.v_sh;
      for (int c = tid; c < KT * VEC; c += WARPS * 32) {
        const int r = c / VEC, col = (c % VEC) * 16;
        uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
        if (kb + r < end) {
          kx = *reinterpret_cast<const uint4*>(kh + (long long)(kb + r) * P.k_sr + col);
          vx = *reinterpret_cast<const uint4*>(vh + (long long)(kb + r) * P.v_sr + col);
        }
        store_codes(&sK[r][col], kx);
        store_codes(&sV[r][col], vx);
      }
      if (tid < KT) {
        const bool live = kb + tid < end;
        sKs[tid] = live ? P.ks[(long long)b * P.ks_sb + (long long)h * P.ks_sh + kb + tid] : 0.f;
        sVs[tid] = live ? P.vs[(long long)b * P.vs_sb + (long long)h * P.vs_sh + kb + tid] : 0.f;
      }
    } else {
      constexpr int VEC = D / 8;    // 16-byte vectors per bf16 row
      const __nv_bfloat16* kh = (const __nv_bfloat16*)P.k + (long long)b * P.k_sb + (long long)h * P.k_sh;
      const __nv_bfloat16* vh = (const __nv_bfloat16*)P.v + (long long)b * P.v_sb + (long long)h * P.v_sh;
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
      if constexpr (QUANT) {   // exact integer dots -> ((dot * qs) * ks), as on the TPU
        const int kt = kw0 + n * 8 + 2 * t;
        sc[n][0] = sc[n][0] * qs_a * sKs[kt];
        sc[n][1] = sc[n][1] * qs_a * sKs[kt + 1];
        sc[n][2] = sc[n][2] * qs_b * sKs[kt];
        sc[n][3] = sc[n][3] * qs_b * sKs[kt + 1];
      }
    }
    // mask keys past the share's end
#pragma unroll
    for (int n = 0; n < KW / 8; ++n) {
      const int key = kb + kw0 + n * 8 + 2 * t;
      if (key >= end)     { sc[n][0] = -INFINITY; sc[n][2] = -INFINITY; }
      if (key + 1 >= end) { sc[n][1] = -INFINITY; sc[n][3] = -INFINITY; }
    }
    // row maxima over the tile; int8 also keeps each 16-key group's
    // (gm: rows g / g+8 of group j)
    float gm0[KW / 16], gm1[KW / 16];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KW / 16; ++j) {
      gm0[j] = fmaxf(fmaxf(sc[2 * j][0], sc[2 * j][1]),
                     fmaxf(sc[2 * j + 1][0], sc[2 * j + 1][1]));
      gm1[j] = fmaxf(fmaxf(sc[2 * j][2], sc[2 * j][3]),
                     fmaxf(sc[2 * j + 1][2], sc[2 * j + 1][3]));
      if constexpr (QUANT) {
        gm0[j] = quad_max(gm0[j]);
        gm1[j] = quad_max(gm1[j]);
      }
      mx0 = fmaxf(mx0, gm0[j]);
      mx1 = fmaxf(mx1, gm1[j]);
    }
    if constexpr (!QUANT) {
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
    }
    const float mn0 = fmaxf(m_r[0], mx0), mn1 = fmaxf(m_r[1], mx1);
    // a row with nothing valid yet keeps alpha 1 and p 0
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = expf(m_r[0] - base0), al1 = expf(m_r[1] - base1);
    m_r[0] = mn0; m_r[1] = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }

    // bf16: p = exp(s - m), acc += bf16(p) . V over each 16-key slice.
    // int8: per 16-key group, p = exp(s - gm) against the group's own max
    // and the group weighted by w = exp(gm - m): the same softmax, with
    // integer codes that do not depend on where a running max stands (the
    // splits keep their own); acc += (p8 . v8) * ps * w, p8 the codes of
    // p * vs at the row's scale ps
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < KW / 16; ++j) {
      float gb0 = base0, gb1 = base1, w0 = 1.f, w1 = 1.f;
      if constexpr (QUANT) {   // an all-masked group has p 0 and weight 0
        gb0 = gm0[j] == -INFINITY ? 0.f : gm0[j];
        gb1 = gm1[j] == -INFINITY ? 0.f : gm1[j];
        w0 = gm0[j] == -INFINITY ? 0.f : expf(gm0[j] - base0);
        w1 = gm1[j] == -INFINITY ? 0.f : expf(gm1[j] - base1);
      }
      float pr[4][2];   // (row, key pair) of this thread's 2 x 4 values
      pr[0][0] = expf(sc[2 * j][0] - gb0);     pr[0][1] = expf(sc[2 * j][1] - gb0);
      pr[1][0] = expf(sc[2 * j][2] - gb1);     pr[1][1] = expf(sc[2 * j][3] - gb1);
      pr[2][0] = expf(sc[2 * j + 1][0] - gb0); pr[2][1] = expf(sc[2 * j + 1][1] - gb0);
      pr[3][0] = expf(sc[2 * j + 1][2] - gb1); pr[3][1] = expf(sc[2 * j + 1][3] - gb1);
      ls0 += w0 * (pr[0][0] + pr[0][1] + pr[2][0] + pr[2][1]);   // row g
      ls1 += w1 * (pr[1][0] + pr[1][1] + pr[3][0] + pr[3][1]);   // row g+8
      const int r0 = kw0 + j * 16 + 2 * t;
      float ps0 = 1.f, ps1 = 1.f;
      if constexpr (QUANT) {
        const float v0 = sVs[r0], v1 = sVs[r0 + 1];
        const float v8 = sVs[r0 + 8], v9 = sVs[r0 + 9];
        pr[0][0] *= v0; pr[0][1] *= v1; pr[1][0] *= v0; pr[1][1] *= v1;
        pr[2][0] *= v8; pr[2][1] *= v9; pr[3][0] *= v8; pr[3][1] *= v9;
        ps0 = row_scale(quad_max(fmaxf(fmaxf(fabsf(pr[0][0]), fabsf(pr[0][1])),
                                       fmaxf(fabsf(pr[2][0]), fabsf(pr[2][1])))));
        ps1 = row_scale(quad_max(fmaxf(fmaxf(fabsf(pr[1][0]), fabsf(pr[1][1])),
                                       fmaxf(fabsf(pr[3][0]), fabsf(pr[3][1])))));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = (e & 1) ? ps1 : ps0;
          pr[e][0] = code(pr[e][0], s);
          pr[e][1] = code(pr[e][1], s);
        }
        ps0 *= w0;
        ps1 *= w1;
      }
      uint32_t pa[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[e] = pack_bf16(pr[e][0], pr[e][1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 =
            (uint32_t)__bfloat16_as_ushort(sV[r0][col]) |
            ((uint32_t)__bfloat16_as_ushort(sV[r0 + 1][col]) << 16);
        const uint32_t b1 =
            (uint32_t)__bfloat16_as_ushort(sV[r0 + 8][col]) |
            ((uint32_t)__bfloat16_as_ushort(sV[r0 + 9][col]) << 16);
        if constexpr (QUANT) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c, pa, b0, b1);
          acc[n][0] += c[0] * ps0; acc[n][1] += c[1] * ps0;
          acc[n][2] += c[2] * ps1; acc[n][3] += c[3] * ps1;
        } else {
          mma_bf16(acc[n], pa, b0, b1);
        }
      }
    }
    l_r[0] = l_r[0] * al0 + ls0;
    l_r[1] = l_r[1] * al1 + ls1;
  }

  if (!active) return;
  // per-thread row sums -> row sums (the 4 threads t of a row)
  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 1);
  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 2);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 1);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 2);

  const long long hrow = (long long)bh * P.gt;
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
  const __nv_bfloat16* q;   long long q_sb, q_sh, q_sr;
  const __nv_bfloat16* kn;  long long kn_sb, kn_sh, kn_sr;
  const __nv_bfloat16* vn;  long long vn_sb, vn_sh, vn_sr;
  const uint8_t* mask;      long long mask_sb;   // [B, GT, Tn], 1 = attend
  const int* k_len;         // [B]
  const float* m_part;
  const float* l_part;
  const float* acc_part;
  float* out;               // [B, Hkv, GT, D]
  int hkv, gt, tn, s, nsplit, nparts;
  float scale;
};

// one CTA per (query row, batch row x head); thread d owns output column d
// (D <= 128)
template <int D, bool QUANT>
__global__ void __launch_bounds__(128)
fd_combine_kernel(CombineArgs P) {
  extern __shared__ float sn[];           // [Tn] new-token scores
  __shared__ float sq[D];
  __shared__ float red[4];
  const int row = blockIdx.x;
  const int bh = blockIdx.y, b = bh / P.hkv, h = bh % P.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qr = P.q + (long long)b * P.q_sb + (long long)h * P.q_sh +
                            (long long)row * P.q_sr;
  float x = tid < D ? prescale(qr[tid], P.scale) : 0.f;
  if constexpr (QUANT) {
    // the new block sees bf16(q8 * qs), q8 the codes phase 1 used
    float amax = fabsf(x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    const float qs = row_scale(fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3])));
    x = __bfloat162float(__float2bfloat16_rn(code(x, qs) * qs));
  }
  if (tid < D) sq[tid] = x;

  // merge the partials of the splits that held a key of this row (the
  // others wrote nothing): none for a dead row, whose M stays -inf
  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int live = klen == 0 ? 0 : (klen + per - 1) / per * (P.nparts / P.nsplit);
  const long long o = ((long long)bh * P.gt + row) * P.nparts;
  float M = -INFINITY;
  for (int s = 0; s < live; ++s) M = fmaxf(M, P.m_part[o + s]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < live; ++s) {
    const float ms = P.m_part[o + s];
    const float w = ms == -INFINITY ? 0.f : expf(ms - M);
    L += P.l_part[o + s] * w;
    if (tid < D) acc += P.acc_part[(o + s) * D + tid] * w;
  }
  __syncthreads();

  // new-token scores, one warp per new token
  const __nv_bfloat16* knh = P.kn + (long long)b * P.kn_sb + (long long)h * P.kn_sh;
  const uint8_t* mrow = P.mask + (long long)b * P.mask_sb + (long long)row * P.tn;
  for (int j = warp; j < P.tn; j += 4) {
    const __nv_bfloat16* kr = knh + (long long)j * P.kn_sr;
    float part = 0.f;
    for (int d = lane; d < D; d += 32) part += sq[d] * __bfloat162float(kr[d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0)
      sn[j] = part + (mrow[j] ? 0.f : -1e30f);
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
  const __nv_bfloat16* vnh = P.vn + (long long)b * P.vn_sb + (long long)h * P.vn_sh;
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
    P.out[((long long)bh * P.gt + row) * D + tid] = acc / fmaxf(L, 1e-37f);
}

struct MergeArgs {
  const int* k_len;         // [B]
  const float* m_part;
  const float* l_part;
  const float* acc_part;
  float* m_out;             // [B, Hkv, GT]
  float* l_out;             // [B, Hkv, GT]
  float* acc_out;           // [B, Hkv, GT, D]
  int hkv, gt, s, nsplit, nparts;
};

// The partials' second phase: one CTA per (query row, batch row x head),
// thread d owns column d. Merges the splits that held a key of this row
// and stops there: M = max m_s, l = sum l_s e^(m_s - M), acc = sum acc_s
// e^(m_s - M); no new-token fold, no division. With no live key the state
// is (-1e30, 0, 0).
template <int D>
__global__ void __launch_bounds__(D)
fd_merge_kernel(MergeArgs P) {
  const int row = blockIdx.x;
  const int bh = blockIdx.y, b = bh / P.hkv;
  const int tid = threadIdx.x;
  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int live = klen == 0 ? 0 : (klen + per - 1) / per * (P.nparts / P.nsplit);
  const long long r = (long long)bh * P.gt + row;
  const long long o = r * P.nparts;
  float M = -INFINITY;
  for (int s = 0; s < live; ++s) M = fmaxf(M, P.m_part[o + s]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < live; ++s) {
      const float ms = P.m_part[o + s];
      if (ms == -INFINITY) continue;   // a warp's share with no live key
      const float w = expf(ms - M);
      L += P.l_part[o + s] * w;
      acc += P.acc_part[(o + s) * D + tid] * w;
    }
  }
  if (tid == 0) {
    P.m_out[r] = M == -INFINITY ? -1e30f : M;
    P.l_out[r] = L;
  }
  P.acc_out[r * D + tid] = acc;
}

// ---------------------------------------------------------------------------
// The decode path (GT <= DECODE_ROWS): fd_decode_kernel, then fd_reduce_kernel
// ---------------------------------------------------------------------------

constexpr int DECODE_ROWS = 16;   // query rows of one mma tile
constexpr int MAX_SPLITS = 1024;  // splits fd_reduce_kernel can weigh

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, asynchronously; a dead copy reads
// nothing and fills zeros (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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
// l % 8 of matrix l / 8 (.trans: each thread gets a column pair)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// int8 x int8 -> int32 tensor-core products (exact)
__device__ __forceinline__ void mma_s8_k32(int (&c)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8_k16(int (&c)[4], uint32_t a0, uint32_t a1,
                                           uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// An int32 mma accumulator started at I2F_BIAS (1.5 * 2^23 as float bits)
// ends as the float bits of 1.5 * 2^23 + dot for |dot| < 2^22, so one FADD
// gives float(dot) exactly, in place of a quarter-rate I2F
constexpr int I2F_BIAS = 0x4B400000;
__device__ __forceinline__ float unbias(int c) {
  return __int_as_float(c) - 12582912.f;
}

// four integral floats in [-127, 127] -> packed int8, a in the low byte
__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c, float d) {
  return ((uint32_t)(int)a & 0xffu) | (((uint32_t)(int)b & 0xffu) << 8) |
         (((uint32_t)(int)c & 0xffu) << 16) | (((uint32_t)(int)d & 0xffu) << 24);
}

// The shared-memory ring of the decode kernel. A stage holds KT keys of K
// and of V as they lie in the cache (int8 codes stay int8), each key row
// padded by 16 bytes so that ldmatrix's 8 rows fall in distinct banks, then
// (int8) the KT fp32 scales of K and of V.
template <int D, bool QUANT>
struct Ring {
  static constexpr int ROW = D * (QUANT ? 1 : 2) + 16;   // bytes per key row
  static constexpr int KV = KT * ROW;                    // K (or V) of a stage
  static constexpr int STAGE = 2 * KV + (QUANT ? 2 * KT * 4 : 0);
  static constexpr int STAGES = QUANT ? 4 : 3;
  static constexpr int BYTES = STAGES * STAGE;
  // the warps' (m, l, acc) for the in-CTA merge reuse the drained ring
  static_assert(WARPS * 16 * (D + 2) * 4 <= BYTES, "merge space");
};

// acc[n][e]'s output column. bf16: n-tile n holds columns n*8 + 2t + (e&1).
// int8: the p.v B operand comes from ldmatrix.trans of byte pairs, split
// into even and odd columns by prmt, so n-tile 4j + q holds columns
// 32j + 16(q>>1) + 4t + 2(e&1) + (q&1).
template <bool QUANT>
__device__ __forceinline__ int acc_col(int n, int e, int t) {
  if constexpr (QUANT)
    return (n >> 2) * 32 + ((n >> 1) & 1) * 16 + 4 * t + 2 * (e & 1) + (n & 1);
  else
    return n * 8 + 2 * t + (e & 1);
}

// Phase 1 of the decode path: grid (split, 1, batch row x head), 4 warps.
// The CTA streams its share of [0, k_len) through a ring of KT-key stages
// filled by cp.async, Ring::STAGES - 1 tiles ahead of the one computed; the
// four warps take 16 keys of each tile for all (<= 16) query rows. At the
// end the warps merge their (m, l, acc) in shared memory, in warp order,
// and the CTA writes one partial: P.nparts == P.nsplit.
template <int D, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
fd_decode_kernel(SplitArgs P) {
  using R = Ring<D, QUANT>;
  constexpr int ESZ = QUANT ? 1 : 2;       // bytes per cache element
  constexpr int CH = D * ESZ / 16;         // 16-byte chunks per key row
  constexpr int NQ = QUANT ? D / 32 : D / 16;   // q.k^T k-steps
  static_assert(KT * CH % (WARPS * 32) == 0, "whole copy rounds per tile");
  extern __shared__ __align__(128) unsigned char ring[];

  // fd_reduce_kernel, launched as this grid's programmatic dependent, may
  // start now: it waits for this grid (griddepcontrol.wait) before reading
  // a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x;
  const int bh = blockIdx.z, b = bh / P.hkv, h = bh % P.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int beg = split * per;
  const int end = min(klen, beg + per);
  if (beg >= end) return;
  const int ntiles = (end - beg + KT - 1) / KT;

  const char* kh = (const char*)P.k + ((long long)b * P.k_sb + (long long)h * P.k_sh) * ESZ;
  const char* vh = (const char*)P.v + ((long long)b * P.v_sb + (long long)h * P.v_sh) * ESZ;
  const float* ksh = QUANT ? P.ks + (long long)b * P.ks_sb + (long long)h * P.ks_sh : nullptr;
  const float* vsh = QUANT ? P.vs + (long long)b * P.vs_sb + (long long)h * P.vs_sh : nullptr;
  const long long krow = P.k_sr * ESZ, vrow = P.v_sr * ESZ;

  // start tile i's copies into stage st; keys past the share's end are
  // zero-filled, never read
  auto stage = [&](int i, int st) {
    unsigned char* sK = ring + st * R::STAGE;
    const int kb = beg + i * KT;
#pragma unroll
    for (int it = 0; it < KT * CH / (WARPS * 32); ++it) {
      const int c = tid + it * WARPS * 32;
      const int r = c / CH, col = (c % CH) * 16;
      const bool live = kb + r < end;
      const long long key = live ? kb + r : beg;
      cp_async16(sK + r * R::ROW + col, kh + key * krow + col, live);
      cp_async16(sK + R::KV + r * R::ROW + col, vh + key * vrow + col, live);
    }
    if constexpr (QUANT) {
      float* ss = reinterpret_cast<float*>(sK + 2 * R::KV);
      if (tid < 2 * KT) {
        const int r = tid % KT;
        const bool live = kb + r < end;
        const long long key = live ? kb + r : beg;
        cp_async4(ss + tid, (tid < KT ? ksh : vsh) + key, live);
      }
    }
  };

  // prologue: the first STAGES - 1 tiles in flight (one group each, empty
  // past the last tile, so that the group count stays fixed)
#pragma unroll
  for (int i = 0; i < R::STAGES - 1; ++i) {
    if (i < ntiles) stage(i, i);
    cp_async_commit();
  }

  // q fragments (A operand, 16 rows x D): register a of k-step kk holds row
  // g + 8 (a & 1), VPR consecutive columns from kk * 8 VPR + (a >> 1) * 4 VPR
  // + VPR t; the pre-scaled q as bf16 pairs, or its int8 codes at the row
  // scales qs_a / qs_b of rows g / g+8
  uint32_t qa[NQ][4];
  float qs_a = 1.f, qs_b = 1.f;
  {
    constexpr int VPR = QUANT ? 4 : 2;   // values per A register
    const __nv_bfloat16* qh = P.q + (long long)b * P.q_sb + (long long)h * P.q_sh;
    float x[NQ][4][VPR];
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = g + 8 * (a & 1);
        const int c = kk * 8 * VPR + (a >> 1) * 4 * VPR + VPR * t;
#pragma unroll
        for (int v = 0; v < VPR; ++v) {
          x[kk][a][v] = r < P.gt ? prescale(qh[(long long)r * P.q_sr + c + v], P.scale) : 0.f;
          amax[a & 1] = fmaxf(amax[a & 1], fabsf(x[kk][a][v]));
        }
      }
    }
    if constexpr (QUANT) {
      qs_a = row_scale(quad_max(amax[0]));
      qs_b = row_scale(quad_max(amax[1]));
    }
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if constexpr (QUANT) {
          const float s = (a & 1) ? qs_b : qs_a;
          qa[kk][a] = pack_s8(code_nz(x[kk][a][0], s), code_nz(x[kk][a][1], s),
                              code_nz(x[kk][a][2], s), code_nz(x[kk][a][3], s));
        } else {
          qa[kk][a] = pack_bf16(x[kk][a][0], x[kk][a][1]);
        }
      }
    }
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // this lane's ldmatrix row within a warp's 16 keys: matrices 0/1 of
  // q.k^T are keys 0-7, 2/3 keys 8-15; of p.v (trans) 0/2 keys 0-7, 1/3 keys 8-15
  const int kw0 = warp * 16;
  const int krow_l = kw0 + ((lane >> 4) << 3) + (lane & 7);
  const int vrow_l = kw0 + (((lane >> 3) & 1) << 3) + (lane & 7);

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<R::STAGES - 2>();   // this thread's copies of tile i landed
    __syncthreads();                  // everyone's landed; tile i - 1 consumed
    {
      const int nx = i + R::STAGES - 1;   // refill the stage tile i - 1 held
      if (nx < ntiles) stage(nx, nx % R::STAGES);
      cp_async_commit();
    }
    const unsigned char* sK = ring + (i % R::STAGES) * R::STAGE;
    const unsigned char* sV = sK + R::KV;
    const float* sKs = reinterpret_cast<const float*>(sK + 2 * R::KV);
    const float* sVs = sKs + KT;
    const int kb = beg + i * KT;

    // scores: S[16 x 16] = q'[16 x D] . K^T over this warp's keys; n-tile
    // n holds keys kw0 + 8n + (2t, 2t + 1)
    float sc[2][4];
    if constexpr (QUANT) {
      // |q8 . k8| <= 127^2 * D < 2^22
      int ci[2][4] = {{I2F_BIAS, I2F_BIAS, I2F_BIAS, I2F_BIAS},
                      {I2F_BIAS, I2F_BIAS, I2F_BIAS, I2F_BIAS}};
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, sK + krow_l * R::ROW + kk * 32 + ((lane >> 3) & 1) * 16);
        mma_s8_k32(ci[0], qa[kk], r[0], r[1]);
        mma_s8_k32(ci[1], qa[kk], r[2], r[3]);
      }
      // exact integer dots -> ((dot * qs) * ks), as on the TPU
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int kt = kw0 + n * 8 + 2 * t;
        sc[n][0] = unbias(ci[n][0]) * qs_a * sKs[kt];
        sc[n][1] = unbias(ci[n][1]) * qs_a * sKs[kt + 1];
        sc[n][2] = unbias(ci[n][2]) * qs_b * sKs[kt];
        sc[n][3] = unbias(ci[n][3]) * qs_b * sKs[kt + 1];
      }
    } else {
#pragma unroll
      for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, sK + krow_l * R::ROW + (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(sc[0], qa[kk], r[0], r[1]);
        mma_bf16(sc[1], qa[kk], r[2], r[3]);
      }
    }
    // mask keys past the share's end
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int key = kb + kw0 + n * 8 + 2 * t;
      if (key >= end)     { sc[n][0] = -INFINITY; sc[n][2] = -INFINITY; }
      if (key + 1 >= end) { sc[n][1] = -INFINITY; sc[n][3] = -INFINITY; }
    }
    // row maxima over the warp's 16 keys (int8: the re-quantization group)
    const float gm0 = quad_max(fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1])));
    const float gm1 = quad_max(fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3])));
    const float mn0 = fmaxf(m_r[0], gm0), mn1 = fmaxf(m_r[1], gm1);
    // a row with nothing valid yet keeps alpha 1 and p 0
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = expf(m_r[0] - base0), al1 = expf(m_r[1] - base1);
    m_r[0] = mn0; m_r[1] = mn1;
    // once the maxima settle alpha is 1 on every lane: skip the multiply
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= al0; acc[n][1] *= al0;
        acc[n][2] *= al1; acc[n][3] *= al1;
      }
    }

    // bf16: p = exp(s - m), acc += bf16(p) . V. int8: p = exp(s - gm)
    // against the group's own max, the group weighted by w = exp(gm - m);
    // acc += (p8 . v8) * ps * w, p8 the codes of p * vs at the row's scale
    // ps (see fd_split_kernel)
    float gb0 = base0, gb1 = base1, w0 = 1.f, w1 = 1.f;
    if constexpr (QUANT) {   // an all-masked group has p 0 and weight 0
      gb0 = gm0 == -INFINITY ? 0.f : gm0;
      gb1 = gm1 == -INFINITY ? 0.f : gm1;
      w0 = gm0 == -INFINITY ? 0.f : expf(gm0 - base0);
      w1 = gm1 == -INFINITY ? 0.f : expf(gm1 - base1);
    }
    float pr[4][2];   // [row g / g+8 of keys 0-7, then of keys 8-15][key pair]
    pr[0][0] = expf(sc[0][0] - gb0); pr[0][1] = expf(sc[0][1] - gb0);
    pr[1][0] = expf(sc[0][2] - gb1); pr[1][1] = expf(sc[0][3] - gb1);
    pr[2][0] = expf(sc[1][0] - gb0); pr[2][1] = expf(sc[1][1] - gb0);
    pr[3][0] = expf(sc[1][2] - gb1); pr[3][1] = expf(sc[1][3] - gb1);
    l_r[0] = l_r[0] * al0 + w0 * (pr[0][0] + pr[0][1] + pr[2][0] + pr[2][1]);
    l_r[1] = l_r[1] * al1 + w1 * (pr[1][0] + pr[1][1] + pr[3][0] + pr[3][1]);

    if constexpr (QUANT) {
      const int r0 = kw0 + 2 * t;
      const float v0 = sVs[r0], v1 = sVs[r0 + 1];
      const float v8 = sVs[r0 + 8], v9 = sVs[r0 + 9];
      pr[0][0] *= v0; pr[0][1] *= v1; pr[1][0] *= v0; pr[1][1] *= v1;
      pr[2][0] *= v8; pr[2][1] *= v9; pr[3][0] *= v8; pr[3][1] *= v9;
      float ps0 = row_scale(quad_max(fmaxf(fmaxf(fabsf(pr[0][0]), fabsf(pr[0][1])),
                                           fmaxf(fabsf(pr[2][0]), fabsf(pr[2][1])))));
      float ps1 = row_scale(quad_max(fmaxf(fmaxf(fabsf(pr[1][0]), fabsf(pr[1][1])),
                                           fmaxf(fabsf(pr[3][0]), fabsf(pr[3][1])))));
      // A operand (m16n8k16, 8-bit): k slot 4t + j is key (2t, 2t + 1,
      // 8 + 2t, 9 + 2t)[j] of the group; the B operand below uses the same
      const uint32_t a0 = pack_s8(code(pr[0][0], ps0), code(pr[0][1], ps0),
                                  code(pr[2][0], ps0), code(pr[2][1], ps0));
      const uint32_t a1 = pack_s8(code(pr[1][0], ps1), code(pr[1][1], ps1),
                                  code(pr[3][0], ps1), code(pr[3][1], ps1));
      ps0 *= w0;
      ps1 *= w1;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        // byte pairs (columns 2c, 2c + 1) of keys (2t, 2t + 1) and, in the
        // odd registers, of keys (8 + 2t, 9 + 2t); c = 16j + 8(q >> 1) + g
        uint32_t r[4];
        ldsm_x4_t(r, sV + vrow_l * R::ROW + j * 32 + (lane >> 4) * 16);
        const uint32_t bq[4] = {__byte_perm(r[0], r[1], 0x6420),   // even columns
                                __byte_perm(r[0], r[1], 0x7531),   // odd columns
                                __byte_perm(r[2], r[3], 0x6420),
                                __byte_perm(r[2], r[3], 0x7531)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int c[4] = {I2F_BIAS, I2F_BIAS, I2F_BIAS, I2F_BIAS};   // |p8 . v8| < 2^22
          mma_s8_k16(c, a0, a1, bq[q]);
          acc[4 * j + q][0] += unbias(c[0]) * ps0;
          acc[4 * j + q][1] += unbias(c[1]) * ps0;
          acc[4 * j + q][2] += unbias(c[2]) * ps1;
          acc[4 * j + q][3] += unbias(c[3]) * ps1;
        }
      }
    } else {
      uint32_t pa[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[e] = pack_bf16(pr[e][0], pr[e][1]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t r[4];
        ldsm_x4_t(r, sV + vrow_l * R::ROW + (j * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * j], pa, r[0], r[1]);
        mma_bf16(acc[2 * j + 1], pa, r[2], r[3]);
      }
    }
  }

  // per-thread row sums -> row sums (the 4 threads t of a row)
  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 1);
  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 2);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 1);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 2);

  // merge the four warps in shared memory (the drained ring), in warp
  // order, and write this split's partial for each live row
  cp_async_wait<0>();
  __syncthreads();
  float* sm = reinterpret_cast<float*>(ring);   // [WARPS][16]
  float* sl = sm + WARPS * 16;                  // [WARPS][16]
  float* sa = sl + WARPS * 16;                  // [WARPS][16][D]
  if (t == 0) {
    sm[warp * 16 + g] = m_r[0]; sm[warp * 16 + g + 8] = m_r[1];
    sl[warp * 16 + g] = l_r[0]; sl[warp * 16 + g + 8] = l_r[1];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sa[(warp * 16 + g + (e & 2) * 4) * D + acc_col<QUANT>(n, e, t)] = acc[n][e];
  }
  __syncthreads();
  const long long hrow = (long long)bh * P.gt;
  for (int idx = tid; idx < P.gt * D; idx += WARPS * 32) {
    const int r = idx / D, c = idx % D;
    float M = sm[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, sm[w * 16 + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {   // a warp with no live key has m -inf
      const float mw = sm[w * 16 + r];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - M);
      L += sl[w * 16 + r] * wt;
      A += sa[(w * 16 + r) * D + c] * wt;
    }
    const long long o = (hrow + r) * P.nparts + split;
    if (c == 0) { P.m_part[o] = M; P.l_part[o] = L; }
    P.acc_part[o * D + c] = A;
  }
}

// reductions over a 128-thread CTA in a fixed order (the same result on
// every run); red holds 4 floats
__device__ __forceinline__ float cta_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();   // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}
__device__ __forceinline__ float cta_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

struct ReduceArgs {
  CombineArgs c;     // the partials, and (FOLD) q, the new block, mask, out
  float* m_out;      // !FOLD: [B, Hkv, GT]
  float* l_out;      // !FOLD: [B, Hkv, GT]
  float* acc_out;    // !FOLD: [B, Hkv, GT, D]
};

// Phase 2 of the decode path: one CTA of 128 threads per (query row, batch
// row x head), launched as fd_decode_kernel's programmatic dependent. What
// does not depend on phase 1 (the row's live split count and, FOLD, the
// new-token scores) runs while phase 1 still runs; then griddepcontrol.wait.
// The live splits' maxima and weights e^(m_s - M) are taken in parallel (a
// split per thread, fixed-order CTA reductions), then thread d sums column
// d over the splits in split order. FOLD: fold in the new-token block under
// the mask bias and normalise (fd_combine_kernel's fold); else stop there,
// as fd_merge_kernel, with (-1e30, 0, 0) when no split is live.
template <int D, bool QUANT, bool FOLD>
__global__ void __launch_bounds__(128)
fd_reduce_kernel(ReduceArgs RA) {
  const CombineArgs& P = RA.c;
  extern __shared__ float sn[];           // [Tn] new-token scores (FOLD)
  __shared__ float sw[MAX_SPLITS];
  __shared__ float sq[D];
  __shared__ float red[4];
  const int row = blockIdx.x;
  const int bh = blockIdx.y, b = bh / P.hkv, h = bh % P.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int live = klen == 0 ? 0 : (klen + per - 1) / per;
  float mx = -INFINITY;   // the new tokens' maximum score (FOLD)
  if constexpr (FOLD) {
    const __nv_bfloat16* qr = P.q + (long long)b * P.q_sb + (long long)h * P.q_sh +
                              (long long)row * P.q_sr;
    float xq = tid < D ? prescale(qr[tid], P.scale) : 0.f;
    if constexpr (QUANT) {
      // the new block sees bf16(q8 * qs), q8 the codes phase 1 used
      const float qs = row_scale(cta_max(fabsf(xq), red));
      xq = __bfloat162float(__float2bfloat16_rn(code(xq, qs) * qs));
    }
    if (tid < D) sq[tid] = xq;
    __syncthreads();
    // new-token scores, one warp per new token
    const __nv_bfloat16* knh = P.kn + (long long)b * P.kn_sb + (long long)h * P.kn_sh;
    const uint8_t* mrow = P.mask + (long long)b * P.mask_sb + (long long)row * P.tn;
    for (int j = warp; j < P.tn; j += 4) {
      const __nv_bfloat16* kr = knh + (long long)j * P.kn_sr;
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += sq[d] * __bfloat162float(kr[d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0)
        sn[j] = part + (mrow[j] ? 0.f : -1e30f);
    }
    __syncthreads();
    for (int j = tid; j < P.tn; j += 128) mx = fmaxf(mx, sn[j]);
    mx = cta_max(mx, red);
  }

  // phase 1 is complete and its partials visible from here on
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long o = ((long long)bh * P.gt + row) * P.nparts;
  // a thread's first split's m and l load together (live <= 128 is one
  // round); every live split has a finite m
  const float m0 = tid < live ? P.m_part[o + tid] : -INFINITY;
  const float l0 = tid < live ? P.l_part[o + tid] : 0.f;
  float x = m0;
  for (int s = tid + 128; s < live; s += 128) x = fmaxf(x, P.m_part[o + s]);
  const float M = cta_max(x, red);
  x = 0.f;
  if (tid < live) {
    sw[tid] = expf(m0 - M);
    x = l0 * sw[tid];
  }
  for (int s = tid + 128; s < live; s += 128) {
    sw[s] = expf(P.m_part[o + s] - M);
    x += P.l_part[o + s] * sw[s];
  }
  float L = cta_sum(x, red);   // its barriers also publish sw
  float acc = 0.f;
  if (tid < D) {
#pragma unroll 8
    for (int s = 0; s < live; ++s) acc += P.acc_part[(o + s) * D + tid] * sw[s];
  }

  if constexpr (!FOLD) {
    const long long r = (long long)bh * P.gt + row;
    if (tid == 0) {
      RA.m_out[r] = M == -INFINITY ? -1e30f : M;
      RA.l_out[r] = L;
    }
    if (tid < D) RA.acc_out[r * D + tid] = acc;
  } else {
    const float mn = fmaxf(M, mx);
    const float alpha = expf(M - mn);   // M = -inf (empty cache) -> 0
    float ln = 0.f, an = 0.f;
    const __nv_bfloat16* vnh = P.vn + (long long)b * P.vn_sb + (long long)h * P.vn_sh;
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
      P.out[((long long)bh * P.gt + row) * D + tid] = acc / fmaxf(L, 1e-37f);
  }
}

// The wide path (GT > DECODE_ROWS): fd_split_kernel, then fd_combine_kernel
// (fd_merge_kernel for the partials).
template <int D, bool QUANT>
int launch_split(const SplitArgs& sa, int bh, cudaStream_t st) {
  const int nq = (sa.gt + QT - 1) / QT;
  fd_split_kernel<D, false, QUANT><<<dim3(sa.nsplit, nq, bh), WARPS * 32, 0, st>>>(sa);
  return (int)cudaGetLastError();
}

// The decode path: fd_decode_kernel, then fd_reduce_kernel with (FOLD) or
// without the new-token fold. The ring is dynamic shared memory, above the
// 48 KB a kernel gets without asking.
template <int D, bool QUANT, bool FOLD>
int launch_decode(const SplitArgs& sa, const ReduceArgs& ra, int bh, cudaStream_t st) {
  using R = Ring<D, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(fd_decode_kernel<D, QUANT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       R::BYTES);
  if (e != cudaSuccess) return (int)e;
  fd_decode_kernel<D, QUANT><<<dim3(sa.nsplit, 1, bh), WARPS * 32, R::BYTES, st>>>(sa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the reduce kernel's QUANT matters only to the fold
  constexpr bool RQ = QUANT && FOLD;
  const size_t smem = FOLD ? (size_t)ra.c.tn * sizeof(float) : 0;
  if (smem > 32 * 1024) {
    e = cudaFuncSetAttribute(fd_reduce_kernel<D, RQ, FOLD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a programmatic dependent launch: its CTAs start while phase 1 runs
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ra.c.gt, bh);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fd_reduce_kernel<D, RQ, FOLD>, ra);
}

template <int D, bool QUANT>
int launch(const SplitArgs& sa, const CombineArgs& ca, int bh, cudaStream_t st) {
  if (sa.gt <= DECODE_ROWS)
    return launch_decode<D, QUANT, true>(sa, ReduceArgs{ca, nullptr, nullptr, nullptr},
                                         bh, st);
  const int err = launch_split<D, QUANT>(sa, bh, st);
  if (err != 0) return err;
  const size_t smem = (size_t)ca.tn * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fd_combine_kernel<D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fd_combine_kernel<D, QUANT><<<dim3(ca.gt, bh), 128, smem, st>>>(ca);
  return (int)cudaGetLastError();
}

template <int D, bool QUANT>
int launch_partials(const SplitArgs& sa, const ReduceArgs& ra, const MergeArgs& ma,
                    int bh, cudaStream_t st) {
  if (sa.gt <= DECODE_ROWS) return launch_decode<D, QUANT, false>(sa, ra, bh, st);
  const int err = launch_split<D, QUANT>(sa, bh, st);
  if (err != 0) return err;
  fd_merge_kernel<D><<<dim3(ma.gt, bh), D, 0, st>>>(ma);
  return (int)cudaGetLastError();
}

// Partials per query row phase 1 writes: one per split on both paths (the
// decode kernel merges its warps in the CTA). The wrapper sizes its scratch
// by tf_flash_decode_parts, so this is the only place it is decided.
int n_parts(int /*gt*/, int nsplit) { return nsplit; }

// CTAs of the phase-1 kernel a launch at gt uses that one SM holds at once
template <int D, bool QUANT>
int ctas_per_sm(int gt) {
  int n = 0;
  cudaError_t e;
  if (gt <= DECODE_ROWS) {
    e = cudaFuncSetAttribute(fd_decode_kernel<D, QUANT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<D, QUANT>::BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fd_decode_kernel<D, QUANT>, WARPS * 32, Ring<D, QUANT>::BYTES);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fd_split_kernel<D, false, QUANT>, WARPS * 32, 0);
  }
  return e == cudaSuccess ? n : -(int)e;
}

// The arguments every entry point shares after the cache: new block, mask,
// lengths, scratch, output, sizes, stream.
#define TF_FD_TAIL_PARAMS                                                     \
    const void* mask, const void* k_len,                                      \
    void* m_part, void* l_part, void* acc_part, void* out,                    \
    int hkv, int gt, int tn, int s, int d, int nsplit, float scale,           \
    void* stream
#define TF_FD_TAIL_ARGS                                                       \
    mask, k_len, m_part, l_part, acc_part, out, hkv, gt, tn, s, d, nsplit,    \
    scale, stream

// _sb strides are per batch row (0 and bsz = 1 from the single-row entries)
template <bool QUANT>
int run(int bsz, const void* q, long long q_sb, long long q_sh, long long q_sr,
        const void* k, long long k_sb, long long k_sh, long long k_sr,
        const void* v, long long v_sb, long long v_sh, long long v_sr,
        const void* ks, long long ks_sb, long long ks_sh,
        const void* vs, long long vs_sb, long long vs_sh,
        const void* kn, long long kn_sb, long long kn_sh, long long kn_sr,
        const void* vn, long long vn_sb, long long vn_sh, long long vn_sr,
        long long mask_sb, TF_FD_TAIL_PARAMS) {
  if (bsz <= 0 || hkv <= 0 || gt <= 0 || tn <= 0 || nsplit <= 0 ||
      (long long)bsz * hkv > 65535 || (gt <= DECODE_ROWS && nsplit > MAX_SPLITS))
    return (int)cudaErrorInvalidValue;
  const int nparts = n_parts(gt, nsplit);
  SplitArgs sa{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr, k, k_sb, k_sh, k_sr,
               v, v_sb, v_sh, v_sr, (const float*)ks, ks_sb, ks_sh,
               (const float*)vs, vs_sb, vs_sh,
               (const int*)k_len, (float*)m_part, (float*)l_part,
               (float*)acc_part, hkv, gt, s, nsplit, nparts, scale};
  CombineArgs ca{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr,
                 (const __nv_bfloat16*)kn, kn_sb, kn_sh, kn_sr,
                 (const __nv_bfloat16*)vn, vn_sb, vn_sh, vn_sr,
                 (const uint8_t*)mask, mask_sb, (const int*)k_len,
                 (const float*)m_part, (const float*)l_part,
                 (const float*)acc_part, (float*)out,
                 hkv, gt, tn, s, nsplit, nparts, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128) return launch<128, QUANT>(sa, ca, bsz * hkv, st);
  if (d == 64) return launch<64, QUANT>(sa, ca, bsz * hkv, st);
  return (int)cudaErrorInvalidValue;
}

// Cache-only partials of one row (B = 1): the split phase, then the merge.
template <bool QUANT>
int run_partials(const void* q, long long q_sh, long long q_sr,
                 const void* k, long long k_sh, long long k_sr,
                 const void* v, long long v_sh, long long v_sr,
                 const void* ks, long long ks_sh, const void* vs, long long vs_sh,
                 const void* k_len, void* m_part, void* l_part, void* acc_part,
                 void* m_out, void* l_out, void* acc_out,
                 int hkv, int gt, int s, int d, int nsplit, float scale,
                 void* stream) {
  if (hkv <= 0 || gt <= 0 || nsplit <= 0 || hkv > 65535 ||
      (gt <= DECODE_ROWS && nsplit > MAX_SPLITS))
    return (int)cudaErrorInvalidValue;
  const int nparts = n_parts(gt, nsplit);
  SplitArgs sa{(const __nv_bfloat16*)q, 0, q_sh, q_sr, k, 0, k_sh, k_sr,
               v, 0, v_sh, v_sr, (const float*)ks, 0, ks_sh,
               (const float*)vs, 0, vs_sh,
               (const int*)k_len, (float*)m_part, (float*)l_part,
               (float*)acc_part, hkv, gt, s, nsplit, nparts, scale};
  MergeArgs ma{(const int*)k_len, (const float*)m_part, (const float*)l_part,
               (const float*)acc_part, (float*)m_out, (float*)l_out,
               (float*)acc_out, hkv, gt, s, nsplit, nparts};
  CombineArgs ca{nullptr, 0, 0, 0, nullptr, 0, 0, 0, nullptr, 0, 0, 0,
                 nullptr, 0, (const int*)k_len, (const float*)m_part,
                 (const float*)l_part, (const float*)acc_part, nullptr,
                 hkv, gt, 0, s, nsplit, nparts, scale};
  ReduceArgs ra{ca, (float*)m_out, (float*)l_out, (float*)acc_out};
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128) return launch_partials<128, QUANT>(sa, ra, ma, hkv, st);
  if (d == 64) return launch_partials<64, QUANT>(sa, ra, ma, hkv, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tf_flash_decode_parts(int gt, int nsplit) {
  return n_parts(gt, nsplit);
}

// CTAs per SM the phase-1 kernel of a launch at (gt, d, int8 or not) can
// hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
// device), or minus a cudaError_t
extern "C" int tf_flash_decode_ctas_per_sm(int gt, int d, int quant) {
  if (d == 128) return quant ? ctas_per_sm<128, true>(gt) : ctas_per_sm<128, false>(gt);
  if (d == 64) return quant ? ctas_per_sm<64, true>(gt) : ctas_per_sm<64, false>(gt);
  return -(int)cudaErrorInvalidValue;
}

extern "C" int tf_flash_decode_bf16(
    const void* q, long long q_sh, long long q_sr,
    const void* k, long long k_sh, long long k_sr,
    const void* v, long long v_sh, long long v_sr,
    const void* kn, long long kn_sh, long long kn_sr,
    const void* vn, long long vn_sh, long long vn_sr,
    TF_FD_TAIL_PARAMS) {
  return run<false>(1, q, 0, q_sh, q_sr, k, 0, k_sh, k_sr, v, 0, v_sh, v_sr,
                    nullptr, 0, 0, nullptr, 0, 0, kn, 0, kn_sh, kn_sr,
                    vn, 0, vn_sh, vn_sr, 0, TF_FD_TAIL_ARGS);
}

// int8 cache: k/v int8 codes [Hkv, S, D] (strides in elements = bytes),
// ks/vs fp32 scales [Hkv, S] (token stride 1, head strides ks_sh / vs_sh)
extern "C" int tf_flash_decode_int8(
    const void* q, long long q_sh, long long q_sr,
    const void* k, long long k_sh, long long k_sr,
    const void* v, long long v_sh, long long v_sr,
    const void* ks, long long ks_sh, const void* vs, long long vs_sh,
    const void* kn, long long kn_sh, long long kn_sr,
    const void* vn, long long vn_sh, long long vn_sr,
    TF_FD_TAIL_PARAMS) {
  return run<true>(1, q, 0, q_sh, q_sr, k, 0, k_sh, k_sr, v, 0, v_sh, v_sr,
                   ks, 0, ks_sh, vs, 0, vs_sh, kn, 0, kn_sh, kn_sr,
                   vn, 0, vn_sh, vn_sr, 0, TF_FD_TAIL_ARGS);
}

// Row-batched: q [B, Hkv, GT, D], k/v [B, Hkv, S, D] (any strides with a
// unit D stride: a layer of a [B, L, Hkv, S, D] pool is such a view),
// kn/vn [B, Hkv, Tn, D], mask [B, GT, Tn] (mask_sb = GT * Tn, or 0 for one
// mask shared by all rows), k_len [B] int32, out [B, Hkv, GT, D]; the
// scratch holds B x the single-row scratch. nsplit is per row.
extern "C" int tf_flash_decode_batched_bf16(
    int bsz, const void* q, long long q_sb, long long q_sh, long long q_sr,
    const void* k, long long k_sb, long long k_sh, long long k_sr,
    const void* v, long long v_sb, long long v_sh, long long v_sr,
    const void* kn, long long kn_sb, long long kn_sh, long long kn_sr,
    const void* vn, long long vn_sb, long long vn_sh, long long vn_sr,
    long long mask_sb, TF_FD_TAIL_PARAMS) {
  return run<false>(bsz, q, q_sb, q_sh, q_sr, k, k_sb, k_sh, k_sr,
                    v, v_sb, v_sh, v_sr, nullptr, 0, 0, nullptr, 0, 0,
                    kn, kn_sb, kn_sh, kn_sr, vn, vn_sb, vn_sh, vn_sr, mask_sb,
                    TF_FD_TAIL_ARGS);
}

// Row-batched int8: ks/vs fp32 [B, Hkv, S] with row and head strides
extern "C" int tf_flash_decode_batched_int8(
    int bsz, const void* q, long long q_sb, long long q_sh, long long q_sr,
    const void* k, long long k_sb, long long k_sh, long long k_sr,
    const void* v, long long v_sb, long long v_sh, long long v_sr,
    const void* ks, long long ks_sb, long long ks_sh,
    const void* vs, long long vs_sb, long long vs_sh,
    const void* kn, long long kn_sb, long long kn_sh, long long kn_sr,
    const void* vn, long long vn_sb, long long vn_sh, long long vn_sr,
    long long mask_sb, TF_FD_TAIL_PARAMS) {
  return run<true>(bsz, q, q_sb, q_sh, q_sr, k, k_sb, k_sh, k_sr,
                   v, v_sb, v_sh, v_sr, ks, ks_sb, ks_sh, vs, vs_sb, vs_sh,
                   kn, kn_sb, kn_sh, kn_sr, vn, vn_sb, vn_sh, vn_sr, mask_sb,
                   TF_FD_TAIL_ARGS);
}

// Cache-only partials (no new block, no normalisation): q [Hkv, GT, D] bf16,
// k/v [Hkv, S, D] (a layer view: pointer + strides), k_len one int32;
// m_out / l_out [Hkv, GT] and acc_out [Hkv, GT, D] fp32, contiguous. The
// scratch is sized as for tf_flash_decode_bf16.
extern "C" int tf_flash_decode_partials_bf16(
    const void* q, long long q_sh, long long q_sr,
    const void* k, long long k_sh, long long k_sr,
    const void* v, long long v_sh, long long v_sr,
    const void* k_len, void* m_part, void* l_part, void* acc_part,
    void* m_out, void* l_out, void* acc_out,
    int hkv, int gt, int s, int d, int nsplit, float scale, void* stream) {
  return run_partials<false>(q, q_sh, q_sr, k, k_sh, k_sr, v, v_sh, v_sr,
                             nullptr, 0, nullptr, 0, k_len, m_part, l_part,
                             acc_part, m_out, l_out, acc_out, hkv, gt, s, d,
                             nsplit, scale, stream);
}

// int8 cache: codes + fp32 scales [Hkv, S], as tf_flash_decode_int8
extern "C" int tf_flash_decode_partials_int8(
    const void* q, long long q_sh, long long q_sr,
    const void* k, long long k_sh, long long k_sr,
    const void* v, long long v_sh, long long v_sr,
    const void* ks, long long ks_sh, const void* vs, long long vs_sh,
    const void* k_len, void* m_part, void* l_part, void* acc_part,
    void* m_out, void* l_out, void* acc_out,
    int hkv, int gt, int s, int d, int nsplit, float scale, void* stream) {
  return run_partials<true>(q, q_sh, q_sr, k, k_sh, k_sr, v, v_sh, v_sr,
                            ks, ks_sh, vs, vs_sh, k_len, m_part, l_part,
                            acc_part, m_out, l_out, acc_out, hkv, gt, s, d,
                            nsplit, scale, stream);
}
