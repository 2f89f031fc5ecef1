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
// of bf16's. The wide shapes use each byte GT times (4 GT D FLOP per 4 D
// bytes of K and V): the 128-row tree verify (128 FLOP a byte, below the
// card's ~295) is still bound by bytes, the 512-row prefill tile (512) by
// tensor-core operations, and there its exponentials (one a score, 16 a
// clock on an SM's special-function units) and the int8 p codes'
// arithmetic come close to bounding it too.
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
//   grow levels, a GQA prefill chunk's G x T rows): fd_wide_kernel, grid
//   (q tile, split, row x head), one warpgroup (64 query rows) a CTA up to
//   GT = 64 and two (128 rows, one K/V ring for both) above (wide_wgs; the
//   wrapper reads the q tile from tf_flash_decode_cta_rows); the q tiles of
//   a (split, head) are neighbours in launch order, so they share K/V in L2.
//   - The ring holds 64-key stages in dynamic shared memory (3, or 4 at 128
//     rows), filled by cp.async STAGES - 1 tiles ahead; the ragged end is
//     zero-filled and masked. bf16 stages are laid out in wgmma's 128-byte
//     swizzle (16-byte chunk c of key r at chunk c ^ (r % 8)).
//   - bf16: per 64-key tile S = q'.K^T is one wgmma chain (m64n64k16, q'
//     from registers, K from the ring) and O += bf16(p).V another
//     (m64nDk16, p from registers in the accumulator's own layout, V read
//     through the transposing descriptor), fp32 accumulators, each chain
//     waited for before its registers are touched (so that ptxas keeps the
//     wgmma pipelined); p = exp2 on the special-function unit.
//   - int8: each warp owns 16 rows and all 64 keys of a tile, on the decode
//     path's s8 mma.sync fragments (codes kept int8 in the ring, the p
//     codes per 16-key group), so the results are the plain version's up to
//     fp32 summation order.
//   - Each split writes one partial per row. fd_wide_fold_kernel, launched
//     as a programmatic dependent, folds the new block in on the same bf16
//     wgmma products (q' from shared memory there), one CTA per q tile: it
//     takes each row's maximum new score
//     before waiting for phase 1, then merges the cache partials (weights in
//     parallel, sums in split order), fixes the row's maximum and adds
//     bf16(p).v_new, so the new block's p is rounded against the row's
//     maximum, as the TPU kernel's fold rounds it; a new-block tile whose
//     mask hides every key from every row of the CTA is skipped. With one
//     split (the prefill tile) the phase-1 CTA folds in itself, with no
//     second launch (7% faster there than the dependent launch; PERF.md).
//     The partials entry points take fd_wide_merge_kernel
//     (a warp per row) instead and stop before the fold.
//   - The split count fills whole waves of the card's occupancy, from the
//     shape alone (ops/flash_decode.py: wide_nsplit).
//
// Sliding windows (tf_flash_decode_window_bf16). A sliding-window layer's
// cache is a ring of s slots, position p at slot p mod s, and k_len is the
// sequence length L (it may pass s: split_share clamps the slots read to
// min(L, s)). Query row r is token t = r mod wtok of the wtok new tokens,
// and sees slot j iff the slot's age (L - 1 - j) mod s is at most
// window - 2 - t: positions L + t - window + 1 .. L - 1, and itself in the
// new block. Both paths' phase 1 mask the scores by it (`age_of`); the
// new block keeps its mask (the caller's causal one). The test sits in
// kernels of their own (fd_decode_window_kernel, fd_wide_window_kernel:
// the phase-1 bodies instantiated with WIN), so B1's launches for full
// layers run tile loops with no window arithmetic in them.
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
constexpr int WARPS = 4;         // warps per CTA of the decode kernel

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
  int nparts;              // partials per row (tf_flash_decode_parts)
  float scale;
  int window, wtok;        // WIN: the window and the new tokens (rows mod)
};

// WIN: the age of ring slot j when slot top holds the newest position
// (top = (L - 1) mod s), and the largest age query row r sees
__device__ __forceinline__ int age_of(int j, int top, int s) {
  return j <= top ? top - j : top - j + s;
}
__device__ __forceinline__ int age_limit(const SplitArgs& P, int r) {
  return P.window - 2 - r % P.wtok;
}

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

// ---------------------------------------------------------------------------
// The decode path (GT <= DECODE_ROWS): fd_decode_kernel, then fd_reduce_kernel
// ---------------------------------------------------------------------------

constexpr int DECODE_ROWS = 16;   // query rows of one mma tile

// 1: every dependent launch (the reduce, the wide fold and merge) is a
// programmatic dependent of the launch before it, which a CUDA graph
// capture keeps as a programmatic edge; 0: ordinary launches (the
// dependent's griddepcontrol.wait then returns at once). A switch for
// measuring the edge (tf_flash_decode_set_pdl).
int g_pdl = 1;
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
template <int D, bool QUANT, bool WIN>
__device__ __forceinline__ void decode_split(const SplitArgs& P) {
  static_assert(!(WIN && QUANT), "the window is a bf16 path");
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
  // WIN: the newest slot, and the oldest age rows g and g + 8 see
  int top = 0, lim0 = 0, lim1 = 0;
  if constexpr (WIN) {
    top = (P.k_len[b] - 1) % P.s;
    lim0 = age_limit(P, g);
    lim1 = age_limit(P, g + 8);
  }

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
    if constexpr (WIN) {   // and ring slots older than each row's window
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int age = age_of(kb + kw0 + n * 8 + 2 * t + e, top, P.s);
          if (age > lim0) sc[n][e] = -INFINITY;
          if (age > lim1) sc[n][2 + e] = -INFINITY;
        }
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
    // ps: the same softmax, with integer codes that do not depend on where
    // a running max stands (the splits keep their own)
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

template <int D, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
fd_decode_kernel(SplitArgs P) {
  decode_split<D, QUANT, false>(P);
}

// The same over a sliding-window layer's ring (WIN): a kernel of its own,
// so that a trace tells the two apart
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
fd_decode_window_kernel(SplitArgs P) {
  decode_split<D, false, true>(P);
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
// the mask bias and normalise; else stop there, with (-1e30, 0, 0) when no
// split is live.
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

// The decode path: fd_decode_kernel, then fd_reduce_kernel with (FOLD) or
// without the new-token fold. The ring is dynamic shared memory, above the
// 48 KB a kernel gets without asking.
template <int D, bool QUANT, bool FOLD, bool WIN = false>
int launch_decode(const SplitArgs& sa, const ReduceArgs& ra, int bh, cudaStream_t st) {
  using R = Ring<D, QUANT>;
  void (*split)(SplitArgs) = fd_decode_kernel<D, QUANT>;
  if constexpr (WIN) split = fd_decode_window_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       R::BYTES);
  if (e != cudaSuccess) return (int)e;
  split<<<dim3(sa.nsplit, 1, bh), WARPS * 32, R::BYTES, st>>>(sa);
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
  cfg.numAttrs = g_pdl;
  return (int)cudaLaunchKernelEx(&cfg, fd_reduce_kernel<D, RQ, FOLD>, ra);
}

// ---------------------------------------------------------------------------
// The wide path (GT > DECODE_ROWS): fd_wide_kernel, then fd_wide_fold_kernel
// (fd_wide_merge_kernel for the partials)
// ---------------------------------------------------------------------------

constexpr int WIDE_MAX_SPLITS = 64;   // cache splits phase 2 weighs

// query rows of one wide CTA: one warpgroup (64 rows) up to GT = 64, two
// above (128 rows, one ring of K/V for both)
__host__ __device__ constexpr int wide_wgs(int gt) { return gt <= 64 ? 1 : 2; }

struct WideArgs {
  SplitArgs c;        // q, the cache, k_len, the partials; c.nsplit splits
  const __nv_bfloat16* kn;  long long kn_sb, kn_sh, kn_sr;   // the new block
  const __nv_bfloat16* vn;  long long vn_sb, vn_sh, vn_sr;
  const uint8_t* mask;      long long mask_sb;   // [B, GT, Tn], 1 = attend
  int tn;             // new tokens (0 for the partials: no new block)
  float* out;         // [B, Hkv, GT, D]
};

// Shared memory of fd_wide_kernel: the CTA's q panel (bf16, for wgmma), then
// the K/V ring. A bf16 stage holds KT keys of K and of V, each as D / 64
// column blocks of KT rows x 128 bytes in the 128-byte swizzle wgmma reads
// (16-byte chunk c of row r at chunk c ^ (r % 8)). An int8 stage holds the
// codes as the decode kernel's Ring does (rows padded by 16 bytes for
// ldmatrix), then the KT fp32 scales of K and of V; the int8 kernel's ring
// has the bf16 ring's bytes, which its new block uses.
template <int D, int NWG>
struct WideSmem {
  static constexpr int R = 64 * NWG;                // query rows per CTA
  static constexpr int Q_BYTES = R * D * 2;
  static constexpr int BF_STAGE = 2 * KT * D * 2;
  static constexpr int BF_STAGES = NWG == 2 ? 4 : 3;   // 2 CTAs/SM at 64 rows
  static constexpr int RING = BF_STAGES * BF_STAGE;
  static constexpr int I8_ROW = D + 16;
  static constexpr int I8_KV = KT * I8_ROW;
  static constexpr int I8_STAGE = 2 * I8_KV + 2 * KT * 4;
  static constexpr int I8_STAGES = RING / I8_STAGE;
  static constexpr int BYTES = 1024 + Q_BYTES + RING;   // + alignment slack
  static_assert(I8_STAGES >= 3 && I8_STAGE % 16 == 0, "int8 ring");
};

__device__ __forceinline__ void fence_proxy_async() {
  // this thread's shared-memory writes become visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching x across an in-flight wgmma: x is read or
// written by the product until wgmma_wait0, which the compiler cannot see
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j]) :: "memory");
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B N-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B N-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// byte offset of 16-byte chunk cc of row r in a [rows x D] bf16 panel of
// D / 64 swizzled column blocks
template <int ROWS>
__device__ __forceinline__ int swz(int r, int cc) {
  return (cc >> 3) * (ROWS * 128) + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// Phase 2's merge of the cache partials into a thread's two rows ra / rb
// of the fold, after phase 1 (griddepcontrol.wait): M = max m_s over the
// splits that held a key of the row (split_share's arithmetic), acc and l
// summed with weights e^(m_s - M) in split order, then rescaled to the
// row's maximum m = max(M, the new scores' maximum in m_r); on return m_r
// holds m, o the rescaled acc in the accumulator layout, and l_r the
// rescaled l on the quad's thread t = 0 (the others 0: l_r is summed over
// the quad at the end). A row with no live split has M = -inf: weight 0.
template <int D>
__device__ __forceinline__ void fold_cache(const SplitArgs& P, int b, int bh, int ra,
                                           int rb, int t, float (&m_r)[2],
                                           float (&l_r)[2], float (&o)[D / 2]) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int live = klen == 0 ? 0 : (klen + per - 1) / per;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= P.gt) continue;
    const long long o_ = ((long long)bh * P.gt + r) * P.nparts;
    float M = -INFINITY, L = 0.f;
    for (int s = 0; s < live; ++s) M = fmaxf(M, P.m_part[o_ + s]);
    for (int s = 0; s < live; ++s) {
      const float w = expf(P.m_part[o_ + s] - M);
      L += P.l_part[o_ + s] * w;
      const float* a = P.acc_part + (o_ + s) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(a + 8 * j);
        o[4 * j + 2 * half] += x.x * w;
        o[4 * j + 2 * half + 1] += x.y * w;
      }
    }
    const float m = fmaxf(M, m_r[half]);
    const float al = expf(M - m);   // M = -inf (no live split) -> 0
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * half] *= al;
      o[4 * j + 2 * half + 1] *= al;
    }
    m_r[half] = m;
    l_r[half] = t == 0 ? L * al : 0.f;
  }
}

// Copies of KT keys of K and of V (bf16, key stride krow / vrow bytes) from
// key kb on into a swizzled stage st, by the NT threads of the CTA; keys at
// or past end are zero-filled and never read (beg: any readable key).
template <int D, int NT>
__device__ __forceinline__ void fill_bf16(unsigned char* st, const char* kh, long long krow,
                                          const char* vh, long long vrow, int kb,
                                          int beg, int end) {
  constexpr int CH = D / 8;
  static_assert(KT * CH % NT == 0, "whole copy rounds per tile");
#pragma unroll
  for (int it = 0; it < KT * CH / NT; ++it) {
    const int c = threadIdx.x + it * NT;
    const int r = c / CH, cc = c % CH;
    const bool live = kb + r < end;
    const long long key = live ? kb + r : beg;
    const int off = swz<KT>(r, cc);
    cp_async16(st + off, kh + key * krow + cc * 16, live);
    cp_async16(st + KT * D * 2 + off, vh + key * vrow + cc * 16, live);
  }
}

// The CTA's q panel in shared memory: rows row0 .. row0 + R - 1 of q' =
// bf16(q / sqrt(D)), zero past GT; with Q8, bf16(q8 * qs) in place of q',
// q8 the int8 codes of q' at its row scale qs (what the int8 kernel's new
// block sees). A barrier follows before ldmatrix reads it.
template <int D, int R, int NT, bool Q8>
__device__ __forceinline__ void load_q_panel(unsigned char* sQ, const SplitArgs& P, int b,
                                             int h, int row0) {
  constexpr int CH = D / 8;
  const int tid = threadIdx.x;
  const __nv_bfloat16* qh = P.q + (long long)b * P.q_sb + (long long)h * P.q_sh;
  for (int c = tid; c < R * CH; c += NT) {
    const int r = c / CH, cc = c % CH;
    const __nv_bfloat16* qr = qh + (long long)(row0 + r) * P.q_sr + cc * 8;
    const bool live = row0 + r < P.gt;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = live ? pack_bf16(prescale(qr[2 * e], P.scale), prescale(qr[2 * e + 1], P.scale))
                  : 0u;
    *reinterpret_cast<uint4*>(sQ + swz<R>(r, cc)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if constexpr (Q8) {
    __syncthreads();
    if (tid < R) {
      float amax = 0.f;
      for (int cc = 0; cc < CH; ++cc) {
        const __nv_bfloat162* x =
            reinterpret_cast<const __nv_bfloat162*>(sQ + swz<R>(tid, cc));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(x[e]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
      const float qs = row_scale(amax);
      for (int cc = 0; cc < CH; ++cc) {
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(sQ + swz<R>(tid, cc));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(x[e]);
          x[e] = __floats2bfloat162_rn(code_nz(f.x, qs) * qs, code_nz(f.y, qs) * qs);
        }
      }
    }
  }
}

// The warp's q' fragments (the m16n8k16 A operand of k-step kk, its 16
// rows of the warpgroup's 64) from the panel, by ldmatrix: lane l gives the
// address of row l % 16 at column 8 (l / 16) of the k-step
template <int D, int R>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const unsigned char* sQ) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], sQ + swz<R>(r, 2 * kk + (lane >> 4)));
}

// S[64 x 64] = q'[64 x D] . K^T, one wgmma chain with q' from registers and
// K from the ring, issued and committed (not waited for): s[4j + e] is row
// g + 8 (e >> 1), key 8j + 2t + (e & 1) of the warp's 16 rows
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[32], const uint32_t (&qf)[D / 16][4],
                                        uint32_t k_base) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_n64_kmajor(s, qf[kk],
                        gdesc(k_base + (kk >> 2) * (KT * 128) + (kk & 3) * 32, 16, 1024));
  wgmma_commit();
}

// issue_s with q' read from the panel in shared memory (q_base: the
// warpgroup's rows; the panel fenced for the async proxy), for the fold
template <int D, int R>
__device__ __forceinline__ void issue_s_ss(float (&s)[32], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, gdesc(q_base + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024),
                 gdesc(k_base + (kk >> 2) * (KT * 128) + (kk & 3) * 32, 16, 1024));
  wgmma_commit();
}

// O[64 x D] += bf16(p)[64 x KT] . V, one wgmma chain with p from registers
// (the accumulator layout of S is the m16n8k16 A layout of each warp's 16
// rows), issued and committed: V's 16 keys of k-step kk at kk * 2048 bytes
// (two 8-row swizzle atoms), its column blocks KT * 128 bytes apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[KT / 16][4],
                                         uint32_t v_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint64_t dv = gdesc(v_base + kk * 2048, KT * 128, 1024);
    if constexpr (D == 128) wgmma_rs_n128(o, pa[kk], dv);
    else wgmma_rs_n64(o, pa[kk], dv);
  }
  wgmma_commit();
}

// s (the S layout) -> bf16 pairs of the A operand of the p.v chain
__device__ __forceinline__ void pack_p(uint32_t (&pa)[KT / 16][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[kk][a] = pack_bf16(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1]);
}

// max over each of the thread's two rows of s (the quad's 4 threads share
// a row)
__device__ __forceinline__ void row_max(const float (&s)[32], float& mx0, float& mx1) {
  mx0 = mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
}

// 2^x on the special-function unit (relative error ~2^-22; the bf16 path
// rounds p to bf16 after it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a thread's two row sums l -> row sums (the 4 threads t of a row)
__device__ __forceinline__ void quad_sum2(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// Phase 1 over a split [beg, end) of a bf16 cache. Warpgroup w owns rows
// row0 + 64w ..; the CTA's warpgroups share one ring of BF_STAGES stages
// (one CTA barrier a tile). Per tile i, with p(i) in registers: O to tile
// i's maximum, the p.v chain of tile i, then the S chain of tile i + 1 and
// its online softmax. Each chain is waited for before any other
// instruction touches its registers: an accumulator read while a chain is
// in flight makes ptxas serialize every wgmma of the kernel (its C7514
// warning), which cost more than the overlap gained (PERF.md). The
// two warpgroups' chains and softmaxes interleave on the SM. Writes one
// partial per row.
template <int D, int NWG, bool WIN>
__device__ __forceinline__ void wide_cache_bf16(const SplitArgs& P, unsigned char* smem,
                                                int beg, int end, int row0, int b, int h,
                                                int bh, int split) {
  using S = WideSmem<D, NWG>;
  constexpr int R = S::R, NT = NWG * 128, ST = S::BF_STAGES;
  constexpr float L2E = 1.4426950408889634f;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* sQ = smem;
  unsigned char* ring = smem + S::Q_BYTES;
  const char* kh = (const char*)P.k + ((long long)b * P.k_sb + (long long)h * P.k_sh) * 2;
  const char* vh = (const char*)P.v + ((long long)b * P.v_sb + (long long)h * P.v_sh) * 2;
  const long long krow = P.k_sr * 2, vrow = P.v_sr * 2;
  const int n = (end - beg + KT - 1) / KT;
  auto stage = [&](int i) { return ring + (i % ST) * S::BF_STAGE; };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n) fill_bf16<D, NT>(stage(i), kh, krow, vh, vrow, beg + i * KT, beg, end);
    cp_async_commit();
  }
  load_q_panel<D, R, NT, false>(sQ, P, b, h, row0);
  const bool wg_live = row0 + wg * 64 < P.gt;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  uint32_t pa[KT / 16][4];
  // WIN: the newest slot, and the oldest age this thread's two rows see
  int top = 0, lim0 = 0, lim1 = 0;
  if constexpr (WIN) {
    const int ra = row0 + wg * 64 + warp * 16 + g;
    top = (P.k_len[b] - 1) % P.s;
    lim0 = age_limit(P, ra);
    lim1 = age_limit(P, ra + 8);
  }

  // the softmax of the tile at kb on s, in place: mask keys past end (and
  // WIN: slots older than the row's window), move the running max,
  // s = p = e^(s - m); al = e^(m_old - m)
  auto softmax = [&](float (&s)[32], int kb, float& al0, float& al1) {
    if (kb + KT > end) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kb + 8 * j + 2 * t + e >= end) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
    }
    if constexpr (WIN) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int age = age_of(kb + 8 * j + 2 * t + e, top, P.s);
          if (age > lim0) s[4 * j + e] = -INFINITY;
          if (age > lim1) s[4 * j + 2 + e] = -INFINITY;
        }
    }
    float mx0, mx1;
    row_max(s, mx0, mx1);
    const float mn0 = fmaxf(m_r[0], mx0), mn1 = fmaxf(m_r[1], mx1);
    // a row with nothing valid yet keeps p 0
    const float b0 = (mn0 == -INFINITY ? 0.f : mn0) * L2E;
    const float b1 = (mn1 == -INFINITY ? 0.f : mn1) * L2E;
    al0 = ex2(fmaf(m_r[0], L2E, -b0));
    al1 = ex2(fmaf(m_r[1], L2E, -b1));
    m_r[0] = mn0; m_r[1] = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], L2E, -b0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], L2E, -b0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], L2E, -b1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], L2E, -b1));
      ls0 += s[4 * j] + s[4 * j + 1];
      ls1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l_r[0] = l_r[0] * al0 + ls0;
    l_r[1] = l_r[1] * al1 + ls1;
  };

  // tile 0: S, softmax, p(0)
  float al0 = 1.f, al1 = 1.f;
  cp_async_wait<ST - 2>();
  fence_proxy_async();
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_q_frags<D, R>(qf, sQ);
  if (wg_live) {
    float s[32];
    issue_s<D>(s, qf, smem_u32(stage(0)));
    wgmma_wait0();
    reg_fence(s);
    softmax(s, beg, al0, al1);
    pack_p(pa, s);
  }
  for (int i = 0; i < n; ++i) {
    // tile i + 1 landed everywhere, and every warpgroup's p.v of tile i - 1
    // is done: refill the stage it held
    cp_async_wait<ST - 3>();
    fence_proxy_async();
    __syncthreads();
    {
      const int nx = i + ST - 1;
      if (nx < n) fill_bf16<D, NT>(stage(nx), kh, krow, vh, vrow, beg + nx * KT, beg, end);
      cp_async_commit();
    }
    if (!wg_live) continue;
    // O to tile i's maximum, then O += p(i).V(i)
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al0; o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1; o[4 * j + 3] *= al1;
      }
    }
    issue_pv<D>(o, pa, smem_u32(stage(i)) + KT * D * 2);
    wgmma_wait0();
    reg_fence(o);
    reg_fence(pa);
    if (i + 1 < n) {
      float s[32];
      issue_s<D>(s, qf, smem_u32(stage(i + 1)));
      wgmma_wait0();
      reg_fence(s);
      softmax(s, beg + (i + 1) * KT, al0, al1);
      pack_p(pa, s);
    }
  }
  cp_async_wait<0>();

  quad_sum2(l_r);
  const long long hrow = (long long)bh * P.gt;
  const int ra = row0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    if (r >= P.gt) continue;
    const long long o_ = (hrow + r) * P.nparts + split;
    if (t == 0) { P.m_part[o_] = m_r[half]; P.l_part[o_] = l_r[half]; }
    float* a = P.acc_part + o_ * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(a + 8 * j + 2 * t) =
          make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
  }
}

// Phase 2 with a new block (B1, B3), on the bf16 products of phase 1: the
// CTA's rows against the Tn new tokens under the mask bias, walked twice.
// Pass 1 takes each row's maximum new score before phase 1 is waited for;
// then the cache partials are merged in (fold_cache), the row's maximum
// m = max(M, new) is final, and pass 2 adds bf16(e^(s - m)) . V, so the new
// block's p is rounded against the row's maximum, as the TPU kernel's fold
// and the plain version round it; then it normalises. A tile whose mask
// hides every key from every row of the CTA adds nothing to a row that
// attends some token (its p is exactly 0), so it is skipped when every live
// row attends some token; a row that attends none keeps the plain
// version's softmax over the masked scores.
template <int D, bool QUANT, int NWG>
__device__ __forceinline__ void wide_fold(const WideArgs& A, unsigned char* smem, int row0,
                                          int b, int h, int bh) {
  using S = WideSmem<D, NWG>;
  constexpr int R = S::R, NT = NWG * 128, ST = S::BF_STAGES;
  const SplitArgs& P = A.c;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* sQ = smem;
  unsigned char* ring = smem + S::Q_BYTES;
  const char* kh = (const char*)(A.kn + (long long)b * A.kn_sb + (long long)h * A.kn_sh);
  const char* vh = (const char*)(A.vn + (long long)b * A.vn_sb + (long long)h * A.vn_sh);
  const long long krow = A.kn_sr * 2, vrow = A.vn_sr * 2;
  const int tn = A.tn, ntiles = (tn + KT - 1) / KT, nsteps = 2 * ntiles;
  auto stage = [&](int i) { return ring + (i % ST) * S::BF_STAGE; };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nsteps) fill_bf16<D, NT>(stage(i), kh, krow, vh, vrow, (i % ntiles) * KT, 0, tn);
    cp_async_commit();
  }
  load_q_panel<D, R, NT, QUANT>(sQ, P, b, h, row0);
  int ok = 1;
  if (tid < R && row0 + tid < P.gt) {
    const uint8_t* mr = A.mask + (long long)b * A.mask_sb + (long long)(row0 + tid) * tn;
    ok = 0;
    for (int j = 0; j < tn && !ok; ++j) ok = mr[j];
  }
  const bool may_skip = __syncthreads_and(ok);

  const int ra = row0 + wg * 64 + warp * 16 + g, rb = ra + 8;   // this thread's rows
  const bool wg_live = row0 + wg * 64 < P.gt;
  const uint8_t* mra = A.mask + (long long)b * A.mask_sb + (long long)ra * tn;
  const uint8_t* mrb = mra + 8LL * tn;
  fence_proxy_async();
  const uint32_t q_base = smem_u32(sQ) + wg * 64 * 128;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};   // pass 1: the new scores' maximum
  float l_r[2] = {0.f, 0.f};

  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<ST - 2>();   // this thread's copies of step i landed
    fence_proxy_async();
    __syncthreads();           // everyone's landed; step i - 1 consumed
    {
      const int nx = i + ST - 1;
      if (nx < nsteps)
        fill_bf16<D, NT>(stage(nx), kh, krow, vh, vrow, (nx % ntiles) * KT, 0, tn);
      cp_async_commit();
    }
    const int kb = (i % ntiles) * KT;
    const bool pass2 = i >= ntiles;
    if (i == ntiles) fold_cache<D>(P, b, bh, ra, rb, t, m_r, l_r, o);
    // allowed (row a / b, key 8j + 2t + e), bit 2j + e
    uint32_t al_a = 0, al_b = 0;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kb + 8 * j + 2 * t + e;
        if (key < tn) {
          if (ra < P.gt && mra[key]) al_a |= 1u << (2 * j + e);
          if (rb < P.gt && mrb[key]) al_b |= 1u << (2 * j + e);
        }
      }
    if (!__syncthreads_or((al_a | al_b) != 0) && may_skip) continue;
    if (!wg_live) continue;
    float s[32];
    issue_s_ss<D, R>(s, q_base, smem_u32(stage(i)));
    wgmma_wait0();
    reg_fence(s);
    // keys past Tn are dead; a masked token scores s - 1e30
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int bit = 2 * j + e;
        if (kb + 8 * j + 2 * t + e >= tn) {
          s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
        } else {
          if (!((al_a >> bit) & 1u)) s[4 * j + e] += -1e30f;
          if (!((al_b >> bit) & 1u)) s[4 * j + 2 + e] += -1e30f;
        }
      }
    float mx0, mx1;
    row_max(s, mx0, mx1);
    if (!pass2) {   // pass 1: the maximum only
      m_r[0] = fmaxf(m_r[0], mx0);
      m_r[1] = fmaxf(m_r[1], mx1);
      continue;
    }
    // pass 2: p = e^(s - m) against the final maximum
    const float b0 = m_r[0] == -INFINITY ? 0.f : m_r[0];
    const float b1 = m_r[1] == -INFINITY ? 0.f : m_r[1];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[4 * j] = expf(s[4 * j] - b0);
      s[4 * j + 1] = expf(s[4 * j + 1] - b0);
      s[4 * j + 2] = expf(s[4 * j + 2] - b1);
      s[4 * j + 3] = expf(s[4 * j + 3] - b1);
      l_r[0] += s[4 * j] + s[4 * j + 1];
      l_r[1] += s[4 * j + 2] + s[4 * j + 3];
    }
    uint32_t pa[KT / 16][4];
    pack_p(pa, s);
    issue_pv<D>(o, pa, smem_u32(stage(i)) + KT * D * 2);
    wgmma_wait0();
    reg_fence(o);
    reg_fence(pa);
  }
  cp_async_wait<0>();

  quad_sum2(l_r);
  const long long hrow = (long long)bh * P.gt;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= P.gt) continue;
    const float inv = fmaxf(l_r[half], 1e-37f);
    float* out = A.out + (hrow + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * t) =
          make_float2(o[4 * j + 2 * half] / inv, o[4 * j + 2 * half + 1] / inv);
  }
}

// The int8 cache split of a wide CTA: each of its 4 NWG warps owns 16 query
// rows and all KT keys of every tile, on the decode kernel's fragments
// (q8.k8 on m16n8k32 s8 products fed by ldmatrix, p8.v8 on m16n8k16 s8
// products fed by ldmatrix.trans + prmt, the p codes per 16-key group),
// through a ring of I8_STAGES int8 stages filled by cp.async.
template <int D, int NWG>
__device__ __forceinline__ void wide_int8(const SplitArgs& P, unsigned char* ring,
                                          int beg, int end, int row0, int b, int h,
                                          int bh, int split) {
  using S = WideSmem<D, NWG>;
  constexpr int NT = NWG * 128, CH = D / 16, NQ = D / 32;
  constexpr int ROW = S::I8_ROW, KV = S::I8_KV, STAGE = S::I8_STAGE, STAGES = S::I8_STAGES;
  static_assert(KT * CH % NT == 0 && 2 * KT <= NT, "whole copy rounds per tile");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (end - beg + KT - 1) / KT;
  const int8_t* kh = (const int8_t*)P.k + (long long)b * P.k_sb + (long long)h * P.k_sh;
  const int8_t* vh = (const int8_t*)P.v + (long long)b * P.v_sb + (long long)h * P.v_sh;
  const float* ksh = P.ks + (long long)b * P.ks_sb + (long long)h * P.ks_sh;
  const float* vsh = P.vs + (long long)b * P.vs_sb + (long long)h * P.vs_sh;

  auto fill = [&](int i, unsigned char* st) {
    const int kb = beg + i * KT;
#pragma unroll
    for (int it = 0; it < KT * CH / NT; ++it) {
      const int c = tid + it * NT;
      const int r = c / CH, col = (c % CH) * 16;
      const bool live = kb + r < end;
      const long long key = live ? kb + r : beg;
      cp_async16(st + r * ROW + col, kh + key * P.k_sr + col, live);
      cp_async16(st + KV + r * ROW + col, vh + key * P.v_sr + col, live);
    }
    if (tid < 2 * KT) {
      const int r = tid % KT;
      const bool live = kb + r < end;
      const long long key = live ? kb + r : beg;
      cp_async4(reinterpret_cast<float*>(st + 2 * KV) + tid, (tid < KT ? ksh : vsh) + key,
                live);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) fill(i, ring + i * STAGE);
    cp_async_commit();
  }

  // q8 fragments of this warp's rows rw .. rw + 15 (see fd_decode_kernel)
  const int rw = row0 + warp * 16;
  uint32_t qa[NQ][4];
  float qs_a, qs_b;
  {
    const __nv_bfloat16* qh = P.q + (long long)b * P.q_sb + (long long)h * P.q_sh;
    float x[NQ][4][4];
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = rw + g + 8 * (a & 1);
        const int c = kk * 32 + (a >> 1) * 16 + 4 * t;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          x[kk][a][v] = r < P.gt ? prescale(qh[(long long)r * P.q_sr + c + v], P.scale) : 0.f;
          amax[a & 1] = fmaxf(amax[a & 1], fabsf(x[kk][a][v]));
        }
      }
    }
    qs_a = row_scale(quad_max(amax[0]));
    qs_b = row_scale(quad_max(amax[1]));
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float s = (a & 1) ? qs_b : qs_a;
        qa[kk][a] = pack_s8(code_nz(x[kk][a][0], s), code_nz(x[kk][a][1], s),
                            code_nz(x[kk][a][2], s), code_nz(x[kk][a][3], s));
      }
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this lane's ldmatrix row within 16 keys: q.k^T matrices 0/1 keys 0-7,
  // 2/3 keys 8-15; p.v (trans) 0/2 keys 0-7, 1/3 keys 8-15
  const int krow_l = ((lane >> 4) << 3) + (lane & 7);
  const int vrow_l = (((lane >> 3) & 1) << 3) + (lane & 7);
  const bool live_warp = rw < P.gt;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nx = i + STAGES - 1;
      if (nx < ntiles) fill(nx, ring + (nx % STAGES) * STAGE);
      cp_async_commit();
    }
    if (!live_warp) continue;
    const unsigned char* sK = ring + (i % STAGES) * STAGE;
    const unsigned char* sV = sK + KV;
    const float* sKs = reinterpret_cast<const float*>(sK + 2 * KV);
    const float* sVs = sKs + KT;
    const int kb = beg + i * KT;

    // scores of the tile: n-tile n holds keys 8n + (2t, 2t + 1); exact
    // integer dots -> ((dot * qs) * ks), as on the TPU
    float sc[KT / 8][4];
#pragma unroll
    for (int p = 0; p < KT / 16; ++p) {
      int ci[2][4] = {{I2F_BIAS, I2F_BIAS, I2F_BIAS, I2F_BIAS},
                      {I2F_BIAS, I2F_BIAS, I2F_BIAS, I2F_BIAS}};
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, sK + (16 * p + krow_l) * ROW + kk * 32 + ((lane >> 3) & 1) * 16);
        mma_s8_k32(ci[0], qa[kk], r[0], r[1]);
        mma_s8_k32(ci[1], qa[kk], r[2], r[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int kt = 16 * p + 8 * n + 2 * t;
        sc[2 * p + n][0] = unbias(ci[n][0]) * qs_a * sKs[kt];
        sc[2 * p + n][1] = unbias(ci[n][1]) * qs_a * sKs[kt + 1];
        sc[2 * p + n][2] = unbias(ci[n][2]) * qs_b * sKs[kt];
        sc[2 * p + n][3] = unbias(ci[n][3]) * qs_b * sKs[kt + 1];
      }
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const int key = kb + 8 * n + 2 * t;
      if (key >= end)     { sc[n][0] = -INFINITY; sc[n][2] = -INFINITY; }
      if (key + 1 >= end) { sc[n][1] = -INFINITY; sc[n][3] = -INFINITY; }
    }
    // each 16-key group's row maxima (the re-quantization group), the tile's
    float gm0[KT / 16], gm1[KT / 16];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      gm0[j] = quad_max(fmaxf(fmaxf(sc[2 * j][0], sc[2 * j][1]),
                              fmaxf(sc[2 * j + 1][0], sc[2 * j + 1][1])));
      gm1[j] = quad_max(fmaxf(fmaxf(sc[2 * j][2], sc[2 * j][3]),
                              fmaxf(sc[2 * j + 1][2], sc[2 * j + 1][3])));
      mx0 = fmaxf(mx0, gm0[j]);
      mx1 = fmaxf(mx1, gm1[j]);
    }
    const float mn0 = fmaxf(m_r[0], mx0), mn1 = fmaxf(m_r[1], mx1);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = expf(m_r[0] - base0), al1 = expf(m_r[1] - base1);
    m_r[0] = mn0; m_r[1] = mn1;
    l_r[0] *= al0;
    l_r[1] *= al1;
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= al0; acc[n][1] *= al0;
        acc[n][2] *= al1; acc[n][3] *= al1;
      }
    }
    // per group: p = exp(s - gm), weighted by w = exp(gm - m); acc +=
    // (p8 . v8) * ps * w, p8 the codes of p * vs at the row's scale ps
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      // an all-masked group has p 0 and weight 0
      const float gb0 = gm0[j] == -INFINITY ? 0.f : gm0[j];
      const float gb1 = gm1[j] == -INFINITY ? 0.f : gm1[j];
      const float w0 = gm0[j] == -INFINITY ? 0.f : expf(gm0[j] - base0);
      const float w1 = gm1[j] == -INFINITY ? 0.f : expf(gm1[j] - base1);
      float pr[4][2];
      pr[0][0] = expf(sc[2 * j][0] - gb0);     pr[0][1] = expf(sc[2 * j][1] - gb0);
      pr[1][0] = expf(sc[2 * j][2] - gb1);     pr[1][1] = expf(sc[2 * j][3] - gb1);
      pr[2][0] = expf(sc[2 * j + 1][0] - gb0); pr[2][1] = expf(sc[2 * j + 1][1] - gb0);
      pr[3][0] = expf(sc[2 * j + 1][2] - gb1); pr[3][1] = expf(sc[2 * j + 1][3] - gb1);
      l_r[0] += w0 * (pr[0][0] + pr[0][1] + pr[2][0] + pr[2][1]);
      l_r[1] += w1 * (pr[1][0] + pr[1][1] + pr[3][0] + pr[3][1]);
      const int r0 = 16 * j + 2 * t;
      const float v0 = sVs[r0], v1 = sVs[r0 + 1];
      const float v8 = sVs[r0 + 8], v9 = sVs[r0 + 9];
      pr[0][0] *= v0; pr[0][1] *= v1; pr[1][0] *= v0; pr[1][1] *= v1;
      pr[2][0] *= v8; pr[2][1] *= v9; pr[3][0] *= v8; pr[3][1] *= v9;
      float ps0 = row_scale(quad_max(fmaxf(fmaxf(fabsf(pr[0][0]), fabsf(pr[0][1])),
                                           fmaxf(fabsf(pr[2][0]), fabsf(pr[2][1])))));
      float ps1 = row_scale(quad_max(fmaxf(fmaxf(fabsf(pr[1][0]), fabsf(pr[1][1])),
                                           fmaxf(fabsf(pr[3][0]), fabsf(pr[3][1])))));
      // A operand (m16n8k16, 8-bit): k slot 4t + j' is key (2t, 2t + 1,
      // 8 + 2t, 9 + 2t)[j'] of the group; the B operand below uses the same
      const uint32_t a0 = pack_s8(code(pr[0][0], ps0), code(pr[0][1], ps0),
                                  code(pr[2][0], ps0), code(pr[2][1], ps0));
      const uint32_t a1 = pack_s8(code(pr[1][0], ps1), code(pr[1][1], ps1),
                                  code(pr[3][0], ps1), code(pr[3][1], ps1));
      ps0 *= w0;
      ps1 *= w1;
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        uint32_t r[4];
        ldsm_x4_t(r, sV + (16 * j + vrow_l) * ROW + jj * 32 + (lane >> 4) * 16);
        const uint32_t bq[4] = {__byte_perm(r[0], r[1], 0x6420),   // even columns
                                __byte_perm(r[0], r[1], 0x7531),   // odd columns
                                __byte_perm(r[2], r[3], 0x6420),
                                __byte_perm(r[2], r[3], 0x7531)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int c[4] = {I2F_BIAS, I2F_BIAS, I2F_BIAS, I2F_BIAS};   // |p8 . v8| < 2^22
          mma_s8_k16(c, a0, a1, bq[q]);
          acc[4 * jj + q][0] += unbias(c[0]) * ps0;
          acc[4 * jj + q][1] += unbias(c[1]) * ps0;
          acc[4 * jj + q][2] += unbias(c[2]) * ps1;
          acc[4 * jj + q][3] += unbias(c[3]) * ps1;
        }
      }
    }
  }
  cp_async_wait<0>();

  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 1);
  l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], 2);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 1);
  l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], 2);
  const long long hrow = (long long)bh * P.gt;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rw + g + 8 * half;
    if (r >= P.gt) continue;
    const long long o_ = (hrow + r) * P.nparts + split;
    if (t == 0) { P.m_part[o_] = m_r[half]; P.l_part[o_] = l_r[half]; }
    float* a = P.acc_part + o_ * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) a[acc_col<true>(n, e, t)] = acc[n][2 * half + e];
  }
}

// Phase 1 of the wide path: grid (q tile, split, batch row x head), 4 NWG
// warps. Each split takes its share of the row's [0, k_len) (split_share;
// an empty share exits at once and writes nothing) and writes one partial
// per row: bf16 on wgmma (wide_cache_bf16), int8 on the decode kernel's s8
// fragments (wide_int8). The q tiles of one (split, head) are neighbours in
// launch order, so the second reads the K/V the first brought into L2.
template <int D, bool QUANT, int NWG, bool WIN>
__device__ __forceinline__ void wide_split(const WideArgs& A) {
  static_assert(!(WIN && QUANT), "the window is a bf16 path");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // phase 2, launched as this grid's programmatic dependent, may start
  // now: it waits for this grid before reading a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const SplitArgs& P = A.c;
  const int row0 = blockIdx.x * WideSmem<D, NWG>::R, split = blockIdx.y;
  const int bh = blockIdx.z, b = bh / P.hkv, h = bh % P.hkv;
  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int beg = split * per, end = min(klen, beg + per);
  // one split holds the rows' whole prefix: this CTA folds the new block
  // in itself (wide_fold), with no second launch
  const bool fold_here = A.tn > 0 && P.nsplit == 1;
  if (beg < end) {
    if constexpr (QUANT)
      wide_int8<D, NWG>(P, smem + WideSmem<D, NWG>::Q_BYTES, beg, end, row0, b, h, bh,
                        split);
    else
      wide_cache_bf16<D, NWG, WIN>(P, smem, beg, end, row0, b, h, bh, split);
  }
  if (!fold_here) return;
  __syncthreads();   // the partial written, the ring drained
  wide_fold<D, QUANT, NWG>(A, smem, row0, b, h, bh);
}

template <int D, bool QUANT, int NWG>
__global__ void __launch_bounds__(NWG * 128)
fd_wide_kernel(WideArgs A) {
  wide_split<D, QUANT, NWG, false>(A);
}

// The same over a sliding-window layer's ring (WIN), a kernel of its own
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128)
fd_wide_window_kernel(WideArgs A) {
  wide_split<D, false, NWG, true>(A);
}

// Phase 2 of the wide path with a new block (B1, B3): grid (q tile, 1,
// batch row x head), launched as fd_wide_kernel's programmatic dependent;
// folds the new block on wgmma and the cache partials in (wide_fold) and
// writes the normalised output. The int8 kernel's fold sees
// bf16(q8 * qs), q8 the codes of q' its cache splits used.
template <int D, bool QUANT, int NWG>
__global__ void __launch_bounds__(NWG * 128)
fd_wide_fold_kernel(WideArgs A) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int bh = blockIdx.z;
  wide_fold<D, QUANT, NWG>(A, smem, blockIdx.x * WideSmem<D, NWG>::R, bh / A.c.hkv,
                           bh % A.c.hkv, bh);
}

struct WideMergeArgs {
  const int* k_len;         // [B]
  const float* m_part;
  const float* l_part;
  const float* acc_part;
  float* m_out;             // [B, Hkv, GT]
  float* l_out;             // [B, Hkv, GT]
  float* acc_out;           // [B, Hkv, GT, D]
  int hkv, gt, s, nsplit, nparts;
};

// Phase 2 of the wide path without a new block (B4): a warp per (query
// row, batch row x head), 4 a CTA, launched as fd_wide_kernel's
// programmatic dependent. It weighs the partials of the splits that held a
// key of the row (split_share's arithmetic) by e^(m_s - M) in parallel and
// sums l and each column in split order (the same result on every run),
// and stops there: no fold, no division; (-1e30, 0, 0) when no split is
// live.
template <int D>
__global__ void __launch_bounds__(128)
fd_wide_merge_kernel(WideMergeArgs P) {
  constexpr int V = D / 32;   // columns per lane
  __shared__ float sw[4][WIDE_MAX_SPLITS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + warp;
  const int bh = blockIdx.y, b = bh / P.hkv;
  int per;
  const int klen = split_share(P.k_len[b], P.s, P.nsplit, &per);
  const int live = klen == 0 ? 0 : (klen + per - 1) / per;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (row >= P.gt) return;
  const long long r = (long long)bh * P.gt + row, o = r * P.nparts;
  float M = -INFINITY;
  for (int k = lane; k < live; k += 32) M = fmaxf(M, P.m_part[o + k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.f;
  for (int k = lane; k < live; k += 32) {
    const float w = expf(P.m_part[o + k] - M);   // every live split has a finite m
    sw[warp][k] = w;
    L += P.l_part[o + k] * w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
  __syncwarp();
  float a[V];
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = 0.f;
  for (int k = 0; k < live; ++k) {
    const float w = sw[warp][k];
    const float* src = P.acc_part + (o + k) * D + lane * V;
    if constexpr (V == 4) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      a[0] += x.x * w; a[1] += x.y * w; a[2] += x.z * w; a[3] += x.w * w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(src);
      a[0] += x.x * w; a[1] += x.y * w;
    }
  }
  if (lane == 0) {
    P.m_out[r] = M == -INFINITY ? -1e30f : M;
    P.l_out[r] = L;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) P.acc_out[r * D + lane * V + v] = a[v];
}

// launch kernel (a wide kernel of NWG warpgroups and its shared memory) on
// grid, as a programmatic dependent of the previous launch when pdl
template <int D, int NWG, typename K>
int launch_wide_grid(K kernel, dim3 grid, const WideArgs& wa, bool pdl, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       WideSmem<D, NWG>::BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NWG * 128);
  cfg.dynamicSmemBytes = WideSmem<D, NWG>::BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = pdl && g_pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, wa);
}

// The wide path: fd_wide_kernel, then as its programmatic dependent
// fd_wide_fold_kernel (FOLD: B1, B3) or fd_wide_merge_kernel (B4).
template <int D, bool QUANT, int NWG, bool FOLD, bool WIN = false>
int launch_wide(const WideArgs& wa, const WideMergeArgs& ma, int bh, cudaStream_t st) {
  const int qt = (wa.c.gt + WideSmem<D, NWG>::R - 1) / WideSmem<D, NWG>::R;
  void (*split)(WideArgs) = fd_wide_kernel<D, QUANT, NWG>;
  if constexpr (WIN) split = fd_wide_window_kernel<D, NWG>;
  int err = launch_wide_grid<D, NWG>(split, dim3(qt, wa.c.nsplit, bh), wa, false, st);
  if (err != 0) return err;
  if constexpr (FOLD) {   // one split: phase 1 folded the new block in
    if (wa.c.nsplit == 1) return 0;
    return launch_wide_grid<D, NWG>(fd_wide_fold_kernel<D, QUANT, NWG>, dim3(qt, 1, bh),
                                    wa, true, st);
  }
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((ma.gt + 3) / 4, bh);
  cfg.blockDim = dim3(128);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = g_pdl;
  return (int)cudaLaunchKernelEx(&cfg, fd_wide_merge_kernel<D>, ma);
}

template <int D, bool QUANT, bool WIN = false>
int launch(const WideArgs& wa, const CombineArgs& ca, int bh, cudaStream_t st) {
  if (wa.c.gt <= DECODE_ROWS)
    return launch_decode<D, QUANT, true, WIN>(
        wa.c, ReduceArgs{ca, nullptr, nullptr, nullptr}, bh, st);
  const WideMergeArgs none{};
  return wide_wgs(wa.c.gt) == 1 ? launch_wide<D, QUANT, 1, true, WIN>(wa, none, bh, st)
                                : launch_wide<D, QUANT, 2, true, WIN>(wa, none, bh, st);
}

template <int D, bool QUANT>
int launch_partials(const WideArgs& wa, const ReduceArgs& ra, int bh, cudaStream_t st) {
  if (wa.c.gt <= DECODE_ROWS) return launch_decode<D, QUANT, false>(wa.c, ra, bh, st);
  const CombineArgs& c = ra.c;
  const WideMergeArgs ma{c.k_len, c.m_part, c.l_part, c.acc_part, ra.m_out,
                         ra.l_out, ra.acc_out, c.hkv, c.gt, c.s, c.nsplit, c.nparts};
  return wide_wgs(wa.c.gt) == 1 ? launch_wide<D, QUANT, 1, false>(wa, ma, bh, st)
                                : launch_wide<D, QUANT, 2, false>(wa, ma, bh, st);
}

// Partials per query row phase 1 writes: one per split on both paths (the
// decode kernel merges its warps in the CTA; a wide CTA's warps own rows).
// The wrapper sizes its scratch by tf_flash_decode_parts, so this is the
// only place it is decided.
int n_parts(int /*gt*/, int nsplit) { return nsplit; }

template <typename K>
int occupancy(K kernel, int threads, int smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

// CTAs of the phase-1 kernel a launch at gt uses that one SM holds at once
template <int D, bool QUANT>
int ctas_per_sm(int gt) {
  if (gt <= DECODE_ROWS)
    return occupancy(fd_decode_kernel<D, QUANT>, WARPS * 32, Ring<D, QUANT>::BYTES);
  if (wide_wgs(gt) == 1)
    return occupancy(fd_wide_kernel<D, QUANT, 1>, 128, WideSmem<D, 1>::BYTES);
  return occupancy(fd_wide_kernel<D, QUANT, 2>, 256, WideSmem<D, 2>::BYTES);
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

// nsplit within what phase 2 of the launch's path can weigh
bool splits_ok(int gt, int nsplit) {
  return nsplit > 0 && nsplit <= (gt <= DECODE_ROWS ? MAX_SPLITS : WIDE_MAX_SPLITS);
}

// _sb strides are per batch row (0 and bsz = 1 from the single-row entries)
template <bool QUANT>
int run(int bsz, const void* q, long long q_sb, long long q_sh, long long q_sr,
        const void* k, long long k_sb, long long k_sh, long long k_sr,
        const void* v, long long v_sb, long long v_sh, long long v_sr,
        const void* ks, long long ks_sb, long long ks_sh,
        const void* vs, long long vs_sb, long long vs_sh,
        const void* kn, long long kn_sb, long long kn_sh, long long kn_sr,
        const void* vn, long long vn_sb, long long vn_sh, long long vn_sr,
        long long mask_sb, TF_FD_TAIL_PARAMS, int window = 0, int wtok = 0) {
  if (bsz <= 0 || hkv <= 0 || gt <= 0 || tn <= 0 || !splits_ok(gt, nsplit) ||
      (long long)bsz * hkv > 65535 || (window && (QUANT || window < 2 || wtok <= 0)))
    return (int)cudaErrorInvalidValue;
  const int nparts = n_parts(gt, nsplit);
  WideArgs wa{{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr, k, k_sb, k_sh, k_sr,
               v, v_sb, v_sh, v_sr, (const float*)ks, ks_sb, ks_sh,
               (const float*)vs, vs_sb, vs_sh,
               (const int*)k_len, (float*)m_part, (float*)l_part,
               (float*)acc_part, hkv, gt, s, nsplit, nparts, scale, window, wtok},
              (const __nv_bfloat16*)kn, kn_sb, kn_sh, kn_sr,
              (const __nv_bfloat16*)vn, vn_sb, vn_sh, vn_sr,
              (const uint8_t*)mask, mask_sb, tn, (float*)out};
  CombineArgs ca{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr,
                 (const __nv_bfloat16*)kn, kn_sb, kn_sh, kn_sr,
                 (const __nv_bfloat16*)vn, vn_sb, vn_sh, vn_sr,
                 (const uint8_t*)mask, mask_sb, (const int*)k_len,
                 (const float*)m_part, (const float*)l_part,
                 (const float*)acc_part, (float*)out,
                 hkv, gt, tn, s, nsplit, nparts, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (!QUANT) {
    if (window) {
      if (d == 128) return launch<128, false, true>(wa, ca, bsz * hkv, st);
      if (d == 64) return launch<64, false, true>(wa, ca, bsz * hkv, st);
      return (int)cudaErrorInvalidValue;
    }
  }
  if (d == 128) return launch<128, QUANT>(wa, ca, bsz * hkv, st);
  if (d == 64) return launch<64, QUANT>(wa, ca, bsz * hkv, st);
  return (int)cudaErrorInvalidValue;
}

// Cache-only partials of one row (B = 1): phase 1, then the merge.
template <bool QUANT>
int run_partials(const void* q, long long q_sh, long long q_sr,
                 const void* k, long long k_sh, long long k_sr,
                 const void* v, long long v_sh, long long v_sr,
                 const void* ks, long long ks_sh, const void* vs, long long vs_sh,
                 const void* k_len, void* m_part, void* l_part, void* acc_part,
                 void* m_out, void* l_out, void* acc_out,
                 int hkv, int gt, int s, int d, int nsplit, float scale,
                 void* stream) {
  if (hkv <= 0 || gt <= 0 || hkv > 65535 || !splits_ok(gt, nsplit))
    return (int)cudaErrorInvalidValue;
  const int nparts = n_parts(gt, nsplit);
  WideArgs wa{{(const __nv_bfloat16*)q, 0, q_sh, q_sr, k, 0, k_sh, k_sr,
               v, 0, v_sh, v_sr, (const float*)ks, 0, ks_sh,
               (const float*)vs, 0, vs_sh,
               (const int*)k_len, (float*)m_part, (float*)l_part,
               (float*)acc_part, hkv, gt, s, nsplit, nparts, scale},
              nullptr, 0, 0, 0, nullptr, 0, 0, 0, nullptr, 0, 0, nullptr};
  CombineArgs ca{nullptr, 0, 0, 0, nullptr, 0, 0, 0, nullptr, 0, 0, 0,
                 nullptr, 0, (const int*)k_len, (const float*)m_part,
                 (const float*)l_part, (const float*)acc_part, nullptr,
                 hkv, gt, 0, s, nsplit, nparts, scale};
  ReduceArgs ra{ca, (float*)m_out, (float*)l_out, (float*)acc_out};
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128) return launch_partials<128, QUANT>(wa, ra, hkv, st);
  if (d == 64) return launch_partials<64, QUANT>(wa, ra, hkv, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Programmatic dependent launches on (1, the default) or off (0); returns
// the previous setting. Set it outside a graph capture: a captured graph
// keeps the launches it was captured with.
extern "C" int tf_flash_decode_set_pdl(int on) {
  const int was = g_pdl;
  g_pdl = on != 0;
  return was;
}

extern "C" int tf_flash_decode_parts(int gt, int nsplit) {
  return n_parts(gt, nsplit);
}

// Query rows of one KV head that one phase-1 CTA of a launch at gt takes:
// all gt on the decode path, a q tile of 64 or 128 on the wide path
extern "C" int tf_flash_decode_cta_rows(int gt) {
  return gt <= DECODE_ROWS ? gt : 64 * wide_wgs(gt);
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

// A sliding-window layer's ring (see the top): k/v the ring [Hkv, S, D],
// k_len the sequence length, window and the new tokens wtok (= tn) last
extern "C" int tf_flash_decode_window_bf16(
    const void* q, long long q_sh, long long q_sr,
    const void* k, long long k_sh, long long k_sr,
    const void* v, long long v_sh, long long v_sr,
    const void* kn, long long kn_sh, long long kn_sr,
    const void* vn, long long vn_sh, long long vn_sr,
    const void* mask, const void* k_len,
    void* m_part, void* l_part, void* acc_part, void* out,
    int hkv, int gt, int tn, int s, int d, int nsplit, float scale,
    int window, int wtok, void* stream) {
  return run<false>(1, q, 0, q_sh, q_sr, k, 0, k_sh, k_sr, v, 0, v_sh, v_sr,
                    nullptr, 0, 0, nullptr, 0, 0, kn, 0, kn_sh, kn_sr,
                    vn, 0, vn_sh, vn_sr, 0, TF_FD_TAIL_ARGS, window, wtok);
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
