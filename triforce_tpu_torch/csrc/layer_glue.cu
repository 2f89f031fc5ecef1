// The non-GEMM glue of a decoder layer (``models/llama.py``) as three
// kernels: residual add + RMSNorm, RoPE on q and k in one launch, and
// SiLU(gate) * up.
//
// They replace no TPU kernel: the JAX package leaves this glue to XLA,
// which fuses it into the surrounding ops. In eager PyTorch, and in a CUDA
// graph captured from it, each elementwise op of the chain is a launch of
// its own (~35 a layer, ~2-3 us each whatever their size), on rows of a
// few KB. Every one of these is far below the card's ridge point (a few
// operations per byte), so what bounds them is launches and bytes: each
// kernel reads its inputs once, keeps the chain's intermediates in
// registers, and writes its outputs once, in 16-byte packs (the wrapper
// refuses shapes, strides and addresses that are not whole packs). At the
// decode widths a launch holds a few CTAs and its time is its latency,
// so every load of a thread is in flight before the first is used.
//
// Each keeps the rounding of the PyTorch chain it replaces (the plain
// versions in ``ops/layer_glue.py``): every elementwise step is an fp32
// operation on the operands' values rounded back to the tensor's type
// (bf16 or fp32), with ``__f*_rn`` intrinsics so that no two steps
// contract into an FMA. So RoPE and SiLU * up give the chain's bits; the
// RMSNorm's mean of squares is summed in another order than PyTorch's
// reduction, and may move the normalised value by one ulp of its type.
//
//   tf_add_rms_norm: one CTA a row of ``hidden`` values (at most 16384),
//     held in registers between the sum and the scaling. With y:
//     xo = T(x + y); without: xo is x (not written). Then, with
//     var = fp32 sum(xo^2) * (1 / hidden) and r = rsqrtf(var + eps),
//     h = T(w * T(xo * r)).
//   tf_rope: one thread a run of pairs (j, j + D/2) of a (token, head) of
//     up to two tensors [B, H, T, D] (any B/H/T strides, unit D stride);
//     positions [T] (row stride 0) or [B, T] index fp32 cos/sin tables
//     [S, D] rows, cast to T; out[j] = T(T(x_j c_j) + T(-x_{j+D/2} s_j)),
//     out[j+D/2] = T(T(x_{j+D/2} c_{j+D/2}) + T(x_j s_{j+D/2})). Outputs
//     contiguous. A position outside [0, S) stops the kernel (a device
//     trap, as PyTorch's gather stops at an index out of range).
//   tf_silu_mul: out = T(T(g / (1 + expf(-g))) * u), elementwise.
//
// Every size comes from the wrapper (rows, hidden, heads, T, D), so one
// binary serves every model width, head count and token count. Each entry
// point launches on the given stream, allocates nothing and returns the
// launch's cudaError_t. dtype codes: 0 fp32, 1 bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxNormThreads = 1024;
constexpr int kThreads = 256;

template <typename T>
struct Num;

template <>
struct Num<float> {
    static __device__ __forceinline__ float load(float v) { return v; }
    static __device__ __forceinline__ float round(float v) { return v; }
    static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
    static __device__ __forceinline__ float load(__nv_bfloat16 v) {
        return __bfloat162float(v);
    }
    static __device__ __forceinline__ float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
    static __device__ __forceinline__ __nv_bfloat16 store(float v) {
        return __float2bfloat16_rn(v);
    }
};

// kVec elements moved by one load or store: 16 bytes
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
    T v[kVec];
};

template <typename T>
constexpr int full_vec() { return 16 / sizeof(T); }

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// kPer packs of kVec values a thread, all loaded before the first is used
template <typename T, bool kAdd, int kVec, int kPer>
__global__ void __launch_bounds__(kMaxNormThreads)
add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ w, T* __restrict__ xo,
                    T* __restrict__ h, int hidden, float inv_hidden,
                    float eps) {
    using N = Num<T>;
    using P = Pack<T, kVec>;
    const long long base = (long long)blockIdx.x * hidden;
    const int nt = blockDim.x, npack = hidden / kVec;
    const P* xp = reinterpret_cast<const P*>(x + base);
    const P* yp = kAdd ? reinterpret_cast<const P*>(y + base) : nullptr;
    const P* wp = reinterpret_cast<const P*>(w);
    float v[kPer][kVec];
    P g[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int i = threadIdx.x + k * nt;
        P a{}, b{};
        g[k] = P{};
        if (i < npack) {
            a = xp[i];
            if (kAdd) b = yp[i];
            g[k] = wp[i];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
            v[k][e] = N::load(a.v[e]);
            if (kAdd)
                v[k][e] = N::round(__fadd_rn(v[k][e], N::load(b.v[e])));
        }
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        P s;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
            acc = __fadd_rn(acc, __fmul_rn(v[k][e], v[k][e]));
            s.v[e] = N::store(v[k][e]);
        }
        const int i = threadIdx.x + k * nt;
        if (kAdd && i < npack) reinterpret_cast<P*>(xo + base)[i] = s;
    }
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    __shared__ float part[32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < (nt >> 5) ? part[lane] : 0.f;
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) part[0] = acc;
    }
    __syncthreads();
    const float r = rsqrtf(__fadd_rn(__fmul_rn(part[0], inv_hidden), eps));
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int i = threadIdx.x + k * nt;
        if (i >= npack) continue;
        P o;
#pragma unroll
        for (int e = 0; e < kVec; ++e)
            o.v[e] = N::store(__fmul_rn(N::load(g[k].v[e]),
                                        N::round(__fmul_rn(v[k][e], r))));
        reinterpret_cast<P*>(h + base)[i] = o;
    }
}

struct RopeTensor {
    const void* x;
    void* out;
    long long sb, sh, st;   // element strides of x's B, H and T axes
    int heads;
};

// kVec table values from p, in 16-byte reads
template <int kVec>
__device__ __forceinline__ void load_row(const float* p, float (&o)[kVec]) {
    static_assert(kVec % 4 == 0, "table rows are read as float4");
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(p)[q];
        o[4 * q] = f.x;
        o[4 * q + 1] = f.y;
        o[4 * q + 2] = f.z;
        o[4 * q + 3] = f.w;
    }
}

// one thread a run of kVec pairs (j .. j + kVec and the same + D/2); the
// launcher keeps every run index within 32 bits
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
rope_kernel(RopeTensor a, RopeTensor b, int runs_a, int runs_all,
            const long long* __restrict__ pos, long long pos_sb,
            const float* __restrict__ cos, const float* __restrict__ sin,
            long long table_rows, int T_len, int D) {
    using N = Num<T>;
    using P = Pack<T, kVec>;
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= runs_all) return;
    const bool second = i >= runs_a;
    const RopeTensor& t = second ? b : a;
    if (second) i -= runs_a;
    const int half = D >> 1, runs = half / kVec;
    const int j = (i % runs) * kVec;
    const int r = i / runs;                  // ((bb * heads) + hh) * T + tt
    const int tt = r % T_len, bh = r / T_len;
    const int hh = bh % t.heads, bb = bh / t.heads;
    const long long p = pos[bb * pos_sb + tt];
    if (p < 0 || p >= table_rows) __trap();
    float c1[kVec], s1[kVec], c2[kVec], s2[kVec];
    load_row<kVec>(cos + p * D + j, c1);
    load_row<kVec>(sin + p * D + j, s1);
    load_row<kVec>(cos + p * D + j + half, c2);
    load_row<kVec>(sin + p * D + j + half, s2);
    const T* x = static_cast<const T*>(t.x) + bb * t.sb + hh * t.sh
        + tt * t.st + j;
    T* out = static_cast<T*>(t.out) + (long long)r * D + j;
    const P lo = *reinterpret_cast<const P*>(x);
    const P hi = *reinterpret_cast<const P*>(x + half);
    P olo, ohi;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
        const float x1 = N::load(lo.v[e]), x2 = N::load(hi.v[e]);
        olo.v[e] = N::store(__fadd_rn(N::round(__fmul_rn(x1, N::round(c1[e]))),
                                      N::round(__fmul_rn(-x2,
                                                         N::round(s1[e])))));
        ohi.v[e] = N::store(__fadd_rn(N::round(__fmul_rn(x2, N::round(c2[e]))),
                                      N::round(__fmul_rn(x1,
                                                         N::round(s2[e])))));
    }
    *reinterpret_cast<P*>(out) = olo;
    *reinterpret_cast<P*>(out + half) = ohi;
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
silu_mul_kernel(const T* __restrict__ g, const T* __restrict__ u,
                T* __restrict__ out, long long npack) {
    using N = Num<T>;
    using P = Pack<T, kVec>;
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= npack) return;
    const P gp = reinterpret_cast<const P*>(g)[i];
    const P up = reinterpret_cast<const P*>(u)[i];
    P o;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
        const float gv = N::load(gp.v[e]);
        const float a = N::round(__fdiv_rn(gv, __fadd_rn(1.f, expf(-gv))));
        o.v[e] = N::store(__fmul_rn(a, N::load(up.v[e])));
    }
    reinterpret_cast<P*>(out)[i] = o;
}

template <typename T, bool kAdd, int kVec>
cudaError_t launch_norm_packed(const void* x, const void* y, const void* w,
                               void* xo, void* h, int rows, int hidden,
                               float inv_hidden, float eps, cudaStream_t st) {
    // the fewest packs a thread that keep a row within one CTA; at most 16
    // values a thread (a row of 16384)
    constexpr int kMaxPer = 16 / kVec;
    const int npack = hidden / kVec;
    int per = 1;
    while (per < kMaxPer && npack > kMaxNormThreads * per) per *= 2;
    const int threads = ((npack + per - 1) / per + 31) / 32 * 32;
    if (threads > kMaxNormThreads) return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const T* yt = static_cast<const T*>(y);
    const T* wt = static_cast<const T*>(w);
    T* xot = static_cast<T*>(xo);
    T* ht = static_cast<T*>(h);
#define TF_NORM(PER)                                                       \
    add_rms_norm_kernel<T, kAdd, kVec, PER><<<rows, threads, 0, st>>>(     \
        xt, yt, wt, xot, ht, hidden, inv_hidden, eps)
    if (per == 1) TF_NORM(1);
    if constexpr (kMaxPer >= 2) if (per == 2) TF_NORM(2);
    if constexpr (kMaxPer >= 4) if (per == 4) TF_NORM(4);
#undef TF_NORM
    return cudaGetLastError();
}

// every operand a whole number of 16-byte packs, or cudaErrorInvalidValue
template <typename T, bool kAdd>
cudaError_t launch_norm_as(const void* x, const void* y, const void* w,
                           void* xo, void* h, int rows, int hidden,
                           float inv_hidden, float eps, cudaStream_t st) {
    constexpr int V = full_vec<T>();
    if (hidden % V || !aligned16(x) || !aligned16(w) || !aligned16(h)
            || (kAdd && (!aligned16(y) || !aligned16(xo))))
        return cudaErrorInvalidValue;
    return launch_norm_packed<T, kAdd, V>(x, y, w, xo, h, rows, hidden,
                                          inv_hidden, eps, st);
}

template <typename T>
cudaError_t launch_norm(const void* x, const void* y, const void* w,
                        void* xo, void* h, int rows, int hidden,
                        float inv_hidden, float eps, cudaStream_t st) {
    if (y != nullptr)
        return launch_norm_as<T, true>(x, y, w, xo, h, rows, hidden,
                                       inv_hidden, eps, st);
    return launch_norm_as<T, false>(x, y, w, xo, h, rows, hidden,
                                    inv_hidden, eps, st);
}

template <typename T, int kVec>
cudaError_t launch_rope_packed(const RopeTensor& a, const RopeTensor& b,
                               int B, int T_len, int D, const long long* pos,
                               long long pos_sb, const float* cos,
                               const float* sin, long long table_rows,
                               cudaStream_t st) {
    const long long per_head = (long long)T_len * (D / 2 / kVec);
    const long long runs_a = (long long)B * a.heads * per_head;
    const long long runs_all = runs_a + (long long)B * b.heads * per_head;
    if (runs_all >= (1LL << 31) - kThreads) return cudaErrorInvalidValue;
    const int blocks = (int)((runs_all + kThreads - 1) / kThreads);
    rope_kernel<T, kVec><<<blocks, kThreads, 0, st>>>(
        a, b, (int)runs_a, (int)runs_all, pos, pos_sb, cos, sin, table_rows,
        T_len, D);
    return cudaGetLastError();
}

// a tensor (or an absent second one) whose runs of V pairs are 16-byte
// packs
template <typename T>
bool rope_packs(const RopeTensor& t) {
    constexpr int V = full_vec<T>();
    return t.heads == 0 || (aligned16(t.x) && aligned16(t.out)
                            && t.sb % V == 0 && t.sh % V == 0
                            && t.st % V == 0);
}

template <typename T>
cudaError_t launch_rope(const RopeTensor& a, const RopeTensor& b, int B,
                        int T_len, int D, const long long* pos,
                        long long pos_sb, const float* cos, const float* sin,
                        long long table_rows, cudaStream_t st) {
    constexpr int V = full_vec<T>();
    if ((D / 2) % V || !rope_packs<T>(a) || !rope_packs<T>(b)
            || !aligned16(cos) || !aligned16(sin))
        return cudaErrorInvalidValue;
    return launch_rope_packed<T, V>(a, b, B, T_len, D, pos, pos_sb, cos, sin,
                                    table_rows, st);
}

template <typename T>
cudaError_t launch_silu(const void* g, const void* u, void* out,
                        long long n, cudaStream_t st) {
    constexpr int V = full_vec<T>();
    const T* gt = static_cast<const T*>(g);
    const T* ut = static_cast<const T*>(u);
    T* ot = static_cast<T*>(out);
    if (n % V || !aligned16(g) || !aligned16(u) || !aligned16(out))
        return cudaErrorInvalidValue;
    const long long blocks = (n / V + kThreads - 1) / kThreads;
    silu_mul_kernel<T, V><<<(unsigned)blocks, kThreads, 0, st>>>(gt, ut, ot,
                                                                n / V);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (or null), w, xo (unused without y), h; rows x hidden, contiguous
int tf_add_rms_norm(const void* x, const void* y, const void* w, void* xo,
                    void* h, int rows, int hidden, float inv_hidden,
                    float eps, int dtype, void* stream) {
    if (rows <= 0) return cudaSuccess;
    auto st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_norm<float>(x, y, w, xo, h, rows, hidden,
                                          inv_hidden, eps, st);
        case 1: return launch_norm<__nv_bfloat16>(x, y, w, xo, h, rows,
                                                  hidden, inv_hidden, eps,
                                                  st);
        default: return cudaErrorInvalidValue;
    }
}

// two tensors (heads1 = 0: the first alone), each x, out, then the B, H
// and T strides of x and its head count; positions, their row stride (0:
// one [T] row for every b), the tables and their rows; B, T, D
int tf_rope(const void* x0, void* out0, long long sb0, long long sh0,
            long long st0, int heads0, const void* x1, void* out1,
            long long sb1, long long sh1, long long st1, int heads1,
            const long long* pos, long long pos_sb, const float* cos,
            const float* sin, long long table_rows, int B, int T_len, int D,
            int dtype, void* stream) {
    if (D % 2 || D <= 0 || table_rows <= 0) return cudaErrorInvalidValue;
    if (B <= 0 || T_len <= 0) return cudaSuccess;
    const RopeTensor a{x0, out0, sb0, sh0, st0, heads0};
    const RopeTensor b{x1, out1, sb1, sh1, st1, heads1};
    auto st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_rope<float>(a, b, B, T_len, D, pos, pos_sb,
                                          cos, sin, table_rows, st);
        case 1: return launch_rope<__nv_bfloat16>(a, b, B, T_len, D, pos,
                                                  pos_sb, cos, sin,
                                                  table_rows, st);
        default: return cudaErrorInvalidValue;
    }
}

// gate, up, out: n contiguous elements each
int tf_silu_mul(const void* g, const void* u, void* out, long long n,
                int dtype, void* stream) {
    if (n <= 0) return cudaSuccess;
    auto st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_silu<float>(g, u, out, n, st);
        case 1: return launch_silu<__nv_bfloat16>(g, u, out, n, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // extern "C"
