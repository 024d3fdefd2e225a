// Paged decode attention for Hopper (sm_90a): one query token a row over
// its paged context and its tail, the query heads of a KV head together.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA. It is
// the masked, fixed-shape token step's attention (models/kv_paging.py
// paged_token_step), which in plain PyTorch rewrote the whole tail to set
// one slot, concatenated the paged context with the tail, cast both to
// float32 and broadcast K/V over the query heads of each KV head: some
// twenty launches a layer and several float32 copies of K/V a token.
//
// Bound: the bytes of the valid keys. Row b's query heads of KV head h read
// each of its valid keys once, K and V, in the stored type; the arithmetic
// (2 * G * D multiply-adds a key, G query heads a KV head) is far below the
// card's rate at a few operations a byte. The least time is
// 2 * valid keys * D * itemsize summed over rows and KV heads, over the
// card's memory rate (3.35 TB/s on an H100 SXM).
//
// Design (flash-decoding):
// - A CTA of four warps takes one (row, KV head, split): the split's share
//   of the row's valid keys, counted in the order context then tail, so a
//   masked key is never read and a context padded past ctx_len costs
//   nothing. The splits divide the valid keys evenly on the device; their
//   number comes from the shapes and the card alone (the wrapper,
//   ops/attn.py), so the launch does not depend on meta's values and a CUDA
//   graph replays it.
// - A key is read by D / VEC lanes, 16 bytes a lane, so a warp's load is
//   32 * 16 contiguous bytes; a warp issues the K and V loads of at least
//   8 keys before it uses any, to keep bytes in flight. Every lane holds the G
//   query heads' elements of its slice, so a key is read once for all G.
// - Scores are float32: the dot product of the stored values accumulated
//   in float32, times 1/sqrt(D); the softmax runs in float32 (exp by the
//   __expf intrinsic, within a few ulps of the library's) with a running
//   max and sum a (lane group, head), and the unnormalised weights
//   multiply V in float32. The lane groups, then the warps, then (with
//   more than one split) the splits are merged as (max, sum, acc) triples;
//   the output is divided and rounded to the query's type once. This is
//   grouped_attention's arithmetic up to the order of the sums.
// - Split 0 writes the row's new K/V (kn, vn) into its tail slot
//   tail_len; every CTA reads that key from kn/vn and no CTA reads the
//   slot, so the write races with no read.
// - The splits are as many as keep the CTAs within two waves of what the
//   card holds at once (the wrapper asks ocm_attn_decode_occupancy): one
//   wave of 256 pairs at 3 CTAs a SM leaves a third of the slots idle,
//   and a third wave begun for a few CTAs costs as much as a full one.
// - With one split the CTA writes the output; with more, each writes its
//   triple to scratch and attn_decode_combine_kernel (one CTA a row and KV
//   head, one thread an output element) merges them.
//
// Instantiated for float32, bfloat16 and float16, head sizes 16, 64 and
// 128, and 2 or 4 query heads a KV head: the port's configurations (the
// test and demo model, the small and training-sized Llamas, Llama-3-8B,
// Mistral-7B, Mixtral-8x7B). ops/attn.py refuses anything else on the card.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream (PyTorch's current stream), does not synchronise, allocates
// nothing (the wrapper passes the scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerRound = 8;  // least keys a warp loads before it uses one

// 16 bytes of T as floats, and a float rounded to T.
template <typename T> struct Elt;

template <> struct Elt<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float from(float x) { return x; }
};

template <> struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const uint4& u, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static __nv_bfloat16 from(float x) { return __float2bfloat16_rn(x); }
};

template <> struct Elt<__half> {
  static constexpr int kVec = 8;
  __device__ static void load(const uint4& u, float* f) {
    const __half2* p = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static __half from(float x) { return __float2half_rn(x); }
};

// The factor that moves a sum taken under max m to max m_new (>= m); an
// empty sum (m = -inf) contributes nothing, even when m_new is -inf too.
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : __expf(m - m_new);
}

struct Args {
  const void* q;         // (B, KV * G, D)
  const void* kn;        // (B, KV, D) the new key, after rope
  const void* vn;        // (B, KV, D)
  const void* kc;        // context: element (b, h, c, :) at b*sb + h*sh + c*sc
  const void* vc;
  long long k_sb, k_sh, k_sc, v_sb, v_sh, v_sc;
  void* tk;              // (B, KV, P, D) tails, slot tail_len written
  void* tv;
  const long long* meta; // (B, 4) [pos, tail_len, ctx_len, ctx_start]
  void* out;             // (B, KV * G, D)
  float* acc;            // (B * KV, S, G, D) scratch, with S > 1
  float* ml;             // (B * KV, S, G, 2) scratch: max, sum
  int KV, C, P, S;
  long long window;      // <= 0: no sliding window
  float scale;
};

// The valid keys of one row, in the order context then tail: context keys
// [lo_c, ctx_len), then tail slots [lo_t, tail_len].
struct Keys {
  long long lo_c, lo_t, tail_len;
  int n_ctx, n;
};

__device__ __forceinline__ Keys valid_keys(const Args& a, int b) {
  const long long* m = a.meta + 4 * b;
  const long long pos = m[0];
  const long long tail_len = min(max(m[1], 0LL), (long long)a.P - 1);
  const long long ctx_len = min(max(m[2], 0LL), (long long)a.C);
  long long lo_c = 0, lo_t = 0;
  if (a.window > 0) {
    lo_c = min(max(pos - a.window + 1 - m[3], 0LL), ctx_len);
    lo_t = max(tail_len - a.window + 1, 0LL);
  }
  Keys k;
  k.lo_c = lo_c;
  k.lo_t = lo_t;
  k.tail_len = tail_len;
  k.n_ctx = (int)(ctx_len - lo_c);
  k.n = k.n_ctx + (int)(tail_len - lo_t + 1);
  return k;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
attn_decode_kernel(const Args a) {
  using E = Elt<T>;
  constexpr int VEC = E::kVec;
  constexpr int LPK = D / VEC;  // lanes a key
  static_assert(LPK <= 32 && 32 % LPK == 0, "a key must fill whole lanes");
  constexpr int KPW = 32 / LPK;  // keys a warp-wide load
  constexpr int U = KPW >= kKeysPerRound ? 1 : kKeysPerRound / KPW;
  constexpr int KPR = U * KPW;  // keys a round

  __shared__ float sm_acc[kWarps][G][D];
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, part = lane % LPK;
  const long long pair = (long long)b * a.KV + h;

  const Keys k = valid_keys(a, b);
  const int lo = (int)((long long)k.n * s / a.S);
  const int hi = (int)((long long)k.n * (s + 1) / a.S);

  const T* kn = static_cast<const T*>(a.kn) + pair * D;
  const T* vn = static_cast<const T*>(a.vn) + pair * D;
  T* tk = static_cast<T*>(a.tk) + pair * a.P * D;
  T* tv = static_cast<T*>(a.tv) + pair * a.P * D;
  if (s == 0) {
    for (int e = threadIdx.x; e < D; e += kThreads) {
      tk[k.tail_len * D + e] = kn[e];
      tv[k.tail_len * D + e] = vn[e];
    }
  }

  float qf[G][VEC];
  const T* q = static_cast<const T*>(a.q) + pair * G * D + part * VEC;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    E::load(*reinterpret_cast<const uint4*>(q + g * D), qf[g]);
  }

  float mx[G], sum[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = -INFINITY;
    sum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const T* kc = static_cast<const T*>(a.kc) + b * a.k_sb + h * a.k_sh + part * VEC;
  const T* vc = static_cast<const T*>(a.vc) + b * a.v_sb + h * a.v_sh + part * VEC;
  // A warp takes rounds of KPR consecutive keys, the warps of the CTA
  // interleaved; base is the same on every lane of a warp, so the shuffles
  // below see the whole warp.
  for (int base = lo + warp * KPR; base < hi; base += kWarps * KPR) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * KPW + sub;
      ok[u] = j < hi;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (!ok[u]) continue;
      if (j < k.n_ctx) {
        const long long c = k.lo_c + j;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kc + c * a.k_sc));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vc + c * a.v_sc));
      } else {
        const long long t = k.lo_t + (j - k.n_ctx);
        const T* kp = t == k.tail_len ? kn : tk + t * D;
        const T* vp = t == k.tail_len ? vn : tv + t * D;
        kr[u] = *reinterpret_cast<const uint4*>(kp + part * VEC);
        vr[u] = *reinterpret_cast<const uint4*>(vp + part * VEC);
      }
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      E::load(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qf[g][e], kf[e], d);
        sc[u][g] = d;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off /= 2) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
        }
      }
    }
    float p[U][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = mx[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][g] *= a.scale;
        if (ok[u]) m_new = fmaxf(m_new, sc[u][g]);
      }
      const float corr = rescale(mx[g], m_new);
      sum[g] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][g] = ok[u] ? __expf(sc[u][g] - m_new) : 0.f;
        sum[g] += p[u][g];
      }
      mx[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      E::load(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p[u][g], vf[e], acc[g][e]);
      }
    }
  }

  // Merge the warp's lane groups (lanes part, part + LPK, ...).
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[g], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, sum[g], off);
      const float m_new = fmaxf(mx[g], m2);
      const float c1 = rescale(mx[g], m_new), c2 = rescale(m2, m_new);
      sum[g] = sum[g] * c1 + s2 * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * c1 + a2 * c2;
      }
      mx[g] = m_new;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][part * VEC + e] = acc[g][e];
      if (part == 0) {
        sm_m[warp][g] = mx[g];
        sm_l[warp][g] = sum[g];
      }
    }
  }
  __syncthreads();

  // Merge the warps: one thread an output element.
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm_m[w][g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(sm_m[w][g], m);
      l += sm_l[w][g] * c;
      o += sm_acc[w][g][d] * c;
    }
    if (a.S == 1) {
      static_cast<T*>(a.out)[(pair * G + g) * D + d] = E::from(o / l);
    } else {
      const long long at = (pair * a.S + s) * G + g;
      a.acc[at * D + d] = o;
      if (d == 0) {
        a.ml[2 * at] = m;
        a.ml[2 * at + 1] = l;
      }
    }
  }
}

// Merges the S splits of one (row, KV head): one thread an output element
// (g, d) of its G * D.
template <typename T>
__global__ void attn_decode_combine_kernel(const float* acc, const float* ml,
                                           void* out, int S, int G, int D) {
  const long long pair = blockIdx.x;
  const int g = threadIdx.x / D, d = threadIdx.x % D;
  const float* m = ml + pair * S * G * 2;
  float mmax = -INFINITY;
  for (int s = 0; s < S; ++s) mmax = fmaxf(mmax, m[2 * (s * G + g)]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < S; ++s) {
    const float c = rescale(m[2 * (s * G + g)], mmax);
    l += m[2 * (s * G + g) + 1] * c;
    o += acc[((pair * S + s) * G + g) * D + d] * c;
  }
  static_cast<T*>(out)[(pair * G + g) * D + d] = Elt<T>::from(o / l);
}

// The launch of one instantiation, or with `blocks` set, no launch: the
// CTAs of attn_decode_kernel that one SM holds at once, into *blocks.
template <typename T, int D, int G>
int launch(const Args& a, int B, cudaStream_t stream, int* blocks) {
  if (blocks != nullptr) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, attn_decode_kernel<T, D, G>, kThreads, 0);
  }
  attn_decode_kernel<T, D, G><<<dim3(a.S, a.KV, B), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return (int)err;
  attn_decode_combine_kernel<T><<<B * a.KV, G * D, 0, stream>>>(
      a.acc, a.ml, a.out, a.S, G, D);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const Args& a, int B, int G, cudaStream_t stream, int* blocks) {
  switch (G) {
    case 2: return launch<T, D, 2>(a, B, stream, blocks);
    case 4: return launch<T, D, 4>(a, B, stream, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_d(const Args& a, int B, int D, int G, cudaStream_t stream,
             int* blocks) {
  switch (D) {
    case 16: return launch_g<T, 16>(a, B, G, stream, blocks);
    case 64: return launch_g<T, 64>(a, B, G, stream, blocks);
    case 128: return launch_g<T, 128>(a, B, G, stream, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_t(int dtype, const Args& a, int B, int D, int G,
             cudaStream_t stream, int* blocks) {
  switch (dtype) {
    case 0: return launch_d<float>(a, B, D, G, stream, blocks);
    case 1: return launch_d<__nv_bfloat16>(a, B, D, G, stream, blocks);
    case 2: return launch_d<__half>(a, B, D, G, stream, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Context strides in elements;
// every other tensor is contiguous. window <= 0: none. With S > 1, acc and
// ml are the scratch of (B * KV * S * G) x D and x 2 floats.
int ocm_attn_decode(int device, int dtype, int B, int KV, int G, int D, int C,
                    int P, int S, const void* q, const void* kn, const void* vn,
                    const void* kc, long long k_sb, long long k_sh,
                    long long k_sc, const void* vc, long long v_sb,
                    long long v_sh, long long v_sc, void* tk, void* tv,
                    const void* meta, long long window, float scale, void* out,
                    void* acc, void* ml, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || KV < 1 || C < 0 || P < 1 || S < 1 || B > 65535 || KV > 65535 ||
      S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.kn = kn;
  a.vn = vn;
  a.kc = kc;
  a.vc = vc;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.k_sc = k_sc;
  a.v_sb = v_sb;
  a.v_sh = v_sh;
  a.v_sc = v_sc;
  a.tk = tk;
  a.tv = tv;
  a.meta = static_cast<const long long*>(meta);
  a.out = out;
  a.acc = static_cast<float*>(acc);
  a.ml = static_cast<float*>(ml);
  a.KV = KV;
  a.C = C;
  a.P = P;
  a.S = S;
  a.window = window;
  a.scale = scale;
  return launch_t(dtype, a, B, D, G, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The CTAs of the (dtype, D, G) kernel that one SM of `device` holds at
// once, into *blocks: the wrapper sizes the splits by it.
int ocm_attn_decode_occupancy(int device, int dtype, int D, int G,
                              int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_t(dtype, Args{}, 1, D, G, nullptr, blocks);
}

const char* ocm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
