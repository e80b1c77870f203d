// Fused optimizer updates for Hopper (sm_90a): the multi-tensor chunk
// kernel and LAMB's two per-tensor phases, CUDA C++ with plain C entries.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas/fused_optimizer.py:
//   chunk    `_elementwise_chunk_kernel` (:159), launched by
//            `_run_elementwise_chunk` (:220);
//   LAMB A   `_lamb_phase_a_kernel` (:239), launched by `_run_lamb_leaf`
//            (:307);
//   LAMB B   `_lamb_phase_b_kernel` (:273), launched by `_run_lamb_leaf`
//            (:333).
//
// What they compute, in f32 whatever the stored types (the f32
// hyperparameters promote a bf16 leaf, as in JAX), updating weights and
// optimizer state IN PLACE:
//   g = clip(g * rescale_grad, +-clip_gradient)      (clip when given)
//   Adam   g += wd*w; m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g;
//          w -= lr*sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)
//   AdamW  m, v as Adam without wd; lr_t = lr (bias-corrected when
//          correct_bias); w = w - lr_t*m/(sqrt(v)+eps) - lr*wd*w
//   SGD    g += wd*w; w -= lr*g, or with momentum mom = mu*mom - lr*g;
//          w += mom
//   LAMB A m, v as Adam without wd; r = mhat/(sqrt(vhat)+eps) + wd*w
//          (mhat, vhat bias-corrected when asked), r written in f32, plus
//          per-block partial sums of w^2 and r^2; the last block to finish
//          reduces the partials in a fixed order and writes the trust ratio
//          ||w|| / ||r|| (||w|| clipped to [lower, upper]; 1 where a norm
//          is 0)
//   LAMB B w -= lr * ratio * r
// with the order of operations of the rules in mxnet_tpu/optimizer (adam.py,
// sgd.py, lamb.py).  The decay of a stored state (b1*m, b2*v, mu*mom) is a
// Python float times the state in those rules, a weakly typed scalar that
// JAX rounds to the state's type before the product, which rounds to it
// too: a no-op for f32 state, rnd(rnd(b1) * m) for bf16 state.  lr, wd,
// rescale_grad, t, clip_gradient and the skip flag are read from device
// memory — no host sync per step.  With skip
// set, every weight and state element is written back as the bits it was
// read as (a select, so a NaN gradient never reaches an output).
//
// What bounds them on the H100: bytes at 3.35 TB/s — Adam reads w, g, m, v
// and writes w, m, v (28 B an f32 element, 22 B a bf16 one); LAMB moves 40
// B an f32 element over its two phases (r goes out and back).  Design,
// simple first: the chunk kernel is the CUDA form of the TPU's packed
// chunk without the packing — one launch per dtype group over a device
// table of per-leaf pointers and sizes, and a block map that gives each
// block one CHUNK-element range of one leaf, so no torch.cat copy exists.
// Each thread issues the loads of ILP elements before it computes.  LAMB's
// norms are reduced without float atomics: an integer ticket picks the last
// block of phase A, which sums the per-block partials in index order (the
// result does not depend on which block finished last).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}
// x rounded to S and widened back (identity for f32)
template <typename S> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<S>(x));
}

// Device-resident hyperparameters (f32 scalars; clip and skip may be null).
struct Hyper {
  const float *lr, *wd, *rg, *t, *clip;
  const unsigned char* skip;  // a torch.bool
};
// Host constants of the rule.
struct Consts {
  float b1, b2, eps, omb1, omb2, momentum;  // omb = 1 - b, rounded once
  int flag;  // Adam family: correct_bias; LAMB: bias_correction
};

struct HP {
  float lr, wd, rg, clip;
  bool has_clip, skip;
};

__device__ __forceinline__ HP read_hp(const Hyper& h) {
  HP p;
  p.lr = *h.lr;
  p.wd = *h.wd;
  p.rg = *h.rg;
  p.has_clip = h.clip != nullptr;
  p.clip = p.has_clip ? *h.clip : 0.f;
  p.skip = h.skip != nullptr && *h.skip != 0;
  return p;
}

// rescale, then clip (NaN passes through, as jnp.clip and torch.clamp)
__device__ __forceinline__ float pre(float g, const HP& p) {
  g = g * p.rg;
  if (p.has_clip) g = g < -p.clip ? -p.clip : (g > p.clip ? p.clip : g);
  return g;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();
  return t;
}

enum Rule { ADAM = 0, ADAMW = 1, SGD = 2, SGD_MOM = 3 };

// ---------------------------------------------------------------------------
// the multi-tensor chunk kernel
// ---------------------------------------------------------------------------

// leaves: n_leaves x {w, g, s0, s1, n} (pointers as int64; s0/s1 0 when the
// rule keeps less state); blocks: per block (leaf << 32) | chunk index.
template <typename W, typename S>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const long long* __restrict__ leaves,
             const long long* __restrict__ blocks, int chunk, int rule,
             Consts c, Hyper hy) {
  const long long code = blocks[blockIdx.x];
  const long long* L = leaves + 5 * (code >> 32);
  W* __restrict__ w = reinterpret_cast<W*>(L[0]);
  const W* __restrict__ g = reinterpret_cast<const W*>(L[1]);
  S* __restrict__ s0 = reinterpret_cast<S*>(L[2]);
  S* __restrict__ s1 = reinterpret_cast<S*>(L[3]);
  const long long start = (code & 0xffffffffLL) * chunk;
  const long long end = min(L[4], start + chunk);
  const HP p = read_hp(hy);
  float lr_t = p.lr;
  if (rule == ADAM || (rule == ADAMW && c.flag)) {
    const float t = *hy.t;
    lr_t = p.lr * sqrtf(1.f - powf(c.b2, t)) / (1.f - powf(c.b1, t));
  }
  const float b1s = rnd<S>(c.b1), b2s = rnd<S>(c.b2),
              mus = rnd<S>(c.momentum);
  const S zero = from_f<S>(0.f);
  for (long long i0 = start + threadIdx.x; i0 < end;
       i0 += (long long)ILP * THREADS) {
    W wr[ILP], gr[ILP];
    S mr[ILP], vr[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = i0 + (long long)k * THREADS;
      mr[k] = vr[k] = zero;
      if (i < end) {
        wr[k] = w[i];
        gr[k] = g[i];
        if (s0) mr[k] = s0[i];
        if (s1) vr[k] = s1[i];
      }
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = i0 + (long long)k * THREADS;
      if (i >= end) continue;
      const float wf = to_f(wr[k]);
      float gf = pre(to_f(gr[k]), p);
      float m = to_f(mr[k]), v = to_f(vr[k]), nw;
      switch (rule) {
        case ADAM:
          gf = gf + p.wd * wf;
          m = rnd<S>(b1s * m) + c.omb1 * gf;
          v = rnd<S>(b2s * v) + c.omb2 * gf * gf;
          nw = wf - lr_t * m / (sqrtf(v) + c.eps);
          break;
        case ADAMW:
          m = rnd<S>(b1s * m) + c.omb1 * gf;
          v = rnd<S>(b2s * v) + c.omb2 * gf * gf;
          nw = wf - lr_t * m / (sqrtf(v) + c.eps) - p.lr * p.wd * wf;
          break;
        case SGD:
          gf = gf + p.wd * wf;
          nw = wf - p.lr * gf;
          break;
        default:  // SGD_MOM
          gf = gf + p.wd * wf;
          m = rnd<S>(mus * m) - p.lr * gf;
          nw = wf + m;
      }
      w[i] = p.skip ? wr[k] : from_f<W>(nw);
      if (s0) s0[i] = p.skip ? mr[k] : from_f<S>(m);
      if (s1) s1[i] = p.skip ? vr[k] : from_f<S>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// LAMB
// ---------------------------------------------------------------------------

template <typename W, typename S>
__global__ void __launch_bounds__(THREADS)
lamb_a_kernel(const W* __restrict__ w, const W* __restrict__ g,
              S* __restrict__ m, S* __restrict__ v, float* __restrict__ r,
              float* __restrict__ part, unsigned int* counter,
              float* __restrict__ ratio, long long n, Consts c, float lower,
              float upper, int has_lower, int has_upper, Hyper hy) {
  __shared__ float red[32];
  __shared__ bool last;
  const HP p = read_hp(hy);
  float bc1 = 1.f, bc2 = 1.f;
  if (c.flag) {
    const float t = *hy.t;
    bc1 = 1.f - powf(c.b1, t);
    bc2 = 1.f - powf(c.b2, t);
  }
  const float b1s = rnd<S>(c.b1), b2s = rnd<S>(c.b2);
  float ww = 0.f, rr = 0.f;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const S mo = m[i], vo = v[i];
    const float wf = to_f(w[i]);
    const float gf = pre(to_f(g[i]), p);
    const float nm = rnd<S>(b1s * to_f(mo)) + c.omb1 * gf;
    const float nv = rnd<S>(b2s * to_f(vo)) + c.omb2 * gf * gf;
    const float mhat = c.flag ? nm / bc1 : nm;
    const float vhat = c.flag ? nv / bc2 : nv;
    const float ri = mhat / (sqrtf(vhat) + c.eps) + p.wd * wf;
    r[i] = ri;
    m[i] = p.skip ? mo : from_f<S>(nm);
    v[i] = p.skip ? vo : from_f<S>(nv);
    ww += wf * wf;
    rr += ri * ri;
  }
  ww = block_sum(ww, red);
  rr = block_sum(rr, red);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = ww;
    part[gridDim.x + blockIdx.x] = rr;
    __threadfence();  // the partials are visible before the ticket
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written; sum them in index order
  __threadfence();
  float a = 0.f, b = 0.f;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS) {
    a += __ldcg(part + j);
    b += __ldcg(part + gridDim.x + j);
  }
  a = block_sum(a, red);
  b = block_sum(b, red);
  if (threadIdx.x == 0) {
    float wn = sqrtf(a);
    const float rn = sqrtf(b);
    if (has_lower) wn = wn < lower ? lower : wn;
    if (has_upper) wn = wn > upper ? upper : wn;
    *ratio = (wn > 0.f && rn > 0.f) ? wn / rn : 1.f;
    *counter = 0u;  // ready for the next tensor
  }
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
lamb_b_kernel(W* __restrict__ w, const float* __restrict__ r,
              const float* __restrict__ ratio, long long n, Hyper hy) {
  const float q = *hy.lr * *ratio;
  const bool skip = hy.skip != nullptr && *hy.skip != 0;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const W wo = w[i];
    w[i] = skip ? wo : from_f<W>(to_f(wo) - q * r[i]);
  }
}

Hyper hyper(const void* lr, const void* wd, const void* rg, const void* t,
            const void* clip, const void* skip) {
  return Hyper{static_cast<const float*>(lr), static_cast<const float*>(wd),
               static_cast<const float*>(rg), static_cast<const float*>(t),
               static_cast<const float*>(clip),
               static_cast<const unsigned char*>(skip)};
}

}  // namespace

// dtype codes: 0 f32, 1 bf16.  Every entry returns the launch's cudaError_t
// (0 = launched).

// One launch over a dtype group: table = n_leaves x 5 int64 leaf entries,
// then n_blocks int64 block entries; rule 0 Adam, 1 AdamW, 2 SGD, 3 SGD
// with momentum.
extern "C" int mxt_fused_chunk(const void* table, int n_leaves, int n_blocks,
                               int chunk, int rule, int w_dtype, int s_dtype,
                               float b1, float b2, float eps, float omb1,
                               float omb2, float momentum, int correct_bias,
                               const void* lr, const void* wd, const void* rg,
                               const void* t, const void* clip,
                               const void* skip, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n_blocks == 0) return 0;
  if (rule < 0 || rule > 3 || chunk < 1) return (int)cudaErrorInvalidValue;
  const long long* leaves = static_cast<const long long*>(table);
  const long long* blocks = leaves + 5LL * n_leaves;
  const Consts c{b1, b2, eps, omb1, omb2, momentum, correct_bias};
  const Hyper h = hyper(lr, wd, rg, t, clip, skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_CHUNK(W, S) \
  chunk_kernel<W, S><<<n_blocks, THREADS, 0, st>>>(leaves, blocks, chunk, \
                                                   rule, c, h)
  if (w_dtype == 0 && s_dtype == 0) MXT_CHUNK(float, float);
  else if (w_dtype == 1 && s_dtype == 0) MXT_CHUNK(__nv_bfloat16, float);
  else if (w_dtype == 1 && s_dtype == 1)
    MXT_CHUNK(__nv_bfloat16, __nv_bfloat16);
  else if (w_dtype == 0 && s_dtype == 1) MXT_CHUNK(float, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef MXT_CHUNK
  return (int)cudaGetLastError();
}

// LAMB phase A over one tensor of n elements: w, g (w_dtype), m, v
// (s_dtype) updated in place, r (n,) f32, part (2 * n_blocks,) f32 scratch,
// counter one zeroed uint32 (left zeroed), ratio one f32.
extern "C" int mxt_lamb_phase_a(const void* w, const void* g, void* m, void* v,
                                void* r, void* part, void* counter,
                                void* ratio, long long n, int n_blocks,
                                int w_dtype, int s_dtype, float b1, float b2,
                                float eps, float omb1, float omb2,
                                int bias_correction, float lower, float upper,
                                int has_lower, int has_upper, const void* lr,
                                const void* wd, const void* rg, const void* t,
                                const void* clip, const void* skip,
                                void* stream) {
  cudaGetLastError();
  if (n <= 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const Consts c{b1, b2, eps, omb1, omb2, 0.f, bias_correction};
  const Hyper h = hyper(lr, wd, rg, t, clip, skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_LAMB_A(W, S)                                                     \
  lamb_a_kernel<W, S><<<n_blocks, THREADS, 0, st>>>(                         \
      static_cast<const W*>(w), static_cast<const W*>(g),                    \
      static_cast<S*>(m), static_cast<S*>(v), static_cast<float*>(r),        \
      static_cast<float*>(part), static_cast<unsigned int*>(counter),        \
      static_cast<float*>(ratio), n, c, lower, upper, has_lower, has_upper,  \
      h)
  if (w_dtype == 0 && s_dtype == 0) MXT_LAMB_A(float, float);
  else if (w_dtype == 1 && s_dtype == 0) MXT_LAMB_A(__nv_bfloat16, float);
  else if (w_dtype == 1 && s_dtype == 1)
    MXT_LAMB_A(__nv_bfloat16, __nv_bfloat16);
  else if (w_dtype == 0 && s_dtype == 1) MXT_LAMB_A(float, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef MXT_LAMB_A
  return (int)cudaGetLastError();
}

// LAMB phase B: w (n,) in w_dtype updated in place from r and the ratio of
// phase A.
extern "C" int mxt_lamb_phase_b(void* w, const void* r, const void* ratio,
                                long long n, int w_dtype, const void* lr,
                                const void* skip, void* stream) {
  cudaGetLastError();
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h = hyper(lr, nullptr, nullptr, nullptr, nullptr, skip);
  long long nb = (n + 4LL * THREADS - 1) / (4LL * THREADS);
  const int blocks = (int)(nb > 8192 ? 8192 : nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0)
    lamb_b_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<float*>(w), static_cast<const float*>(r),
        static_cast<const float*>(ratio), n, h);
  else if (w_dtype == 1)
    lamb_b_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<__nv_bfloat16*>(w), static_cast<const float*>(r),
        static_cast<const float*>(ratio), n, h);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
