// Fused optimizer updates for Hopper (sm_90a): the multi-tensor chunk
// kernel and LAMB's multi-tensor phases A and B, CUDA C++ with plain C
// entries.
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
// hyperparameters promote a bf16 or f16 leaf, as in JAX), updating weights
// and optimizer state IN PLACE:
//   g = clip(g * rescale_grad, +-clip_gradient)      (clip when given)
//   Adam   g += wd*w; m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g;
//          w -= lr*sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)
//   AdamW  m, v as Adam without wd; lr_t = lr (bias-corrected when
//          correct_bias); w = w - lr_t*m/(sqrt(v)+eps) - lr*wd*w
//   SGD    g += wd*w; w -= lr*g, or with momentum mom = mu*mom - lr*g;
//          w += mom
//   NAG    g += wd*w; mom = mu*mom - lr*g; w = w + mu*mom - lr*g (the new
//          mom)
//   Signum with momentum: mom = mu*mom - (1-mu)*(g + wd*w);
//          w = (1 - lr*wd_lh)*w + lr*sign(mom); without:
//          w = (1 - lr*(wd_lh + wd))*w - lr*sign(g)  (sign 0 at 0, NaN at
//          NaN, as jnp.sign)
//   AdaBelief  g += wd*w; m as Adam; v = b2*v + (1-b2)*(g-m)^2 + eps (the
//          new m); w -= lr*sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)
//   Adamax g += wd*w; m as Adam; u = max(b2*u, |g|) (NaN wins, as
//          jnp.maximum); w -= lr/(1-b1^t) * m / (u + 1e-8)
//   AdaDelta (rho in b1) g += wd*w; acc_g = rho*acc_g + (1-rho)*g*g;
//          delta = sqrt(acc_delta + eps) / sqrt(acc_g + eps) * g (the old
//          acc_delta, the new acc_g); acc_delta = rho*acc_delta +
//          (1-rho)*delta^2; w -= lr*delta
//   FTML   state (d, v, z); g += wd*w; v = b2*v + (1-b2)*g*g;
//          d' = (1-b1^t)/lr * (sqrt(v/(1-b2^t)) + eps); sigma = d' - b1*d;
//          z = b1*z + (1-b1)*g - sigma*w; w = -z/d'; d = d'
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
// too: a no-op for f32 state, rnd(rnd(b1) * m) for bf16 or f16 state.
// Where a rule adds a Python float to a stored state, or takes the square
// root of one (AdaDelta's sqrt(acc_delta + eps)), that is a 16-bit sum and
// a 16-bit root in JAX, so the kernel rounds both to S as well.  lr, wd,
// rescale_grad, t, clip_gradient and the skip flag are read from device
// memory — no host sync per step.  With skip
// set, every weight and state element is written back as the bits it was
// read as (a select, so a NaN gradient never reaches an output).
//
// What bounds them on the H100: bytes at 3.35 TB/s — Adam reads w, g, m, v
// and writes w, m, v (28 B an f32 element, 22 B a bf16 or f16 one over f32
// state, 16 B over 16-bit state; FTML, with a third state, 36 and 30; SGD
// and Signum without momentum 12 and 6); LAMB
// moves 40
// B an f32 element over its two phases (r goes out and back).  Design,
// simple first: the chunk kernel is the CUDA form of the TPU's packed
// chunk without the packing — one launch per dtype group over a device
// table of per-leaf pointers and sizes, and a block map that gives each
// block one CHUNK-element range of one leaf, so no torch.cat copy exists.
// Each thread issues the loads of ILP elements before it computes.
//
// LAMB phase A is one launch per dtype group too (159 tensors of BERT-base
// in one or two launches, where a launch per tensor paid a launch and a
// last-block reduction for each 768-element LayerNorm vector): the same
// leaf table, each leaf entry also carrying its offset into the group's r
// scratch and its first partial slot, and the same (leaf, chunk) block map,
// walked by persistent blocks (as many as fit on the card).  A thread moves
// 8 elements a step with 16-byte loads of w, g, m and v (two steps' loads
// in flight) where the leaf's pointers are 16-byte aligned, one element at
// a time otherwise (and for a leaf's ragged tail).  Each chunk writes its
// partial sums of w^2 and r^2 to its slot; a per-leaf integer ticket picks
// the leaf's last chunk to finish, whose block sums the leaf's partials in
// chunk order and writes the leaf's trust ratio — no float atomics, so the
// ratio does not depend on which block finished last.
//
// LAMB phase B is one launch per dtype group as well, over phase A's own
// device table (no second table, no second copy from the host): persistent
// blocks walk the same codes with the same 16-byte steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}
// round to nearest even, once; past f16's range +-inf (no saturation), as
// JAX's .astype(float16) rounds
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
// x rounded to S and widened back (identity for f32)
template <typename S> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<S>(x));
}

// 8 consecutive elements of T as raw bits, loaded and stored as 16-byte
// vectors (two for f32)
template <typename T> struct Bits;
template <> struct Bits<float> {
  using R = unsigned;
  static __device__ __forceinline__ float f(R r) { return __uint_as_float(r); }
  static __device__ __forceinline__ R r(float x) { return __float_as_uint(x); }
};
template <> struct Bits<__nv_bfloat16> {
  using R = unsigned short;
  static __device__ __forceinline__ float f(R r) {
    return __uint_as_float((unsigned)r << 16);
  }
  static __device__ __forceinline__ R r(float x) {
    return __bfloat16_as_ushort(__float2bfloat16(x));
  }
};
// f16 is not the top half of an f32 (bf16's << 16 would misread it):
// widen through the half type
template <> struct Bits<__half> {
  using R = unsigned short;
  static __device__ __forceinline__ float f(R r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ R r(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
template <typename T> union Pack8 {
  uint4 q[sizeof(T) / 2];
  typename Bits<T>::R r[8];
};
template <typename T>
__device__ __forceinline__ Pack8<T> load8(const T* p) {
  Pack8<T> v;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    v.q[i] = reinterpret_cast<const uint4*>(p)[i];
  return v;
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const Pack8<T>& v) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    reinterpret_cast<uint4*>(p)[i] = v.q[i];
}

// Device-resident hyperparameters (f32 scalars; clip and skip may be null).
struct Hyper {
  const float *lr, *wd, *rg, *t, *clip;
  const unsigned char* skip;  // a torch.bool
};
// Host constants of the rule (AdaDelta's rho rides in b1, 1 - rho in
// omb1).
struct Consts {
  float b1, b2, eps, omb1, omb2, momentum;  // omb = 1 - b, rounded once
  float ommom, wd_lh;  // Signum: 1 - momentum (rounded once), wd_lh
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

// g + wd * w rounded as written, no fused multiply-add: where the two
// cancel, a rule that divides by a root of the sum (Adamax's u) would turn
// the fused form's other residual into a different step
__device__ __forceinline__ float add_wd(float g, const HP& p, float w) {
  return __fadd_rn(g, __fmul_rn(p.wd, w));
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

enum Rule {
  ADAM = 0, ADAMW = 1, SGD = 2, SGD_MOM = 3, NAG = 4, SIGNUM = 5,
  SIGNUM_MOM = 6, ADABELIEF = 7, ADAMAX = 8, ADADELTA = 9, FTML = 10
};
constexpr int N_RULES = 11;

// jnp.sign: -1 or 1, and x itself at +-0 and NaN
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}
// jnp.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// ---------------------------------------------------------------------------
// the multi-tensor chunk kernel
// ---------------------------------------------------------------------------

// leaves: n_leaves x {w, g, s0, s1, s2, n} (pointers as int64; a state
// pointer is 0 where the rule keeps less state); blocks: per block
// (leaf << 32) | chunk index.
template <typename W, typename S>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const long long* __restrict__ leaves,
             const long long* __restrict__ blocks, int chunk, int rule,
             Consts c, Hyper hy) {
  const long long code = blocks[blockIdx.x];
  const long long* L = leaves + 6 * (code >> 32);
  W* __restrict__ w = reinterpret_cast<W*>(L[0]);
  const W* __restrict__ g = reinterpret_cast<const W*>(L[1]);
  S* __restrict__ s0 = reinterpret_cast<S*>(L[2]);
  S* __restrict__ s1 = reinterpret_cast<S*>(L[3]);
  S* __restrict__ s2 = reinterpret_cast<S*>(L[4]);
  const long long start = (code & 0xffffffffLL) * chunk;
  const long long end = min(L[5], start + chunk);
  const HP p = read_hp(hy);
  // the step's scalars, f32 on the device step t, as the rules take them
  float lr_t = p.lr, bc2 = 1.f;
  if (rule == ADAM || rule == ADABELIEF || (rule == ADAMW && c.flag)) {
    const float t = *hy.t;
    lr_t = p.lr * sqrtf(1.f - powf(c.b2, t)) / (1.f - powf(c.b1, t));
  } else if (rule == ADAMAX) {
    lr_t = p.lr / (1.f - powf(c.b1, *hy.t));
  } else if (rule == FTML) {
    const float t = *hy.t;
    lr_t = (1.f - powf(c.b1, t)) / p.lr;  // d' = lr_t * (sqrt(v/bc2) + eps)
    bc2 = 1.f - powf(c.b2, t);
  }
  const float b1s = rnd<S>(c.b1), b2s = rnd<S>(c.b2),
              mus = rnd<S>(c.momentum), epss = rnd<S>(c.eps);
  const S zero = from_f<S>(0.f);
  for (long long i0 = start + threadIdx.x; i0 < end;
       i0 += (long long)ILP * THREADS) {
    W wr[ILP], gr[ILP];
    S mr[ILP], vr[ILP], zr[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = i0 + (long long)k * THREADS;
      mr[k] = vr[k] = zr[k] = zero;
      if (i < end) {
        wr[k] = w[i];
        gr[k] = g[i];
        if (s0) mr[k] = s0[i];
        if (s1) vr[k] = s1[i];
        if (s2) zr[k] = s2[i];
      }
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = i0 + (long long)k * THREADS;
      if (i >= end) continue;
      const float wf = to_f(wr[k]);
      float gf = pre(to_f(gr[k]), p);
      // m, v, z: the new values of state slots 0, 1 and 2
      float m = to_f(mr[k]), v = to_f(vr[k]), z = to_f(zr[k]), nw;
      switch (rule) {
        case ADAM:
          gf = add_wd(gf, p, wf);
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
          gf = add_wd(gf, p, wf);
          nw = wf - p.lr * gf;
          break;
        case SGD_MOM:
          gf = add_wd(gf, p, wf);
          m = rnd<S>(mus * m) - p.lr * gf;
          nw = wf + m;
          break;
        case NAG:
          gf = add_wd(gf, p, wf);
          m = rnd<S>(mus * m) - p.lr * gf;
          nw = wf + c.momentum * m - p.lr * gf;
          break;
        case SIGNUM:
          nw = (1.f - p.lr * (c.wd_lh + p.wd)) * wf - p.lr * sgn(gf);
          break;
        case SIGNUM_MOM:
          // rounded as written, no fused multiply-add: the sign of a
          // momentum near 0 must be the plain version's
          m = __fsub_rn(rnd<S>(mus * m), __fmul_rn(c.ommom,
                                                   add_wd(gf, p, wf)));
          nw = (1.f - p.lr * c.wd_lh) * wf + p.lr * sgn(m);
          break;
        case ADABELIEF: {
          gf = add_wd(gf, p, wf);
          m = rnd<S>(b1s * m) + c.omb1 * gf;
          const float d = gf - m;
          v = rnd<S>(b2s * v) + c.omb2 * (d * d) + c.eps;
          nw = wf - lr_t * m / (sqrtf(v) + c.eps);
          break;
        }
        case ADAMAX:
          gf = add_wd(gf, p, wf);
          m = rnd<S>(b1s * m) + c.omb1 * gf;
          v = nan_max(rnd<S>(b2s * v), fabsf(gf));
          nw = wf - lr_t * m / (v + 1e-8f);
          break;
        case ADADELTA: {
          // m: acc_g, v: acc_delta; the old acc_delta + eps and its root
          // are 16-bit operations on a 16-bit state
          gf = add_wd(gf, p, wf);
          m = rnd<S>(b1s * m) + c.omb1 * gf * gf;
          const float delta =
              rnd<S>(sqrtf(rnd<S>(v + epss))) / sqrtf(m + c.eps) * gf;
          v = rnd<S>(b1s * v) + c.omb1 * delta * delta;
          nw = wf - p.lr * delta;
          break;
        }
        default: {  // FTML: m is d, v is v, z is z
          gf = add_wd(gf, p, wf);
          v = rnd<S>(b2s * v) + c.omb2 * gf * gf;
          const float d = lr_t * (sqrtf(v / bc2) + c.eps);
          const float sigma = d - rnd<S>(b1s * m);
          z = rnd<S>(b1s * z) + c.omb1 * gf - sigma * wf;
          m = d;
          nw = -z / d;
        }
      }
      w[i] = p.skip ? wr[k] : from_f<W>(nw);
      if (s0) s0[i] = p.skip ? mr[k] : from_f<S>(m);
      if (s1) s1[i] = p.skip ? vr[k] : from_f<S>(v);
      if (s2) s2[i] = p.skip ? zr[k] : from_f<S>(z);
    }
  }
}

// ---------------------------------------------------------------------------
// LAMB
// ---------------------------------------------------------------------------

// One LAMB phase-A leaf entry of the table (int64 each).
struct LambLeaf {
  long long w, g, m, v;  // pointers
  long long n;           // elements
  long long r_off;       // its first element in the group's r scratch
  long long p_off;       // its first partial slot (one a chunk)
  long long nch;         // its chunks
};

// The per-element math of phase A, in the order of the rules: new m and v
// (the decay rounded to S), the update direction r, and the squares.
template <typename S>
__device__ __forceinline__ float lamb_elem(float wf, float gf, float mo,
                                           float vo, float& nm, float& nv,
                                           const Consts& c, const HP& p,
                                           float b1s, float b2s, float bc1,
                                           float bc2) {
  gf = pre(gf, p);
  nm = rnd<S>(b1s * mo) + c.omb1 * gf;
  nv = rnd<S>(b2s * vo) + c.omb2 * gf * gf;
  const float mhat = c.flag ? nm / bc1 : nm;
  const float vhat = c.flag ? nv / bc2 : nv;
  return mhat / (sqrtf(vhat) + c.eps) + p.wd * wf;
}

constexpr int LAMB_U = 2;  // 8-element steps a thread keeps in flight

// table = n_leaves LambLeaf entries, then n_blocks (leaf << 32 | chunk)
// codes; persistent blocks walk the codes.  r: the group's f32 scratch;
// part: 2 floats a partial slot; tickets: one zeroed uint32 a leaf (left
// zeroed); ratio: one f32 a leaf.
template <typename W, typename S>
__global__ void __launch_bounds__(THREADS)
lamb_a_kernel(const long long* __restrict__ table, int n_leaves,
              int n_blocks, int chunk, float* __restrict__ r,
              float* __restrict__ part, unsigned int* tickets,
              float* __restrict__ ratio, Consts c, float lower, float upper,
              int has_lower, int has_upper, Hyper hy) {
  __shared__ float red[32];
  __shared__ bool last;
  const LambLeaf* leaves = reinterpret_cast<const LambLeaf*>(table);
  const long long* codes = table + 8LL * n_leaves;
  const HP p = read_hp(hy);
  float bc1 = 1.f, bc2 = 1.f;
  if (c.flag) {
    const float t = *hy.t;
    bc1 = 1.f - powf(c.b1, t);
    bc2 = 1.f - powf(c.b2, t);
  }
  const float b1s = rnd<S>(c.b1), b2s = rnd<S>(c.b2);
  const int tid = threadIdx.x;
  for (int e = blockIdx.x; e < n_blocks; e += gridDim.x) {
    const long long code = codes[e];
    const int li = (int)(code >> 32);
    const long long ck = code & 0xffffffffLL;
    const LambLeaf L = leaves[li];
    W* __restrict__ w = reinterpret_cast<W*>(L.w);
    const W* __restrict__ g = reinterpret_cast<const W*>(L.g);
    S* __restrict__ m = reinterpret_cast<S*>(L.m);
    S* __restrict__ v = reinterpret_cast<S*>(L.v);
    float* __restrict__ rr = r + L.r_off;
    const long long start = ck * chunk;
    const long long end = min(L.n, start + chunk);
    float ww = 0.f, rs = 0.f;
    long long tail = start;
    if (((L.w | L.g | L.m | L.v) & 15) == 0) {
      // 16-byte steps of 8 elements over the chunk's whole eighths
      const long long vend = start + (end - start) / 8 * 8;
      for (long long i0 = start + 8LL * tid; i0 < vend;
           i0 += 8LL * THREADS * LAMB_U) {
        Pack8<W> wv[LAMB_U], gv[LAMB_U];
        Pack8<S> mv[LAMB_U], vv[LAMB_U];
#pragma unroll
        for (int u = 0; u < LAMB_U; ++u) {
          const long long i = i0 + 8LL * THREADS * u;
          if (i < vend) {
            wv[u] = load8(w + i);
            gv[u] = load8(g + i);
            mv[u] = load8(m + i);
            vv[u] = load8(v + i);
          }
        }
#pragma unroll
        for (int u = 0; u < LAMB_U; ++u) {
          const long long i = i0 + 8LL * THREADS * u;
          if (i >= vend) continue;
          Pack8<S> nmv, nvv;
          float ro[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float wf = Bits<W>::f(wv[u].r[j]);
            float nm, nv;
            ro[j] = lamb_elem<S>(wf, Bits<W>::f(gv[u].r[j]),
                                 Bits<S>::f(mv[u].r[j]),
                                 Bits<S>::f(vv[u].r[j]), nm, nv, c, p, b1s,
                                 b2s, bc1, bc2);
            nmv.r[j] = p.skip ? mv[u].r[j] : Bits<S>::r(nm);
            nvv.r[j] = p.skip ? vv[u].r[j] : Bits<S>::r(nv);
            ww += wf * wf;
            rs += ro[j] * ro[j];
          }
          store8(m + i, nmv);
          store8(v + i, nvv);
          reinterpret_cast<float4*>(rr + i)[0] =
              make_float4(ro[0], ro[1], ro[2], ro[3]);
          reinterpret_cast<float4*>(rr + i)[1] =
              make_float4(ro[4], ro[5], ro[6], ro[7]);
        }
      }
      tail = vend;
    }
    // one element at a time: an unaligned leaf, and a ragged tail
    for (long long i = tail + tid; i < end; i += THREADS) {
      const S mo = m[i], vo = v[i];
      const float wf = to_f(w[i]);
      float nm, nv;
      const float ri = lamb_elem<S>(wf, to_f(g[i]), to_f(mo), to_f(vo), nm,
                                    nv, c, p, b1s, b2s, bc1, bc2);
      rr[i] = ri;
      m[i] = p.skip ? mo : from_f<S>(nm);
      v[i] = p.skip ? vo : from_f<S>(nv);
      ww += wf * wf;
      rs += ri * ri;
    }
    ww = block_sum(ww, red);
    rs = block_sum(rs, red);
    if (tid == 0) {
      part[2 * (L.p_off + ck)] = ww;
      part[2 * (L.p_off + ck) + 1] = rs;
      __threadfence();  // the partials are visible before the ticket
      last = atomicAdd(tickets + li, 1u) == (unsigned)(L.nch - 1);
    }
    __syncthreads();
    if (!last) continue;
    // the leaf's last chunk: every partial is written; sum them in chunk
    // order
    __threadfence();
    float a = 0.f, b = 0.f;
    for (long long j = tid; j < L.nch; j += THREADS) {
      a += __ldcg(part + 2 * (L.p_off + j));
      b += __ldcg(part + 2 * (L.p_off + j) + 1);
    }
    a = block_sum(a, red);
    b = block_sum(b, red);
    if (tid == 0) {
      float wn = sqrtf(a);
      const float rn = sqrtf(b);
      if (has_lower) wn = wn < lower ? lower : wn;
      if (has_upper) wn = wn > upper ? upper : wn;
      ratio[li] = (wn > 0.f && rn > 0.f) ? wn / rn : 1.f;
      tickets[li] = 0u;  // ready for the next launch
    }
  }
}

// the card's SM count, read once per device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

// Persistent blocks for a launch of `kern` over n_blocks codes: as many as
// fit on the card at once (the kernel's occupancy, queried once into
// *per_sm, times the SMs), at most one a code.
template <typename K>
cudaError_t persistent_grid(K kern, int* per_sm, int n_blocks,
                            unsigned* grid) {
  if (*per_sm == 0) {
    int n = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, 0);
    if (e != cudaSuccess) return e;
    *per_sm = n > 0 ? n : 1;
  }
  const long long gr = (long long)*per_sm * sm_count();
  *grid = (unsigned)(gr < n_blocks ? gr : n_blocks);
  return cudaSuccess;
}

// LAMB phase B over one dtype group: phase A's own table (each leaf
// entry's w, n and r offset, then the (leaf << 32 | chunk) codes), walked
// by persistent blocks in phase A's order.  Per chunk, q = lr *
// ratio[leaf] once, then each element w' = fmaf(-q, r, w) rounded to W:
// one rounding, whatever the compiler's contraction.  A thread moves 8
// elements a step (one 16-byte load of a bf16 w, two of an f32 one, two
// float4 loads of r, one 16-byte store; two steps in flight) where w is
// 16-byte aligned, one element at a time otherwise and for a leaf's ragged
// tail.  With skip set, the loaded bits go back (a select, so a NaN in r
// never reaches w).
template <typename W>
__global__ void __launch_bounds__(THREADS)
lamb_b_kernel(const long long* __restrict__ table, int n_leaves,
              int n_blocks, int chunk, const float* __restrict__ r, const float* __restrict__ ratio,
              Hyper hy) {
  const LambLeaf* leaves = reinterpret_cast<const LambLeaf*>(table);
  const long long* codes = table + 8LL * n_leaves;
  const float lr = *hy.lr;
  const bool skip = hy.skip != nullptr && *hy.skip != 0;
  const int tid = threadIdx.x;
  for (int e = blockIdx.x; e < n_blocks; e += gridDim.x) {
    const long long code = codes[e];
    const int li = (int)(code >> 32);
    const long long ck = code & 0xffffffffLL;
    const long long wp = leaves[li].w;
    W* __restrict__ w = reinterpret_cast<W*>(wp);
    const float* __restrict__ rr = r + leaves[li].r_off;
    const float q = lr * ratio[li];
    const long long start = ck * chunk;
    const long long end = min(leaves[li].n, start + chunk);
    long long tail = start;
    if ((wp & 15) == 0) {
      const long long vend = start + (end - start) / 8 * 8;
      for (long long i0 = start + 8LL * tid; i0 < vend;
           i0 += 8LL * THREADS * LAMB_U) {
        Pack8<W> wv[LAMB_U];
        float4 ra[LAMB_U], rb[LAMB_U];
#pragma unroll
        for (int u = 0; u < LAMB_U; ++u) {
          const long long i = i0 + 8LL * THREADS * u;
          if (i < vend) {
            wv[u] = load8(w + i);
            ra[u] = reinterpret_cast<const float4*>(rr + i)[0];
            rb[u] = reinterpret_cast<const float4*>(rr + i)[1];
          }
        }
#pragma unroll
        for (int u = 0; u < LAMB_U; ++u) {
          const long long i = i0 + 8LL * THREADS * u;
          if (i >= vend) continue;
          const float rv[8] = {ra[u].x, ra[u].y, ra[u].z, ra[u].w,
                               rb[u].x, rb[u].y, rb[u].z, rb[u].w};
          Pack8<W> o;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            o.r[j] = skip ? wv[u].r[j]
                          : Bits<W>::r(fmaf(-q, rv[j],
                                            Bits<W>::f(wv[u].r[j])));
          store8(w + i, o);
        }
      }
      tail = vend;
    }
    for (long long i = tail + tid; i < end; i += THREADS) {
      const W wo = w[i];
      w[i] = skip ? wo : from_f<W>(fmaf(-q, rr[i], to_f(wo)));
    }
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

// dtype codes: 0 f32, 1 bf16, 2 f16 (as ops/fused_norm.py numbers them).
// The weight and state pairs taken: (f32, f32), (f32, bf16), (bf16, f32),
// (bf16, bf16), (f16, f32) -- 16-bit weights under `TrainStep`'s f32 state
// -- and (f16, f16) -- the gluon Trainer's state in the weight's dtype.
// Every entry returns the launch's cudaError_t (0 = launched).

// One launch over a dtype group: table = n_leaves x 6 int64 leaf entries
// {w, g, s0, s1, s2, n}, then n_blocks int64 block entries; rule: the
// `Rule` codes (0 Adam, 1 AdamW, 2 SGD, 3 SGD with momentum, 4 NAG, 5
// Signum, 6 Signum with momentum, 7 AdaBelief, 8 Adamax, 9 AdaDelta, 10
// FTML).
extern "C" int mxt_fused_chunk(const void* table, int n_leaves, int n_blocks,
                               int chunk, int rule, int w_dtype, int s_dtype,
                               float b1, float b2, float eps, float omb1,
                               float omb2, float momentum, float ommom,
                               float wd_lh, int correct_bias, const void* lr,
                               const void* wd, const void* rg, const void* t,
                               const void* clip, const void* skip,
                               void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n_blocks == 0) return 0;
  if (rule < 0 || rule >= N_RULES || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const long long* leaves = static_cast<const long long*>(table);
  const long long* blocks = leaves + 6LL * n_leaves;
  const Consts c{b1, b2, eps, omb1, omb2, momentum, ommom, wd_lh,
                 correct_bias};
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
  else if (w_dtype == 2 && s_dtype == 0) MXT_CHUNK(__half, float);
  else if (w_dtype == 2 && s_dtype == 2) MXT_CHUNK(__half, __half);
  else return (int)cudaErrorInvalidValue;
#undef MXT_CHUNK
  return (int)cudaGetLastError();
}

// LAMB phase A over one dtype group: table = n_leaves x 8 int64 leaf
// entries {w, g, m, v, n, r offset, first partial slot, chunks}, then
// n_blocks int64 codes (leaf << 32 | chunk), chunk elements a chunk (a
// multiple of 8); w, g (w_dtype), m, v (s_dtype) updated in place; r the
// group's f32 scratch (each leaf's offset a multiple of 4); part 2 floats a
// slot; tickets one zeroed uint32 a leaf (left zeroed); ratio one f32 a
// leaf.  As many blocks as fit on the card at once, at most one an entry
// (`persistent_grid`); the number launched goes to *grid_out (if given).
extern "C" int mxt_lamb_phase_a(const void* table, int n_leaves, int n_blocks,
                                int chunk, void* r, void* part,
                                void* tickets, void* ratio, int w_dtype,
                                int s_dtype, float b1, float b2, float eps,
                                float omb1, float omb2, int bias_correction,
                                float lower, float upper, int has_lower,
                                int has_upper, const void* lr, const void* wd,
                                const void* rg, const void* t,
                                const void* clip, const void* skip,
                                int* grid_out, void* stream) {
  cudaGetLastError();
  unsigned gr = 0;
  if (grid_out) *grid_out = 0;
  if (n_blocks == 0) return 0;
  if (n_leaves < 1 || n_blocks < 0 || chunk < 8 || chunk % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(r) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Consts c{b1, b2, eps, omb1, omb2, 0.f, 0.f, 0.f, bias_correction};
  const Hyper h = hyper(lr, wd, rg, t, clip, skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(table);
#define MXT_LAMB_A(W, S)                                                     \
  do {                                                                       \
    static int per_sm = 0;                                                   \
    const cudaError_t e =                                                    \
        persistent_grid(lamb_a_kernel<W, S>, &per_sm, n_blocks, &gr);        \
    if (e != cudaSuccess) return (int)e;                                     \
    lamb_a_kernel<W, S><<<gr, THREADS, 0, st>>>(                             \
        tab, n_leaves, n_blocks, chunk, static_cast<float*>(r),              \
        static_cast<float*>(part), static_cast<unsigned int*>(tickets),      \
        static_cast<float*>(ratio), c, lower, upper, has_lower, has_upper,   \
        h);                                                                  \
  } while (0)
  if (w_dtype == 0 && s_dtype == 0) MXT_LAMB_A(float, float);
  else if (w_dtype == 1 && s_dtype == 0) MXT_LAMB_A(__nv_bfloat16, float);
  else if (w_dtype == 1 && s_dtype == 1)
    MXT_LAMB_A(__nv_bfloat16, __nv_bfloat16);
  else if (w_dtype == 0 && s_dtype == 1) MXT_LAMB_A(float, __nv_bfloat16);
  else if (w_dtype == 2 && s_dtype == 0) MXT_LAMB_A(__half, float);
  else if (w_dtype == 2 && s_dtype == 2) MXT_LAMB_A(__half, __half);
  else return (int)cudaErrorInvalidValue;
#undef MXT_LAMB_A
  if (grid_out) *grid_out = (int)gr;
  return (int)cudaGetLastError();
}

// LAMB phase B over one dtype group: table, n_leaves, n_blocks and chunk
// exactly as given to its phase A (only each leaf's w, n and r offset are
// read); r and ratio the scratch phase A wrote; w (w_dtype) updated in
// place.  Persistent blocks as phase A's (`persistent_grid`); the number
// launched goes to *grid_out (if given).
extern "C" int mxt_lamb_phase_b(const void* table, int n_leaves,
                                int n_blocks, int chunk, const void* r,
                                const void* ratio, int w_dtype,
                                const void* lr, const void* skip,
                                int* grid_out, void* stream) {
  cudaGetLastError();
  unsigned gr = 0;
  if (grid_out) *grid_out = 0;
  if (n_blocks == 0) return 0;
  if (n_leaves < 1 || n_blocks < 0 || chunk < 8 || chunk % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(r) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Hyper h = hyper(lr, nullptr, nullptr, nullptr, nullptr, skip);
  const long long* tab = static_cast<const long long*>(table);
  const float* rf = static_cast<const float*>(r);
  const float* ra = static_cast<const float*>(ratio);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_LAMB_B(W)                                                        \
  do {                                                                       \
    static int per_sm = 0;                                                   \
    const cudaError_t e =                                                    \
        persistent_grid(lamb_b_kernel<W>, &per_sm, n_blocks, &gr);           \
    if (e != cudaSuccess) return (int)e;                                     \
    lamb_b_kernel<W><<<gr, THREADS, 0, st>>>(tab, n_leaves, n_blocks, chunk, \
                                             rf, ra, h);                     \
  } while (0)
  if (w_dtype == 0) MXT_LAMB_B(float);
  else if (w_dtype == 1) MXT_LAMB_B(__nv_bfloat16);
  else if (w_dtype == 2) MXT_LAMB_B(__half);
  else return (int)cudaErrorInvalidValue;
#undef MXT_LAMB_B
  if (grid_out) *grid_out = (int)gr;
  return (int)cudaGetLastError();
}
