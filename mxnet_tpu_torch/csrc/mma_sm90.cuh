// Tensor-core and async-copy helpers shared by the port's CUDA kernels
// (quantized_matmul.cu, flash_attention.cu, paged_attention.cu): 16-, 8-
// and 4-byte cp.async into shared memory, ldmatrix, the mma.sync products for
// bf16 and f16 (m16n8k16) and TF32 (m16n8k8), all accumulating in f32, and
// `Mma<T>`, the operand fragments of those products by input type.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k*"), with
// g = lane / 4 and t = lane % 4:
//   C (16 x 8, f32): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   bf16 and f16 A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..); B (16 x 8): b0 (2t..2t+1, g),
//                     b1 (2t+8.., g); the lower k in the low half
//   TF32 A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//                    B (8 x 8): b0 (t, g), b1 (t+4, g)
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}
// 8 bytes global -> shared (src_bytes 0 zero-fills)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}
// 4 bytes global -> shared (src_bytes 0 zero-fills)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16-byte aligned).  Plain: lane holds (g, 2t..2t+1) of each matrix;
// .trans: (2t..2t+1, g), i.e. of the transposed matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Called by every thread of the block after it wrote its partials: true in
// the last of `arrivals` blocks to arrive on `counter`, which then sees
// every partial written before the others arrived.
__device__ __forceinline__ bool arrive_last(unsigned int* counter,
                                            int arrivals) {
  __shared__ bool last;
  __threadfence();  // this thread's partials are visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == (unsigned int)(arrivals - 1);
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
// round to nearest even; past f16's range a value becomes +-inf, as a
// float16 cast does (no saturation)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats as a pair of T, and the m16n8k16 product of T operands
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                                float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(
    float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                              float hi) {
  return pack_f16(lo, hi);
}
template <typename T> __device__ __forceinline__ void mma16(
    float* c, const uint32_t* a, const uint32_t* b);
template <> __device__ __forceinline__ void mma16<__nv_bfloat16>(
    float* c, const uint32_t* a, const uint32_t* b) {
  mma_bf16(c, a, b);
}
template <> __device__ __forceinline__ void mma16<__half>(
    float* c, const uint32_t* a, const uint32_t* b) {
  mma_f16(c, a, b);
}

// The operand fragments of the tensor-core products, by input type (layouts
// above).  X is a tile in shared memory with row
// stride ld elements; B loads fill the two 8-wide n-tiles at n0, n0 + 8.
template <typename T> struct Mma;

// bf16 and f16 (`Mma16<T>`): m16n8k16 with f32 accumulation; tiles stay
// 16-bit and ldmatrix loads the fragments (rows padded by 16 bytes:
// conflict-free).  The two types share the fragment layout; they differ
// only in the product instruction and the rounding of `a_acc` / `store2`.
template <typename T_> struct Mma16 {
  using T = T_;
  static constexpr int KS = 16;  // k of one product
  static constexpr int PAD = 8;  // row pad, elements
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  // A[m][k] = X[m0 + m][k0 + k]
  static __device__ __forceinline__ void a_row(A& a, const T* X, int ld,
                                               int m0, int k0, int lane) {
    const int mi = lane >> 3, ri = lane & 7;
    ldsm_x4(a.r, X + (m0 + (mi & 1) * 8 + ri) * ld + k0 + (mi >> 1) * 8);
  }
  // A[m][k] = X[k0 + k][m0 + m]
  static __device__ __forceinline__ void a_trans(A& a, const T* X, int ld,
                                                 int m0, int k0, int lane) {
    const int mi = lane >> 3, ri = lane & 7;
    ldsm_x4_t(a.r, X + (k0 + (mi >> 1) * 8 + ri) * ld + m0 + (mi & 1) * 8);
  }
  // B[k][n] = X[n0 + n][k0 + k]
  static __device__ __forceinline__ void b_nrow(B (&b)[2], const T* X,
                                                int ld, int n0, int k0,
                                                int lane) {
    const int mi = lane >> 3, ri = lane & 7;
    uint32_t r[4];
    ldsm_x4(r, X + (n0 + (mi >> 1) * 8 + ri) * ld + k0 + (mi & 1) * 8);
    b[0].r[0] = r[0];
    b[0].r[1] = r[1];
    b[1].r[0] = r[2];
    b[1].r[1] = r[3];
  }
  // B[k][n] = X[k0 + k][n0 + n]
  static __device__ __forceinline__ void b_krow(B (&b)[2], const T* X,
                                                int ld, int k0, int n0,
                                                int lane) {
    const int mi = lane >> 3, ri = lane & 7;
    uint32_t r[4];
    ldsm_x4_t(r, X + (k0 + (mi & 1) * 8 + ri) * ld + n0 + (mi >> 1) * 8);
    b[0].r[0] = r[0];
    b[0].r[1] = r[1];
    b[1].r[0] = r[2];
    b[1].r[1] = r[3];
  }
  // b_krow matching an A from `a_acc` (here the same k order)
  static __device__ __forceinline__ void b_krow_acc(B (&b)[2], const T* X,
                                                    int ld, int k0, int n0,
                                                    int lane) {
    b_krow(b, X, ld, k0, n0, lane);
  }
  // the same fragments from an int8 tile (an int8 KV page), each value
  // converted to T in registers: values in [-127, 127] are exact there
  static __device__ __forceinline__ void b_nrow(B (&b)[2], const int8_t* X,
                                                int ld, int n0, int k0,
                                                int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r = X + (n0 + 8 * i + (lane >> 2)) * ld + k0 +
                        2 * (lane & 3);
      b[i].r[0] = pack2<T>(r[0], r[1]);
      b[i].r[1] = pack2<T>(r[8], r[9]);
    }
  }
  static __device__ __forceinline__ void b_krow_acc(B (&b)[2],
                                                    const int8_t* X, int ld,
                                                    int k0, int n0,
                                                    int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* c = X + (k0 + 2 * (lane & 3)) * ld + n0 + 8 * i +
                        (lane >> 2);
      b[i].r[0] = pack2<T>(c[0], c[ld]);
      b[i].r[1] = pack2<T>(c[8 * ld], c[9 * ld]);
    }
  }
  // A of k-step j from the accumulators c[n-tile][4] of an earlier product,
  // rounded to T: its 16 k columns are n-tiles 2j and 2j + 1
  static __device__ __forceinline__ void a_acc(A& a, const float (*c)[4],
                                               int j) {
    a.r[0] = pack2<T>(c[2 * j][0], c[2 * j][1]);
    a.r[1] = pack2<T>(c[2 * j][2], c[2 * j][3]);
    a.r[2] = pack2<T>(c[2 * j + 1][0], c[2 * j + 1][1]);
    a.r[3] = pack2<T>(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma16<T>(c, a.r, b.r);
  }
  static __device__ __forceinline__ void store2(T* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(x, y);
  }
};
template <> struct Mma<__nv_bfloat16> : Mma16<__nv_bfloat16> {};
template <> struct Mma<__half> : Mma16<__half> {};

// f32: 3xTF32 -- both operands split into hi + lo TF32 halves, then
// a.lo b.hi + a.hi b.lo + a.hi b.hi (m16n8k8): about 2^-20 relative error
// a product, where one TF32 product keeps three digits
template <> struct Mma<float> {
  using T = float;
  static constexpr int KS = 8;
  static constexpr int PAD = 4;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ float widen(float f) { return f; }
  static __device__ __forceinline__ float widen(__nv_bfloat16 f) {
    return __bfloat162float(f);
  }
  static __device__ __forceinline__ float widen(__half f) {
    return __half2float(f);
  }
  static __device__ __forceinline__ float widen(int8_t f) {
    return static_cast<float>(f);
  }
  // hi keeps f's top 10 mantissa bits (exact in TF32), lo = f - hi exactly;
  // the tensor core reads lo's top 10 bits, so a product keeps ~20 bits
  static __device__ __forceinline__ void split(float f, uint32_t& hi,
                                               uint32_t& lo) {
    hi = __float_as_uint(f) & 0xffffe000u;
    lo = __float_as_uint(f - __uint_as_float(hi));
  }
  static __device__ __forceinline__ void set_a(A& a, float f0, float f1,
                                               float f2, float f3) {
    split(f0, a.hi[0], a.lo[0]);
    split(f1, a.hi[1], a.lo[1]);
    split(f2, a.hi[2], a.lo[2]);
    split(f3, a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void a_row(A& a, const T* X, int ld,
                                               int m0, int k0, int lane) {
    const T* r0 = X + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
    const T* r8 = r0 + 8 * ld;
    set_a(a, r0[0], r8[0], r0[4], r8[4]);
  }
  static __device__ __forceinline__ void a_trans(A& a, const T* X, int ld,
                                                 int m0, int k0, int lane) {
    const T* c0 = X + (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
    const T* c4 = c0 + 4 * ld;
    set_a(a, c0[0], c0[8], c4[0], c4[8]);
  }
  // B loads read f32 tiles, or bf16, f16 or int8 tiles widened in
  // registers (a bf16 or f16 value -- f16 keeps 10 mantissa bits, as TF32
  // does -- or an integer in [-127, 127], is exact in TF32: its lo half is
  // zero)
  template <typename S>
  static __device__ __forceinline__ void b_nrow(B (&b)[2], const S* X,
                                                int ld, int n0, int k0,
                                                int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const S* r = X + (n0 + 8 * i + (lane >> 2)) * ld + k0 + (lane & 3);
      split(widen(r[0]), b[i].hi[0], b[i].lo[0]);
      split(widen(r[4]), b[i].hi[1], b[i].lo[1]);
    }
  }
  template <typename S>
  static __device__ __forceinline__ void b_krow(B (&b)[2], const S* X,
                                                int ld, int k0, int n0,
                                                int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const S* r = X + (k0 + (lane & 3)) * ld + n0 + 8 * i + (lane >> 2);
      split(widen(r[0]), b[i].hi[0], b[i].lo[0]);
      split(widen(r[4 * ld]), b[i].hi[1], b[i].lo[1]);
    }
  }
  // `a_acc` puts k columns 2t and 2t + 1 where the layout has t and t + 4
  // (a sum's terms may come in any order): B takes its rows in that order
  template <typename S>
  static __device__ __forceinline__ void b_krow_acc(B (&b)[2], const S* X,
                                                    int ld, int k0, int n0,
                                                    int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const S* r =
          X + (k0 + 2 * (lane & 3)) * ld + n0 + 8 * i + (lane >> 2);
      split(widen(r[0]), b[i].hi[0], b[i].lo[0]);
      split(widen(r[ld]), b[i].hi[1], b[i].lo[1]);
    }
  }
  // A of k-step j from accumulator n-tile j: c0 (g, 2t), c1 (g, 2t+1),
  // c2 (g+8, 2t), c3 (g+8, 2t+1) in the slots of (g, t), (g+8, t),
  // (g, t+4), (g+8, t+4)
  static __device__ __forceinline__ void a_acc(A& a, const float (*c)[4],
                                               int j) {
    set_a(a, c[j][0], c[j][2], c[j][1], c[j][3]);
  }
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi);  // the small terms first
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  static __device__ __forceinline__ void store2(T* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

}  // namespace
