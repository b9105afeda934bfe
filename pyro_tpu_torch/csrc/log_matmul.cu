// log-matmul-exp on Hopper (sm_90a), forward and backward.
//
//   out[..., i, j] = log sum_k exp(x[..., i, k] + y[..., k, j])
//
// Replaces pyro_tpu/ops/log_matmul.py::logmatmulexp: its forward
// `_logmatmulexp_raw` and its analytic VJP `_bwd` (the stand-in for the
// retired Pallas kernel `_logmatmulexp_pallas`).  The arithmetic is the
// same: x is shifted by its row max xs, y by its column max ys (non-finite
// maxima become 0), the shifted exponentials are multiplied and summed in
// f32, and out = log(max(z, FLT_MIN)) + xs + ys.  An all -inf row therefore
// gives log(FLT_MIN), not -inf.
//
// Bound on an H100 SXM at the main path's first round, (2048, 256, 256) f32:
// 2*B*M*N*K = 6.9e10 flop; x, y and out are 1.6 GB together, 0.48 ms at
// 3.35 TB/s.  On the f32 CUDA cores (67 TFLOP/s) the products alone take
// 1.0 ms; on the tensor cores in TF32 (495 TFLOP/s), with the 3xTF32 split
// below, 0.42 ms, so there the op is bound by bytes.
//
// Design.  Every product runs on the tensor cores, wgmma.mma_async
// m64n128k8 tf32 with both operands in shared memory, at float32 accuracy
// (3xTF32): each operand a is split into big = tf32(a) and small =
// tf32(a - big), and each k-step takes small*big + big*small + big*big.  A
// block of 256 threads (two warpgroups of 64 rows) computes a 128x128 output
// tile, looping over the reduction in slabs of 16:
//   - cp.async brings the raw operands into a ring of slabs, two stages in
//     the forward and four in the backward;
//   - the block transforms the landed slab (subtract the shift, exp or the
//     gradient's weight, zero the ragged edge, split) into one of two
//     operand buffers, in the K-major layout without swizzle that tf32
//     wgmma requires (core matrices of 8 rows x 16 bytes; an operand whose
//     raw rows run along M or N is transposed on the way, through
//     registers);
//   - the warpgroups issue the slab's wgmmas and go on to transform the
//     next slab while the tensor cores run.
// The tensor cores' own sums truncate.  The forward sums non-negative
// terms, so that error stays within about (K / 8) * 3 * 2^-23 of z (2e-5 of
// it, about 2e-5 on out, at K = 512), and its wgmmas sum straight into the
// accumulator; with 64 registers for it, two blocks fit an SM.  The
// backward's sums cancel, so each of its slabs sums into a fresh fragment
// that joins the float32 accumulator through rounded adds (128 registers
// for both: one block an SM).  The maxima are one light kernel before the
// product (lme_max_kernel, one read of x and y); the forward writes them out
// for the backward.
//
// Backward (the bounded form of `_bwd`, with E = -(out - xs - ys) = -log z):
//   cr[i] = max_j E[i,j],  rx = (g * exp(E - cr)) @ exp(y - ys)^T,
//   dx    = sign(rx) * exp(x - xs + cr + log(|rx| + FLT_MIN))
//   cc[j] = max_i E[i,j],  ry = exp(x - xs)^T @ (g * exp(E - cc)),
//   dy    = sign(ry) * exp(y - ys + cc + log(|ry| + FLT_MIN))
// An entry whose z was clipped at FLT_MIN (a state unreachable from the
// row's support, or an all -inf row of x or column of y) has the largest E
// there is; in a shift shared with the other entries it would push their
// terms below the float32 range, and log(|r| + FLT_MIN) would then add about
// exp(x - xs) to dx.  So the clipped entries (E >= CLIP_E) are a class of
// their own: each class has its own shifts and products, and dx and dy sum
// the classes' terms.  The second class runs only in tiles that hold a
// clipped entry.  lme_stats_kernel reads out once, 32 rows a block, and
// writes each row's class maxima and each 32-row strip's column maxima; the
// product kernel then computes dx tiles (M x K) in one launch and dy tiles
// (K x N) in another.  Both write per broadcast batch item; the caller sums
// broadcast dims.
//
// Operands are read through element strides with up to three batch dims,
// so strided views (the halves of a time-paired reshape) need no copy; the
// column stride must be 1 (the wrapper copies an operand whose is not).
// With VEC (16-byte aligned rows, K and N multiples of 4) the copies move
// 16 bytes, else 4.  Plain C interface for ctypes; each entry point
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define NT 256                // threads of every kernel
#define BM 128                // output tile rows
#define BN 128                // output tile columns
#define BK 16                 // reduction slab
#define SRN (BK + 4)          // row stride of a raw tile whose rows run along the reduction
#define SCT (BM + 8)          // row stride of a raw tile whose rows run along M or N
#define RAW (BM * SRN)        // floats of one raw slot (>= BK * SCT)
#define OPND (BM * BK)        // floats of one operand in the core-matrix layout
#define GROUP (8 * BK)        // floats of one 8-row group of it
#define RS 32                 // rows of out per statistics block
#define CLIP_E 86.33654475f   // -log(FLT_MIN) - 1: E at or above it counts as clipped

enum { FWD = 0, DX = 1, DY = 2 };

// Stages of a product kernel's raw ring.  The forward holds two blocks an
// SM, so its shared memory (two stages) must fit twice; the backward's one
// block takes four.
__host__ __device__ constexpr int stages(int kind) { return kind == FWD ? 2 : 4; }

struct Mat {
  const float* p;
  long long sb0, sb1, sb2;  // batch strides
  long long sr;             // row stride; the column stride is 1
};

struct Shape {
  int n0, n1, n2;  // batch sizes
  int M, K, N;
};

struct Params {
  Mat x, y, out, g;
  Shape s;
  const float* xs;   // (B, M) finite row maxima of x
  const float* ys;   // (B, N) finite column maxima of y
  const float* cr;   // (B, 2, M) per-class row shifts (backward)
  const float* ccp;  // (B, strips, 2, N) per-strip column shifts (backward)
  int strips;
  float* dst;        // out (B, M, N), dx (B, M, K) or dy (B, K, N)
};

__device__ __forceinline__ const float* item(const Mat& m, int b, const Shape& s) {
  int i2 = b % s.n2;
  int t = b / s.n2;
  int i1 = t % s.n1;
  int i0 = t / s.n1;
  return m.p + i0 * m.sb0 + i1 * m.sb1 + i2 * m.sb2;
}

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.f; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bounded_term(float shifted, float shift, float r) {
  const float sg = (float)(r > 0.f) - (float)(r < 0.f);
  return sg * expf((shifted + shift) + logf(fabsf(r) + FLT_MIN));
}

// The gradient's weight g * exp(E - shift) of an entry of class cls, else 0.
__device__ __forceinline__ float weight(float o, float gv, float xi, float yj, float shift, int cls) {
  const float E = -(o - xi - yj);
  return (E >= CLIP_E) == (cls == 1) ? gv * expf(E - shift) : 0.f;
}

// -------------------------------------------------------- async copies --

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most STAGES - 1 groups of this thread's copies are pending:
// with the slab just queued, the oldest slab of the ring has then landed.
template <int STAGES>
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// Four floats from src to dst, those with column c + e < C; none unless row_ok.
template <bool VEC>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, bool row_ok, int c, int C) {
  if (!row_ok) return;
  if (VEC) {
    if (c < C) cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < C) cp_async4(dst + e, src + e);
  }
}

// Queue this thread's copies of the raw tile at (r0, c0) of a matrix (row
// stride rs, R x C valid).  Along the reduction (ALONG): BM rows of BK
// columns into [BM][SRN]; else BK rows of BM columns into [BK][SCT].
// Chunks outside the matrix are not copied: the transform writes 0 there.
template <bool ALONG, bool VEC>
__device__ __forceinline__ void issue_tile(float* dst, const float* src, long long rs, int r0, int c0, int R, int C) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int ch = threadIdx.x + NT * q;
    const int r = ALONG ? ch >> 2 : ch >> 5;
    const int c = ALONG ? (ch & 3) * 4 : (ch & 31) * 4;
    copy_chunk<VEC>(dst + r * (ALONG ? SRN : SCT) + c, src + (r0 + r) * rs + c0 + c, r0 + r < R, c0 + c, C);
  }
}

// ------------------------------------------------ transform and wgmma --

// Chunk ch (< 512) of a transform: four consecutive reduction indices k..k+3
// of operand row r.  raw is where the first lies in its raw tile (ALONG:
// consecutive floats; else SCT apart), core where the four go in the
// core-matrix layout: 8-row groups of GROUP floats, each BK / 4 core
// matrices of 32 floats (8 rows x 16 bytes).  Lanes of a quarter-warp take
// eight rows of one core matrix, so neither side has bank conflicts.
template <bool ALONG>
__device__ __forceinline__ void chunk(int ch, int& r, int& k, int& raw, int& core) {
  if (ALONG) {
    const int rr = ch & 7, kc = (ch >> 3) & 3, rg = ch >> 5;
    r = rg * 8 + rr;
    k = kc * 4;
    raw = r * SRN + k;
    core = rg * GROUP + kc * 32 + rr * 4;
  } else {
    const int kc = ch >> 7;
    r = ch & 127;
    k = kc * 4;
    raw = k * SCT + r;
    core = (r >> 3) * GROUP + kc * 32 + (r & 7) * 4;
  }
}

template <bool ALONG>
__device__ __forceinline__ void load_chunk(const float* t, int raw, float (&v)[4]) {
  if (ALONG) {
    const float4 u = *reinterpret_cast<const float4*>(t + raw);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = t[raw + e * SCT];
  }
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t b;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(v));
  return b;
}

// big = tf32(v) at big[core], small = tf32(v - big) at big[OPND + core].
__device__ __forceinline__ void store_split(float* big, int core, const float (&v)[4]) {
  uint32_t b[4], s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    b[e] = tf32(v[e]);
    s[e] = tf32(v[e] - __uint_as_float(b[e]));
  }
  *reinterpret_cast<uint4*>(big + core) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(big + OPND + core) = make_uint4(s[0], s[1], s[2], s[3]);
}

// Shared-memory matrix descriptor: K-major, no swizzle; the leading byte
// offset (between core matrices along k) is 128, the stride byte offset
// (between 8-row groups) GROUP floats.
__device__ __forceinline__ uint64_t desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((GROUP * 4) >> 4) << 32);
}

// d (+)= A B for one k-step of 8: A 64 x 8 and B 128 x 8, both K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keep the compiler from moving accesses of d across the asynchronous wgmma.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------- maxima --

// xs[b, i] = finite max_k x[b, i, k], ys[b, j] = finite max_k y[b, k, j]; a
// block takes 32 rows of x (four per warp, lanes along k) and 32 columns of
// y (one per lane, warps along k).
__global__ void __launch_bounds__(NT) lme_max_kernel(Mat x, Mat y, Shape s, float* __restrict__ xs,
                                                     float* __restrict__ ys) {
  __shared__ float part[NT / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * 32;
  const int nb = s.n0 * s.n1 * s.n2;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* xb = item(x, b, s);
    const float* yb = item(y, b, s);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = r0 + warp + 8 * q;
      if (i < s.M) {
        float m = -INFINITY;
#pragma unroll 4
        for (int k = lane; k < s.K; k += 32) m = fmaxf(m, xb[i * x.sr + k]);
        m = warp_max(m);
        if (lane == 0) xs[(long long)b * s.M + i] = finite_or_zero(m);
      }
    }
    const int c = r0 + lane;
    float m = -INFINITY;
    if (c < s.N) {
#pragma unroll 4
      for (int k = warp; k < s.K; k += NT / 32) m = fmaxf(m, yb[k * y.sr + c]);
    }
    part[warp][lane] = m;
    __syncthreads();
    if (warp == 0 && c < s.N) {
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, part[w][lane]);
      ys[(long long)b * s.N + c] = finite_or_zero(m);
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------- backward --

// Per batch item and row i: cr[b, cls, i] = max over j of E[i, j] in class
// cls (0: unclipped, 1: clipped; -inf if none); per 32-row strip and column
// j: ccp[b, strip, cls, j] likewise over the strip's rows.  A block takes
// one strip; thread c walks down column c, and each row's maximum is a warp
// reduction, kept per warp in shared memory.
__global__ void __launch_bounds__(NT) lme_stats_kernel(Mat out, Shape s, const float* __restrict__ xs_g,
                                                       const float* __restrict__ ys_g, float* __restrict__ cr_g,
                                                       float* __restrict__ ccp_g) {
  __shared__ float rpart[2][RS][NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strips = gridDim.x, strip = blockIdx.x, i0 = strip * RS;
  const int nb = s.n0 * s.n1 * s.n2;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* ob = item(out, b, s);
    const float* xs = xs_g + (long long)b * s.M;
    for (int e = tid; e < 2 * RS * (NT / 32); e += NT) (&rpart[0][0][0])[e] = -INFINITY;
    __syncthreads();
    for (int c0 = 0; c0 < s.N; c0 += NT) {
      const int c = c0 + tid;
      const float yc = c < s.N ? ys_g[(long long)b * s.N + c] : 0.f;
      float cm0 = -INFINITY, cm1 = -INFINITY;
#pragma unroll 4
      for (int r = 0; r < RS; ++r) {
        const int i = i0 + r;
        float e0 = -INFINITY, e1 = -INFINITY;
        if (i < s.M && c < s.N) {
          const float E = -(ob[i * out.sr + c] - xs[i] - yc);
          if (E >= CLIP_E) e1 = E; else e0 = E;
        }
        cm0 = fmaxf(cm0, e0);
        cm1 = fmaxf(cm1, e1);
        e0 = warp_max(e0);
        if (__any_sync(0xffffffffu, e1 > -INFINITY)) e1 = warp_max(e1);
        if (lane == 0) {
          rpart[0][r][warp] = fmaxf(rpart[0][r][warp], e0);
          rpart[1][r][warp] = fmaxf(rpart[1][r][warp], e1);
        }
      }
      if (c < s.N) {
        float* ccp = ccp_g + ((long long)b * strips + strip) * 2 * s.N;
        ccp[c] = cm0;
        ccp[s.N + c] = cm1;
      }
    }
    __syncthreads();
    if (tid < 2 * RS && i0 + (tid % RS) < s.M) {
      const int cls = tid / RS, r = tid % RS;
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) m = fmaxf(m, rpart[cls][r][w]);
      cr_g[((long long)b * 2 + cls) * s.M + i0 + r] = m;
    }
    __syncthreads();
  }
}

// --------------------------------------------------------- the products --

// Queue slab k0's raw operands of the product kernel (below) into t.
template <int KIND, bool VEC>
__device__ __forceinline__ void issue_slab(float* t, const Params& p, const float* xb, const float* yb,
                                           const float* ob, const float* gb, int r0, int c0, int k0) {
  const Shape& s = p.s;
  if (KIND == FWD) {
    issue_tile<true, VEC>(t, xb, p.x.sr, r0, k0, s.M, s.K);
    issue_tile<false, VEC>(t + RAW, yb, p.y.sr, k0, c0, s.K, s.N);
  } else if (KIND == DX) {
    issue_tile<true, VEC>(t, ob, p.out.sr, r0, k0, s.M, s.N);
    issue_tile<true, VEC>(t + RAW, gb, p.g.sr, r0, k0, s.M, s.N);
    issue_tile<true, VEC>(t + 2 * RAW, yb, p.y.sr, c0, k0, s.K, s.N);
  } else {
    issue_tile<false, VEC>(t, ob, p.out.sr, k0, c0, s.M, s.N);
    issue_tile<false, VEC>(t + RAW, gb, p.g.sr, k0, c0, s.M, s.N);
    issue_tile<false, VEC>(t + 2 * RAW, xb, p.x.sr, k0, r0, s.M, s.K);
  }
}

// One launch of the forward (KIND FWD: out tile rows i, columns j, over k),
// or of one half of the backward (DX: dx tile rows i, columns k, over j;
// DY: dy tile rows k, columns j, over i).  A is the operand whose rows are
// the tile's rows, B the one whose rows are its columns:
//   FWD  A = exp(x - xs)        raw rows along k       B = exp(y - ys)^T   raw rows along j
//   DX   A = W (from out, g)    raw rows along j       B = exp(y - ys)     raw rows along j
//   DY   A = exp(x - xs)^T      raw rows along k       B = W^T             raw rows along j
// with W the class's weight g * exp(E - shift).  Shared memory: the raw
// ring [STAGES][SLOTS][RAW]; the operand buffers [2][A big, A small, B big,
// B small][OPND]; the tile's vectors: mx (FWD and DX: xs of its rows; DY:
// ys of its columns), my (FWD: ys of its columns), and the two classes'
// shifts (DX: per row; DY: per column).
template <int KIND, bool VEC>
__global__ void __launch_bounds__(NT, KIND == FWD ? 2 : 1) lme_product_kernel(const Params p) {
  constexpr int SLOTS = KIND == FWD ? 2 : 3, STAGES = stages(KIND);
  constexpr bool DIRECT = KIND == FWD;  // no per-slab fragment (see the file's head)
  constexpr bool A_ALONG = KIND != DY, B_ALONG = KIND == DX;
  extern __shared__ __align__(128) float smem[];
  float* raw = smem;
  float* opnd = raw + STAGES * SLOTS * RAW;
  float* mx = opnd + 8 * OPND;
  float* my = mx + BM;
  float* sh0 = my + BN;
  float* sh1 = sh0 + 128;
  const Shape& s = p.s;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int R = KIND == DY ? s.K : s.M;  // tile rows
  const int C = KIND == DX ? s.K : s.N;  // tile columns
  const int L = KIND == FWD ? s.K : KIND == DX ? s.N : s.M;  // reduction
  const int nslab = (L + BK - 1) / BK;
  const int nb = s.n0 * s.n1 * s.n2;
  for (int b = blockIdx.z; b < nb; b += gridDim.z) {
    const float* xb = item(p.x, b, s);
    const float* yb = item(p.y, b, s);
    const float* ob = item(p.out, b, s);
    const float* gb = item(p.g, b, s);
    const float* xs = p.xs + (long long)b * s.M;
    const float* ys = p.ys + (long long)b * s.N;
    int classes = 1;
    if (KIND == FWD) {
      if (tid < BM) mx[tid] = r0 + tid < s.M ? xs[r0 + tid] : 0.f;
      else my[tid - BM] = c0 + tid - BM < s.N ? ys[c0 + tid - BM] : 0.f;
      __syncthreads();
    } else {
      float m0 = -INFINITY, m1 = -INFINITY;
      if (tid < 128) {
        const int v = (KIND == DX ? r0 : c0) + tid;
        if (KIND == DX) {
          mx[tid] = v < s.M ? xs[v] : 0.f;
          if (v < s.M) {
            m0 = p.cr[((long long)b * 2) * s.M + v];
            m1 = p.cr[((long long)b * 2 + 1) * s.M + v];
          }
        } else {
          mx[tid] = v < s.N ? ys[v] : 0.f;
          if (v < s.N)
            for (int q = 0; q < p.strips; ++q) {
              const float* ccp = p.ccp + ((long long)b * p.strips + q) * 2 * s.N;
              m0 = fmaxf(m0, ccp[v]);
              m1 = fmaxf(m1, ccp[s.N + v]);
            }
        }
        sh0[tid] = finite_or_zero(m0);
        sh1[tid] = finite_or_zero(m1);
      }
      classes = 1 + (__syncthreads_or(m1 > -INFINITY) != 0);
    }
    for (int cls = 0; cls < classes; ++cls) {
      const float* sh = cls ? sh1 : sh0;
      float acc[64], part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
      for (int sl = 0; sl < STAGES - 1; ++sl) {
        if (sl < nslab) issue_slab<KIND, VEC>(raw + sl * SLOTS * RAW, p, xb, yb, ob, gb, r0, c0, sl * BK);
        cp_async_commit();
      }
      for (int sl = 0; sl < nslab; ++sl) {
        const int k0 = sl * BK, ahead = sl + STAGES - 1;
        // stage ahead % STAGES was last read by the transform of slab sl - 1
        if (ahead < nslab) issue_slab<KIND, VEC>(raw + (ahead % STAGES) * SLOTS * RAW, p, xb, yb, ob, gb, r0, c0, ahead * BK);
        cp_async_commit();
        cp_async_wait_ring<STAGES>();
        __syncthreads();
        // transform the landed slab into operand buffer sl % 2
        const float* t = raw + (sl % STAGES) * SLOTS * RAW;
        float* a_big = opnd + (sl & 1) * 4 * OPND;
        float* b_big = a_big + 2 * OPND;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ch = tid + NT * q;
          int r, k, at, core;
          float v[4];
          chunk<A_ALONG>(ch, r, k, at, core);
          if (KIND == FWD) {
            load_chunk<true>(t, at, v);
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = r0 + r < s.M && k0 + k + e < s.K ? expf(v[e] - mx[r]) : 0.f;
          } else if (KIND == DX) {
            float w[4];
            load_chunk<true>(t, at, v);
            load_chunk<true>(t + RAW, at, w);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = k0 + k + e;
              v[e] = r0 + r < s.M && j < s.N ? weight(v[e], w[e], mx[r], ys[j], sh[r], cls) : 0.f;
            }
          } else {
            load_chunk<false>(t + 2 * RAW, at, v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = k0 + k + e;
              v[e] = r0 + r < s.K && i < s.M ? expf(v[e] - xs[i]) : 0.f;
            }
          }
          store_split(a_big, core, v);
          chunk<B_ALONG>(ch, r, k, at, core);
          if (KIND == FWD) {
            load_chunk<false>(t + RAW, at, v);
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = c0 + r < s.N && k0 + k + e < s.K ? expf(v[e] - my[r]) : 0.f;
          } else if (KIND == DX) {
            load_chunk<true>(t + 2 * RAW, at, v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = k0 + k + e;
              v[e] = c0 + r < s.K && j < s.N ? expf(v[e] - ys[j]) : 0.f;
            }
          } else {
            float w[4];
            load_chunk<false>(t, at, v);
            load_chunk<false>(t + RAW, at, w);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = k0 + k + e;
              v[e] = c0 + r < s.N && i < s.M ? weight(v[e], w[e], xs[i], mx[r], sh[r], cls) : 0.f;
            }
          }
          store_split(b_big, core, v);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        // the previous slab's product is done (so is its operand buffer):
        // fold it into the accumulator
        if (sl > 0) {
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          if (!DIRECT) {
            pin(part);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] += part[i];
          }
        }
        float(&sum)[64] = DIRECT ? acc : part;
        pin(sum);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const float* a = a_big + wg * (64 / 8) * GROUP;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
          const int ko = (kk / 4) * 32;
          wgmma_tf32(sum, desc(a + OPND + ko), desc(b_big + ko), DIRECT || kk > 0);
          wgmma_tf32(sum, desc(a + ko), desc(b_big + OPND + ko), 1);
          wgmma_tf32(sum, desc(a + ko), desc(b_big + ko), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(acc);
      if (!DIRECT) {
        pin(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }

      // epilogue: accumulator element 4n + e of this thread is at tile row
      // 64 wg + 16 warp + lane / 4 (+ 8 for e >= 2), column 8n + 2 (lane % 4) + e % 2
      const int lane = tid & 31, rw = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2), cw = 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rw + (e >> 1) * 8, c = n * 8 + cw + (e & 1);
          const float a = acc[4 * n + e];
          if (r0 + r >= R || c0 + c >= C) continue;
          const int i = r0 + r, j = c0 + c;
          if (KIND == FWD) {
            p.dst[((long long)b * s.M + i) * s.N + j] = logf(fmaxf(a, FLT_MIN)) + mx[r] + my[c];
          } else {
            float* d = KIND == DX ? p.dst + ((long long)b * s.M + i) * s.K + j
                                  : p.dst + ((long long)b * s.K + i) * s.N + j;
            const float v = KIND == DX ? bounded_term(xb[i * p.x.sr + j] - mx[r], sh[r], a)
                                       : bounded_term(yb[i * p.y.sr + j] - mx[c], sh[c], a);
            *d = cls ? *d + v : v;
          }
        }
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------ C interface --

static Mat make_mat(const float* p, const long long* st) {
  Mat m;
  m.p = p;
  m.sb0 = st[0]; m.sb1 = st[1]; m.sb2 = st[2];
  m.sr = st[3];  // st[4], the column stride, is 1
  return m;
}

static Shape make_shape(const int* bshape, int M, int K, int N) {
  Shape s;
  s.n0 = bshape[0]; s.n1 = bshape[1]; s.n2 = bshape[2];
  s.M = M; s.K = K; s.N = N;
  return s;
}

static int grid_batch(const Shape& s) {
  const int nb = s.n0 * s.n1 * s.n2;
  return nb < 65535 ? nb : 65535;
}

template <int KIND>
static int launch_product(const Params& p, int vec, int row_tiles, int col_tiles, cudaStream_t st) {
  const size_t smem = (stages(KIND) * (KIND == FWD ? 2 : 3) * RAW + 8 * OPND + 4 * 128) * sizeof(float);
  auto kernel = vec ? lme_product_kernel<KIND, true> : lme_product_kernel<KIND, false>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<dim3(col_tiles, row_tiles, grid_batch(p.s)), NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

// strides: 5 element strides per operand (3 batch, row, column; the column
// stride must be 1).  xs (B*M) and ys (B*N) receive the finite maxima.
int lme_forward(const float* x, const long long* x_st, const float* y, const long long* y_st, float* out,
                float* xs, float* ys, const int* bshape, int M, int K, int N, int vec, void* stream) {
  Params p = {};
  p.s = make_shape(bshape, M, K, N);
  p.x = make_mat(x, x_st);
  p.y = make_mat(y, y_st);
  p.out = p.g = p.x;  // unread
  p.xs = xs;
  p.ys = ys;
  p.dst = out;
  cudaStream_t st = (cudaStream_t)stream;
  const int span = M > N ? M : N;
  lme_max_kernel<<<dim3((span + 31) / 32, grid_batch(p.s)), NT, 0, st>>>(p.x, p.y, p.s, xs, ys);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_product<FWD>(p, vec, (M + BM - 1) / BM, (N + BN - 1) / BN, st);
}

// xs, ys are the forward's; scratch holds B*2*M + B*ceil(M/32)*2*N floats;
// dx is (B, M, K) and dy (B, K, N), contiguous.
int lme_backward(const float* x, const long long* x_st, const float* y, const long long* y_st, const float* out,
                 const long long* out_st, const float* g, const long long* g_st, const float* xs, const float* ys,
                 float* scratch, float* dx, float* dy, const int* bshape, int M, int K, int N, int vec,
                 void* stream) {
  Params p = {};
  p.s = make_shape(bshape, M, K, N);
  p.x = make_mat(x, x_st);
  p.y = make_mat(y, y_st);
  p.out = make_mat(out, out_st);
  p.g = make_mat(g, g_st);
  p.xs = xs;
  p.ys = ys;
  p.strips = (M + RS - 1) / RS;
  const long long nb = (long long)p.s.n0 * p.s.n1 * p.s.n2;
  float* cr = scratch;
  float* ccp = cr + nb * 2 * M;
  p.cr = cr;
  p.ccp = ccp;
  cudaStream_t st = (cudaStream_t)stream;
  lme_stats_kernel<<<dim3(p.strips, grid_batch(p.s)), NT, 0, st>>>(p.out, p.s, xs, ys, cr, ccp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  p.dst = dx;
  err = launch_product<DX>(p, vec, (M + BM - 1) / BM, (K + BN - 1) / BN, st);
  if (err) return err;
  p.dst = dy;
  return launch_product<DY>(p, vec, (K + BM - 1) / BM, (N + BN - 1) / BN, st);
}

}  // extern "C"
