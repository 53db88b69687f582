// Fused NeRF render kernels for Hopper (sm_90a): forward and backward.
//
// Replaces the two Pallas TPU kernels of bhnerf_tpu/ops/fused.py:
//   * fused_render_fwd_kernel  <- _fwd_kernel (fused.py:169), launched by
//     _render_fwd (fused.py:381-415)
//   * fused_render_bwd_kernel  <- _bwd_kernel (fused.py:198), launched by
//     _render_bwd (fused.py:418-459); fused_render_reduce_kernel sums the
//     backward's per-block partials.
//
// Per (sample, frame) column both kernels run the whole pipeline on chip:
// velocity warp (rotation about z by -Omega * max(t - t_inj, 0)), the
// positional encoding [w | sin 2^i w | cos 2^i w] by the double-angle
// recursion from one sin/cos, the MLP (ReLU, the encoded features F
// concatenated after layer net_depth//2, a one-wide head), sigmoid(x - 10)
// and the validity/domain mask. Layouts follow the PyTorch wrapper
// (bhnerf_tpu_torch/ops/fused.py): per-sample rows (N,), emission (nt, N),
// the stashed features F (feat, nt*N) with column t*N + n. Weights arrive
// as nn.Linear's (out, in) matrices with `in` zero-padded to a multiple of
// 16 (the feature rows F to FP = roundup16(feat)), packed layer after
// layer; gradients come back in the same padded layout followed by the
// biases.
//
// What bounds them on this card: the matmul chain. Device-memory traffic
// is small by design: activations never leave shared memory, and a
// column reads 5 floats and writes 1 (plus feat floats of stash).
//
// Forward: ~109 kFLOP per column. Every activation of a 64-column tile
// stays in shared memory and the products run on the tensor cores (WMMA
// m16n16k8 TF32, one 16-row weight tile per warp, fragments straight
// from the L2-resident weights and from shared memory).
//
// Backward: ~323 kFLOP per column (recompute 109k, weight gradients
// 109k, products back through the weights 104k; 4x128, 21 features).
// At the training step's 410,112 columns that is 132 GFLOP, 397 GFLOP of
// TF32 in f32 mode (3 products each): 0.80 ms at 495 TFLOP/s, against
// ~90 MB of device-memory traffic (0.03 ms). So it is compute-bound, and
// the design serves the tensor cores:
//   * every product is mma.sync m16n8k8 TF32 on register fragments whose
//     layout the PTX ISA fixes, so operands are handled per element;
//   * a warp computes a unit of 2 x 2 output tiles (32 x 16), so each A
//     fragment serves two B fragments and the reverse;
//   * each operand element is split into TF32 hi/lo once, when it is
//     loaded, and reused by every MMA of its unit; the next k-step's
//     elements are loaded before this step's MMAs;
//   * the k order inside a k-step is permuted where that turns a lane's
//     two weights into one 8-byte load; the shared-memory row stride
//     (4 mod 32 words) keeps every fragment load free of bank conflicts;
//   * d_pre_i overwrites h_i in place, so the products back through the
//     weights write d_h without waiting for the weight gradients;
//   * the SIMT rest runs one warp per row with shuffle sums (bias and
//     head gradients) and a block reduction (the frame-time cotangent).
// It keeps every hidden activation of its tile (4 x 128 rows) plus the
// cotangents, ~200 KB of shared memory, and re-reads and re-writes its
// gradient partial (221 KB, L2-resident) once per tile.
//
// f32 mode splits each operand into TF32 hi + lo parts and sums lo*hi +
// hi*lo + hi*hi ("3xTF32", error ~2^-21 relative per product); in bf16
// mode every operand is already a bf16 value, exact in TF32, so one TF32
// product is exact and only the f32 accumulation rounds, as on the TPU's
// MXU. Heads, prologue and epilogues run on the FMA pipes.
//
// Determinism: the TPU kernel accumulated parameter gradients across a
// sequential grid into revisited output blocks. GPU blocks run in
// parallel, so the backward runs a persistent grid of G blocks; block g
// walks the tiles g, g + G, g + 2G, ... in order and adds into its own
// private f32 partial of all gradients in device memory, and
// fused_render_reduce_kernel sums the G partials in the fixed order
// g = 0 .. G-1. No atomics: for a given G the gradients are bitwise
// identical from run to run.
//
// compute dtype: with bf16 != 0 the matmul operands (weights, rounded by
// the wrapper; activations, features and cotangents entering a product,
// rounded here) are bfloat16 values and the products accumulate in f32;
// the warp, the trig and all other sums stay f32.
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BN = 64;            // columns (sample x frame) per tile
constexpr int LD = BN + 4;        // shared-memory row stride (WMMA: x4)
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_LAYERS = 16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                             wmma::precision::tf32, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                             wmma::precision::tf32, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float rnd(float x, bool bf16) {
  return bf16 ? round_bf16(x) : x;
}

// acc += a * b. split: 3xTF32 for f32 operands (small terms first);
// otherwise the operands are exact in TF32 (bf16 values) and one product
// is exact. The tensor cores round their f32 sums toward zero, so each
// k-step sums into a fresh fragment and is added to acc in IEEE f32: the
// truncation then stays at a few ulps of one step instead of building up
// along K (and across the backward's tiles).
template <typename FA, typename FB>
__device__ __forceinline__ void mma_f32(FragC& acc, const FA& a,
                                        const FB& b, bool split) {
  FA ah;
  FB bh;
#pragma unroll
  for (int i = 0; i < ah.num_elements; ++i)
    ah.x[i] = wmma::__float_to_tf32(a.x[i]);
#pragma unroll
  for (int i = 0; i < bh.num_elements; ++i)
    bh.x[i] = wmma::__float_to_tf32(b.x[i]);
  FragC step;
  wmma::fill_fragment(step, 0.f);
  if (split) {
    FA al;
    FB bl;
#pragma unroll
    for (int i = 0; i < al.num_elements; ++i)
      al.x[i] = wmma::__float_to_tf32(a.x[i] - ah.x[i]);
#pragma unroll
    for (int i = 0; i < bl.num_elements; ++i)
      bl.x[i] = wmma::__float_to_tf32(b.x[i] - bh.x[i]);
    wmma::mma_sync(step, al, bh, step);
    wmma::mma_sync(step, ah, bl, step);
  }
  wmma::mma_sync(step, ah, bh, step);
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += step.x[i];
}

struct Net {
  int depth, width, feat, feat_pad, do_skip, bf16;
  int in_dim[MAX_LAYERS];   // real input width of layer i
  int in_pad[MAX_LAYERS];   // padded input width (rows of its input)
  int w_off[MAX_LAYERS];    // offset of layer i in the packed weights
  int b_off[MAX_LAYERS];    // offset of layer i in the packed biases
  int n_weights;            // padded weight floats (biases start here)
};

// F is concatenated after layer i (reference fields.py:124)
__device__ __forceinline__ bool skip_after(const Net& net, int i) {
  int skip_layer = net.depth / 2;
  return net.do_skip && i > 0 && skip_layer > 0 && i % skip_layer == 0;
}

// Rows of a layer input: the first `na` rows from `a`, the rest from `b`
// (the skip concatenation [h, F] without a copy). na is a multiple of 16,
// so no 8- or 16-row fragment straddles the two.
struct Rows {
  const float* a;
  int na;
  const float* b;
  __device__ __forceinline__ const float* row(int r) const {
    return r < na ? a + r * LD : b + (r - na) * LD;
  }
};

// Layer product for one tile: warp w computes rows [16w, 16w + 16) of
// W (M x Kp, row-major in device memory) times X (Kp rows x BN, shared
// memory) into acc[0..3] (the four 16-column tiles). Warps past M idle.
// The next k-step's weight fragment is loaded before this step's
// products, to overlap its L2 latency.
__device__ __forceinline__ void layer_product(const float* __restrict__ Wg,
                                              int Kp, int M, const Rows& X,
                                              bool split, FragC acc[4]) {
  const int warp = threadIdx.x / 32;
  if (warp * 16 >= M) return;
  const float* wrow = Wg + (size_t)warp * 16 * Kp;
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  FragA a, a_next;
  wmma::load_matrix_sync(a, wrow, Kp);
  for (int k0 = 0; k0 < Kp; k0 += 8) {
    if (k0 + 8 < Kp) wmma::load_matrix_sync(a_next, wrow + k0 + 8, Kp);
    const float* xrow = X.row(k0);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB b;
      wmma::load_matrix_sync(b, xrow + n * 16, LD);
      mma_f32(acc[n], a, b, split);
    }
    a = a_next;
  }
}

__device__ __forceinline__ void store_product(float* out, int M,
                                              FragC acc[4]) {
  const int warp = threadIdx.x / 32;
  if (warp * 16 >= M) return;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + warp * 16 * LD + n * 16, acc[n], LD,
                            wmma::mem_row_major);
}

// out[m][c] = rnd(relu(out[m][c] + b[m])) for m < M, c < BN
__device__ __forceinline__ void bias_relu(float* out, int M,
                                          const float* __restrict__ b,
                                          bool bf16) {
  for (int idx = threadIdx.x; idx < M * BN; idx += NTHREADS) {
    int m = idx / BN, c = idx % BN;
    out[m * LD + c] = rnd(fmaxf(out[m * LD + c] + b[m], 0.f), bf16);
  }
}

// Velocity warp + positional encoding of one column into rows of `Fs`
// (row stride LD), rounded to the compute dtype; mirrors _prologue
// (reference fused.py:84-121). Returns the validity x domain mask.
__device__ __forceinline__ float prologue(float t, const float* coords,
                                          const float* omega, const float* tg,
                                          const float* smask, int n, int N,
                                          float inv_scale, int deg, bool bf16,
                                          float* Fs, int c) {
  float tM = t + tg[n];
  bool valid = tM >= 0.f;
  float theta = (valid ? tM : 0.f) * omega[n];
  float ct = cosf(theta), st = sinf(theta);
  float x = coords[n], y = coords[N + n], z = coords[2 * N + n];
  float vf = valid ? 1.f : 0.f;
  float w[3];
  w[0] = (ct * x + st * y) * vf * inv_scale;
  w[1] = (ct * y - st * x) * vf * inv_scale;
  w[2] = z * vf * inv_scale;
  for (int j = 0; j < 3; ++j) {
    Fs[j * LD + c] = rnd(w[j], bf16);
    if (deg > 0) {
      float s = sinf(w[j]), co = cosf(w[j]);
      Fs[(3 + j) * LD + c] = rnd(s, bf16);
      Fs[(3 + 3 * deg + j) * LD + c] = rnd(co, bf16);
      for (int i = 1; i < deg; ++i) {
        float s2 = 2.f * s * co, c2 = co * co - s * s;
        s = s2;
        co = c2;
        Fs[(3 + 3 * i + j) * LD + c] = rnd(s, bf16);
        Fs[(3 + 3 * deg + 3 * i + j) * LD + c] = rnd(co, bf16);
      }
    }
  }
  return vf * smask[n];
}

__global__ void __launch_bounds__(NTHREADS)
fused_render_fwd_kernel(const float* __restrict__ t_eff,
                        const float* __restrict__ coords,
                        const float* __restrict__ omega,
                        const float* __restrict__ tg,
                        const float* __restrict__ smask,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ em, float* __restrict__ fstash,
                        int nt, int N, float inv_scale, int deg, Net net) {
  extern __shared__ __align__(128) float smem[];
  const int W = net.width, Fd = net.feat, FP = net.feat_pad, D = net.depth;
  const bool bf16 = net.bf16;
  float* H = smem;                      // rows [0, W): hidden; [W, W+FP): F
  float* Fs = H + W * LD;
  float* mask = H + (W + FP) * LD;      // (BN,)
  const int tid = threadIdx.x;
  const int t = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const size_t cols = (size_t)nt * N;

  for (int idx = tid; idx < (FP - Fd) * BN; idx += NTHREADS)
    Fs[(Fd + idx / BN) * LD + idx % BN] = 0.f;   // padding rows
  if (tid < BN) {
    mask[tid] = prologue(t_eff[t], coords, omega, tg, smask, n0 + tid, N,
                         inv_scale, deg, bf16, Fs, tid);
    if (fstash != nullptr)
      for (int r = 0; r < Fd; ++r)
        fstash[r * cols + (size_t)t * N + n0 + tid] = Fs[r * LD + tid];
  }
  __syncthreads();

  FragC acc[4];
  for (int i = 0; i < D; ++i) {
    Rows in = (i == 0) ? Rows{Fs, FP, nullptr}
                       : Rows{H, net.in_pad[i], nullptr};
    layer_product(w + net.w_off[i], net.in_pad[i], W, in, !bf16, acc);
    __syncthreads();                    // in place: all reads done
    store_product(H, W, acc);
    __syncthreads();
    bias_relu(H, W, bias + net.b_off[i], bf16);
    __syncthreads();
  }

  if (tid < BN) {
    const float* wh = w + net.w_off[D];   // (1, in_pad), padding zero
    float acc_h = 0.f;
    for (int k = 0; k < net.in_dim[D]; ++k)
      acc_h = fmaf(wh[k], H[k * LD + tid], acc_h);
    float out = bias[net.b_off[D]] + acc_h;
    float e = 1.f / (1.f + expf(-(out - 10.f)));
    em[(size_t)t * N + n0 + tid] = e * mask[tid];
  }
}

// ---------------------------------------------------------------------------
// backward: register-fragment mma.sync products
// ---------------------------------------------------------------------------
// 16 warps per block, one block per SM (~200 KB of shared memory): at
// most 128 registers a thread. The shared-memory row stride LD = BN + 4 is
// 4 mod 32 words, which keeps every fragment load below free of bank
// conflicts.
constexpr int BWD_THREADS = 512;
constexpr int BWD_WARPS = BWD_THREADS / 32;

// A warp's unit of output is MT x NT tiles of m16 x n8. The products that
// read weights from L2 take 16 x 32 units, so a tile's 64 columns read
// each weight twice; the weight gradients (operands in shared memory)
// take 32 x 16.
constexpr int WT_MT = 1, WT_NT = 4;
constexpr int WG_MT = 2, WG_NT = 2;

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// One operand element as the MMAs take it, split once when loaded: with
// SPLIT (f32 mode) hi = x rounded to TF32 and lo = the rest rounded to
// TF32; without, x is a bf16 value, which TF32 holds exactly.
template <bool SPLIT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if (SPLIT) {
    hi = tf32_bits(x);
    lo = tf32_bits(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// d = a * b + c, one m16n8k8 TF32 MMA. Fragment layouts (PTX ISA,
// mma.m16n8k8 .tf32), lane = 4 g + q: a = A(g, q), A(g+8, q), A(g, q+4),
// A(g+8, q+4); b = B(q, g), B(q+4, g); c, d = C(g, 2q), C(g, 2q+1),
// C(g+8, 2q), C(g+8, 2q+1).
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2],
                                         const float c[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

struct OpA {
  uint32_t hi[4], lo[4];
};
struct OpB {
  uint32_t hi[2], lo[2];
};

// acc += a * b for one k-step: 3xTF32 (small terms first) with SPLIT,
// else one exact product. The tensor cores round their f32 sums toward
// zero, so the step sums into fresh registers that are added to acc in
// IEEE f32: the truncation stays at a few ulps of one step.
template <bool SPLIT>
__device__ __forceinline__ void mma_step(float acc[4], const OpA& a,
                                         const OpB& b) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (SPLIT) {
    mma_tf32(s, a.lo, b.hi, s);
    mma_tf32(s, a.hi, b.lo, s);
  }
  mma_tf32(s, a.hi, b.hi, s);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += s[j];
}

// acc[m][n] += sum over k-steps ks of A(m, ks) B(n, ks) for one unit.
// lda(m, ks, a) loads the lane's four A elements of m-tile m at k-step
// ks, ldb(n, ks, b) its two B elements. Each element is split once and
// feeds all MT x NT tiles; the next k-step's raw elements are loaded
// before this step's MMAs are issued.
template <bool SPLIT, int MT, int NT, typename LA, typename LB>
__device__ __forceinline__ void unit_product(float acc[MT][NT][4],
                                             int ksteps, LA lda, LB ldb) {
  float ra[MT][4], rb[NT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) lda(m, 0, ra[m]);
#pragma unroll
  for (int n = 0; n < NT; ++n) ldb(n, 0, rb[n]);
  for (int ks = 0; ks < ksteps; ++ks) {
    OpA a[MT];
    OpB b[NT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32<SPLIT>(ra[m][j], a[m].hi[j], a[m].lo[j]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split_tf32<SPLIT>(rb[n][j], b[n].hi[j], b[n].lo[j]);
    if (ks + 1 < ksteps) {
#pragma unroll
      for (int m = 0; m < MT; ++m) lda(m, ks + 1, ra[m]);
#pragma unroll
      for (int n = 0; n < NT; ++n) ldb(n, ks + 1, rb[n]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_step<SPLIT>(acc[m][n], a[m], b[n]);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ void lane_coords(int& g, int& q) {
  const int lane = threadIdx.x % 32;
  g = lane / 4;
  q = lane % 4;
}

// units of MT x NT tiles over an M x N output, M and N multiples of 16
template <int MT, int NT>
__device__ __forceinline__ int n_units(int M, int N) {
  return (M + 16 * MT - 1) / (16 * MT) * (N / (8 * NT));
}

// out (M rows x BN) = rnd(relu(W . X + b)) with W (M x Kp) row-major in
// device memory and X (Kp rows, shared). k-step ks covers k = 8 ks + 2q
// (fragment column q) and 8 ks + 2q + 1 (column q + 4), so a lane's two
// weights of a row are one 8-byte load.
template <bool SPLIT>
__device__ __forceinline__ void recompute_layer(const float* __restrict__ Wg,
                                                int Kp, int M,
                                                const Rows& X,
                                                const float* __restrict__ b,
                                                float* out, bool bf16) {
  constexpr int MT = WT_MT, NT = WT_NT, nu_n = BN / (8 * NT);
  int g, q;
  lane_coords(g, q);
  const int units = n_units<MT, NT>(M, BN);
  for (int u = threadIdx.x / 32; u < units; u += BWD_WARPS) {
    const int m0 = u / nu_n * 16 * MT, c0 = u % nu_n * 8 * NT;
    float acc[MT][NT][4] = {};
    unit_product<SPLIT, MT, NT>(
        acc, Kp / 8,
        [&](int m, int ks, float* a) {
          const int r = m0 + 16 * m + g;
          if (r < M) {
            const float* wr = Wg + (size_t)r * Kp + 8 * ks + 2 * q;
            float2 x0 = __ldg(reinterpret_cast<const float2*>(wr));
            float2 x8 = __ldg(reinterpret_cast<const float2*>(wr + 8 * Kp));
            a[0] = x0.x; a[1] = x8.x; a[2] = x0.y; a[3] = x8.y;
          } else {
            a[0] = a[1] = a[2] = a[3] = 0.f;
          }
        },
        [&](int n, int ks, float* bb) {
          const int k = 8 * ks + 2 * q, c = c0 + 8 * n + g;
          bb[0] = X.row(k)[c];
          bb[1] = X.row(k + 1)[c];
        });
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = m0 + 16 * m + g;
      if (r >= M) continue;
      const float b0 = b[r], b8 = b[r + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = c0 + 8 * n + 2 * q;
        const float* v = acc[m][n];
        *reinterpret_cast<float2*>(out + r * LD + c) =
            make_float2(rnd(fmaxf(v[0] + b0, 0.f), bf16),
                        rnd(fmaxf(v[1] + b0, 0.f), bf16));
        *reinterpret_cast<float2*>(out + (r + 8) * LD + c) =
            make_float2(rnd(fmaxf(v[2] + b8, 0.f), bf16),
                        rnd(fmaxf(v[3] + b8, 0.f), bf16));
      }
    }
  }
}

// Unit u of dW (M x Kp, row-major in this block's partial at pw) +=
// d_pre (M rows x BN, shared) . X^T (X: Kp rows, shared). The partial's
// old values are loaded before the products and added after them, so
// their latency overlaps the MMAs.
template <bool SPLIT>
__device__ __forceinline__ void weight_grad_unit(int u, float* __restrict__ pw,
                                                 int Kp, int M,
                                                 const float* dpre,
                                                 const Rows& X) {
  constexpr int MT = WG_MT, NT = WG_NT;
  int g, q;
  lane_coords(g, q);
  const int nu_n = Kp / (8 * NT);
  const int m0 = u / nu_n * 16 * MT, k0 = u % nu_n * 8 * NT;
  float2 old[MT][NT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = m0 + 16 * m + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* p = pw + (size_t)r * Kp + k0 + 8 * n + 2 * q;
      old[m][n][0] = r < M ? *reinterpret_cast<const float2*>(p)
                           : make_float2(0.f, 0.f);
      old[m][n][1] = r < M ? *reinterpret_cast<const float2*>(p + 8 * Kp)
                           : make_float2(0.f, 0.f);
    }
  }
  float acc[MT][NT][4] = {};
  unit_product<SPLIT, MT, NT>(
      acc, BN / 8,
      [&](int m, int ks, float* a) {
        const int r = m0 + 16 * m + g, c = 8 * ks + q;
        if (r < M) {
          const float* d0 = dpre + r * LD + c;
          a[0] = d0[0]; a[1] = d0[8 * LD]; a[2] = d0[4];
          a[3] = d0[8 * LD + 4];
        } else {
          a[0] = a[1] = a[2] = a[3] = 0.f;
        }
      },
      [&](int n, int ks, float* bb) {
        const float* xr = X.row(k0 + 8 * n + g) + 8 * ks + q;
        bb[0] = xr[0];
        bb[1] = xr[4];
      });
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = m0 + 16 * m + g;
    if (r >= M) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* p = pw + (size_t)r * Kp + k0 + 8 * n + 2 * q;
      const float* v = acc[m][n];
      *reinterpret_cast<float2*>(p) =
          make_float2(old[m][n][0].x + v[0], old[m][n][0].y + v[1]);
      *reinterpret_cast<float2*>(p + 8 * Kp) =
          make_float2(old[m][n][1].x + v[2], old[m][n][1].y + v[3]);
    }
  }
}

// Unit u of dst (Kp rows x BN, shared) = W^T . d_pre, or dst += it with
// `add`: W (M x Kp) row-major in device memory read transposed, A(k, o) =
// W[o][k]; d_pre (M rows, shared). k-step ks covers o = 8 ks + 2q and
// 8 ks + 2q + 1, as in recompute_layer.
template <bool SPLIT>
__device__ __forceinline__ void back_unit(int u, const float* __restrict__ Wg,
                                          int Kp, int M, const float* dpre,
                                          float* dst, bool add) {
  constexpr int MT = WT_MT, NT = WT_NT, nu_n = BN / (8 * NT);
  int g, q;
  lane_coords(g, q);
  const int m0 = u / nu_n * 16 * MT, c0 = u % nu_n * 8 * NT;
  float acc[MT][NT][4] = {};
  unit_product<SPLIT, MT, NT>(
      acc, M / 8,
      [&](int m, int ks, float* a) {
        const int r = m0 + 16 * m + g;
        if (r < Kp) {
          const float* wo = Wg + (size_t)(8 * ks + 2 * q) * Kp + r;
          a[0] = __ldg(wo);
          a[1] = __ldg(wo + 8);
          a[2] = __ldg(wo + Kp);
          a[3] = __ldg(wo + Kp + 8);
        } else {
          a[0] = a[1] = a[2] = a[3] = 0.f;
        }
      },
      [&](int n, int ks, float* bb) {
        const float* d0 = dpre + (8 * ks + 2 * q) * LD + c0 + 8 * n + g;
        bb[0] = d0[0];
        bb[1] = d0[LD];
      });
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = m0 + 16 * m + g;
    if (r >= Kp) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = c0 + 8 * n + 2 * q;
      float2* d0 = reinterpret_cast<float2*>(dst + r * LD + c);
      float2* d8 = reinterpret_cast<float2*>(dst + (r + 8) * LD + c);
      const float* v = acc[m][n];
      float2 o0 = make_float2(v[0], v[1]), o8 = make_float2(v[2], v[3]);
      if (add) {
        o0.x += d0->x; o0.y += d0->y;
        o8.x += d8->x; o8.y += d8->y;
      }
      *d0 = o0;
      *d8 = o8;
    }
  }
}

// A measurement build (-DBWD_PHASE_TIMERS) sums, per block, the clock
// cycles thread 0 sees between the barriers that close each phase of a
// tile: 0 feature load, 1 recompute, 2 head, 3 masks and bias sums,
// 4 weight gradients and products back, 5 frame-time cotangent.
#ifdef BWD_PHASE_TIMERS
constexpr int N_PHASES = 6;
constexpr int MAX_TIMED_BLOCKS = 1024;
__device__ long long bwd_phase_cycles[MAX_TIMED_BLOCKS * N_PHASES];
#define BWD_PHASE(k)                        \
  if (tid == 0) {                           \
    const long long now = clock64();        \
    phase_cycles[k] += now - stamp;         \
    stamp = now;                            \
  }
#else
#define BWD_PHASE(k)
#endif

// input rows of layer i: F for layer 0, else h_{i-1} (+ F after a skip)
__device__ __forceinline__ Rows layer_input(const Net& net, int i,
                                                const float* acts,
                                                const float* Fs) {
  if (i == 0) return Rows{Fs, net.feat_pad, nullptr};
  return Rows{acts + (size_t)(i - 1) * net.width * LD, net.width,
                  skip_after(net, i - 1) ? Fs : nullptr};
}

template <bool BF16>
__global__ void __launch_bounds__(BWD_THREADS, 1)
fused_render_bwd_kernel(const float* __restrict__ g_em,
                        const float* __restrict__ em,
                        const float* __restrict__ fstash,
                        const float* __restrict__ omega,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ partial, int stride,
                        float* __restrict__ dt_partial, int nt, int N,
                        int deg, int want_dt, Net net) {
  constexpr bool SPLIT = !BF16;
  extern __shared__ __align__(128) float smem[];
  const int W = net.width, Fd = net.feat, FP = net.feat_pad, D = net.depth;
  float* acts = smem;                    // D x (W rows): h_i, overwritten
                                         // by d_pre_i on the way back
  float* Fs = acts + D * W * LD;        // FP rows
  float* dh = Fs + FP * LD;             // (W + FP) rows
  float* dF = dh + (W + FP) * LD;       // FP rows
  float* vec = dF + FP * LD;            // BN
  // this block's bias gradients (b_off order) and then the head's weight
  // gradients, summed over its tiles here and written once at the end:
  // a per-tile read-modify-write of the partial in device memory would
  // wait on L2 for every row
  float* gacc = vec + BN;
  const int n_bias = net.b_off[D] + 1;
  const int n_gacc = n_bias + net.in_dim[D];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int n_stiles = N / BN;
  const int n_tiles = n_stiles * nt;
  const size_t cols = (size_t)nt * N;
  float* part = partial + (size_t)blockIdx.x * stride;
  float* dbp = part + net.n_weights;
  for (int idx = tid; idx < n_gacc; idx += BWD_THREADS) gacc[idx] = 0.f;
  // thread 0's frame-time sum of the current frame: a block's tiles run
  // in frame order, so each frame is written to dt_partial once
  int dt_frame = -1;
  float dt_sum = 0.f;
#ifdef BWD_PHASE_TIMERS
  long long phase_cycles[N_PHASES] = {}, stamp = clock64();
#endif

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t = tile / n_stiles;
    const int n0 = (tile % n_stiles) * BN;
    const size_t col0 = (size_t)t * N + n0;

    // stashed features (already in the compute dtype, padding rows 0)
    // and the head cotangent d_out = g * em * (1 - em)
    for (int idx = tid; idx < FP * BN; idx += BWD_THREADS) {
      int r = idx / BN, c = idx % BN;
      Fs[r * LD + c] = r < Fd ? fstash[r * cols + col0 + c] : 0.f;
      dF[r * LD + c] = 0.f;
    }
    if (tid < BN) {
      float e = em[col0 + tid];
      vec[tid] = rnd(g_em[col0 + tid] * e * (1.f - e), BF16);
    }
    __syncthreads();
    BWD_PHASE(0);

    // recompute the hidden activations
    for (int i = 0; i < D; ++i) {
      recompute_layer<SPLIT>(w + net.w_off[i], net.in_pad[i], W,
                             layer_input(net, i, acts, Fs),
                             bias + net.b_off[i], acts + i * W * LD, BF16);
      __syncthreads();
      BWD_PHASE(1);
    }

    // head: dW_D and db_D as warp sums over the columns, d_h = W_D^T d_out
    {
      const int Kp = net.in_pad[D];
      const Rows in = layer_input(net, D, acts, Fs);
      const float* wh = w + net.w_off[D];   // (1, Kp), padding zero
      for (int k = warp; k < net.in_dim[D]; k += BWD_WARPS) {
        const float* r = in.row(k);
        float s = 0.f;
        for (int c = lane; c < BN; c += 32) s = fmaf(vec[c], r[c], s);
        s = warp_sum(s);
        if (lane == 0) gacc[n_bias + k] += s;
      }
      if (warp == BWD_WARPS - 1) {
        float s = 0.f;
        for (int c = lane; c < BN; c += 32) s += vec[c];
        s = warp_sum(s);
        if (lane == 0) gacc[net.b_off[D]] += s;
      }
      for (int idx = tid; idx < Kp * BN; idx += BWD_THREADS) {
        int k = idx / BN, c = idx % BN;
        dh[k * LD + c] = wh[k] * vec[c];
      }
      __syncthreads();
      BWD_PHASE(2);
    }

    for (int i = D - 1; i >= 0; --i) {
      // one warp per row: d_pre = rnd(relu'(h_i) * d_h) into h_i's rows,
      // its row sum (db_i) as a warp sum, and the skip cotangent (rows
      // [W, W + FP) of d_h belong to F) onto dF
      const bool split_f = skip_after(net, i) && want_dt;
      float* h = acts + i * W * LD;
      const int rows = split_f && FP > W ? FP : W;
      for (int o = warp; o < rows; o += BWD_WARPS) {
        float s = 0.f;
        for (int c = lane; c < BN; c += 32) {
          if (split_f && o < FP) dF[o * LD + c] += dh[(W + o) * LD + c];
          if (o < W) {
            const float d = h[o * LD + c] > 0.f
                                ? rnd(dh[o * LD + c], BF16) : 0.f;
            h[o * LD + c] = d;
            s += d;
          }
        }
        if (o < W) {
          s = warp_sum(s);
          if (lane == 0) gacc[net.b_off[i] + o] += s;
        }
      }
      __syncthreads();
      BWD_PHASE(3);

      // dW_i += d_pre . in^T into this block's partial, and d_h (Kp rows)
      // = W_i^T d_pre; layer 0 adds onto dF (the skip branch) when
      // want_dt. Neither reads what the other writes, so their units form
      // one list dealt round-robin to the warps, the longer units of the
      // products back through the weights first.
      const int Kp = net.in_pad[i];
      const Rows in = layer_input(net, i, acts, Fs);
      const int n_back =
          i > 0 || want_dt ? n_units<WT_MT, WT_NT>(Kp, BN) : 0;
      const int n_all = n_back + n_units<WG_MT, WG_NT>(W, Kp);
      for (int u = warp; u < n_all; u += BWD_WARPS) {
        if (u < n_back)
          back_unit<SPLIT>(u, w + net.w_off[i], Kp, W, h, i > 0 ? dh : dF,
                           i == 0);
        else
          weight_grad_unit<SPLIT>(u - n_back, part + net.w_off[i], Kp, W, h,
                                  in);
      }
      __syncthreads();
      BWD_PHASE(4);
    }

    // frame-time cotangent: posenc chain, then d theta = dw . (wy, -wx, 0),
    // summed over the tile as a block reduction
    if (want_dt) {
      float v = 0.f;
      if (tid < BN) {
        const int c = tid;
        float dw[3];
        for (int j = 0; j < 3; ++j) dw[j] = dF[j * LD + c];
        float p2 = 1.f;
        for (int i = 0; i < deg; ++i) {
          for (int j = 0; j < 3; ++j) {
            float s = Fs[(3 + 3 * i + j) * LD + c];
            float co = Fs[(3 + 3 * deg + 3 * i + j) * LD + c];
            float ds = dF[(3 + 3 * i + j) * LD + c];
            float dc = dF[(3 + 3 * deg + 3 * i + j) * LD + c];
            dw[j] = dw[j] + p2 * (ds * co - dc * s);
          }
          p2 *= 2.f;
        }
        float dtheta = dw[0] * Fs[1 * LD + c] - dw[1] * Fs[0 * LD + c];
        v = dtheta * omega[n0 + c];
      }
      v = warp_sum(v);
      if (lane == 0) vec[warp] = v;     // d_out is no longer read
      __syncthreads();
      if (tid == 0) {
        float s = 0.f;
        for (int k = 0; k < BWD_WARPS; ++k) s += vec[k];
        if (t != dt_frame) {
          if (dt_frame >= 0)
            dt_partial[(size_t)blockIdx.x * nt + dt_frame] = dt_sum;
          dt_frame = t;
          dt_sum = 0.f;
        }
        dt_sum += s;
      }
    }
    __syncthreads();
    BWD_PHASE(5);
  }
  for (int idx = tid; idx < n_gacc; idx += BWD_THREADS) {
    if (idx < n_bias)
      dbp[idx] = gacc[idx];
    else
      part[net.w_off[D] + idx - n_bias] = gacc[idx];
  }
  if (tid == 0 && dt_frame >= 0)
    dt_partial[(size_t)blockIdx.x * nt + dt_frame] = dt_sum;
#ifdef BWD_PHASE_TIMERS
  if (tid == 0)
    for (int k = 0; k < N_PHASES; ++k)
      bwd_phase_cycles[blockIdx.x * N_PHASES + k] = phase_cycles[k];
#endif
}

// out[p] = sum_{g < G} partial[g * stride + p] for p < P, in the fixed
// order g = 0..G-1.
__global__ void fused_render_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out, int G,
                                           int P, int stride) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += partial[(size_t)g * stride + p];
  out[p] = s;
}

int pad16(int x) { return (x + 15) / 16 * 16; }

Net make_net(int depth, int width, int feat, int do_skip, int bf16) {
  Net net{};
  net.depth = depth;
  net.width = width;
  net.feat = feat;
  net.feat_pad = pad16(feat);
  net.do_skip = do_skip;
  net.bf16 = bf16;
  int skip_layer = depth / 2;
  int dim = feat, dim_pad = net.feat_pad, w_off = 0, b_off = 0;
  for (int i = 0; i <= depth; ++i) {
    int out = i < depth ? width : 1;
    net.in_dim[i] = dim;
    net.in_pad[i] = dim_pad;
    net.w_off[i] = w_off;
    net.b_off[i] = b_off;
    w_off += dim_pad * out;
    b_off += out;
    dim = dim_pad = width;
    if (do_skip && i > 0 && skip_layer > 0 && i % skip_layer == 0) {
      dim += feat;
      dim_pad += net.feat_pad;
    }
  }
  net.n_weights = w_off;
  return net;
}

// the forward's 16-row weight tiles, one per warp; the backward is
// bounded by its shared memory only (fused_render_bwd_smem)
bool supported(int depth, int width) {
  return depth >= 1 && depth + 1 <= MAX_LAYERS && width % 16 == 0 &&
         width <= 16 * NWARPS;
}

}  // namespace

extern "C" {

int fused_render_tile() { return BN; }

// packed parameter floats: padded weights, then biases
int fused_render_n_params(int depth, int width, int feat, int do_skip) {
  Net net = make_net(depth, width, feat, do_skip, 0);
  return net.n_weights + net.b_off[depth] + 1;
}

#ifdef BWD_PHASE_TIMERS
// the phase cycles of the last launch: (blocks, N_PHASES) into host memory
int fused_render_bwd_phases(long long* out, int blocks) {
  if (blocks > MAX_TIMED_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, bwd_phase_cycles,
                                   sizeof(long long) * blocks * N_PHASES);
}
#endif

size_t fused_render_bwd_smem(int depth, int width, int feat) {
  size_t fp = pad16(feat);
  // rows of activations and cotangents, then vec (BN) and the block's
  // bias and head gradients (depth * width + 1 + at most width + fp)
  return sizeof(float) * (((size_t)depth * width + fp + width + fp + fp) *
                              LD + BN + depth * width + 1 + width + fp);
}

int fused_render_fwd(const float* t_eff, const float* coords,
                     const float* omega, const float* tg, const float* smask,
                     const float* w, const float* bias, float* em,
                     float* fstash, int nt, int N, int depth, int width,
                     int feat, int do_skip, int deg, float inv_scale,
                     int bf16, void* stream) {
  if (!supported(depth, width) || N % BN != 0)
    return (int)cudaErrorInvalidValue;
  Net net = make_net(depth, width, feat, do_skip, bf16);
  size_t smem = sizeof(float) * ((size_t)(width + net.feat_pad) * LD + BN);
  cudaError_t err = cudaFuncSetAttribute(
      fused_render_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / BN, nt);
  fused_render_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      t_eff, coords, omega, tg, smask, w, bias, em, fstash, nt, N,
      inv_scale, deg, net);
  return (int)cudaGetLastError();
}

// partial: (grid, stride) floats, zeroed, stride >= n_params and a
// multiple of 8 (aligned rows for the 8-byte loads and stores).
int fused_render_bwd(const float* g_em, const float* em, const float* fstash,
                     const float* omega, const float* w, const float* bias,
                     float* partial, int stride, float* dt_partial,
                     float* grads, float* d_t, int nt, int N, int depth,
                     int width, int feat, int do_skip, int deg, int bf16,
                     int want_dt, int grid, void* stream) {
  Net net = make_net(depth, width, feat, do_skip, bf16);
  int n_params = net.n_weights + net.b_off[depth] + 1;
  if (!supported(depth, width) || N % BN != 0 || grid < 1 ||
      stride % 8 != 0 || stride < n_params)
    return (int)cudaErrorInvalidValue;
  size_t smem = fused_render_bwd_smem(depth, width, feat);
  auto kernel = bf16 ? fused_render_bwd_kernel<true>
                     : fused_render_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, BWD_THREADS, smem, s>>>(
      g_em, em, fstash, omega, w, bias, partial, stride, dt_partial, nt, N,
      deg, want_dt, net);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_render_reduce_kernel<<<(n_params + 255) / 256, 256, 0, s>>>(
      partial, grads, grid, n_params, stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_render_reduce_kernel<<<1, 256, 0, s>>>(dt_partial, d_t, grid, nt,
                                               nt);
  return (int)cudaGetLastError();
}

}  // extern "C"
