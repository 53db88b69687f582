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
// What bounds them on this card: the matmul chain, ~109 kFLOP per column
// forward and ~3x that backward. Device-memory traffic is small by
// design: activations never leave shared memory, and a column reads 5
// floats and writes 1 (plus feat floats of stash). So every activation of
// a 64-column tile stays in shared memory and the products run on the
// tensor cores (WMMA m16n16k8 TF32, one 16-row weight tile per warp,
// fragments straight from the L2-resident weights and from shared
// memory). f32 mode splits each operand into TF32 hi + lo parts and sums
// lo*hi + hi*lo + hi*hi ("3xTF32", error ~2^-21 relative per product);
// in bf16 mode every operand is already a bf16 value, exact in TF32, so
// one TF32 product is exact and only the f32 accumulation rounds, as on
// the TPU's MXU. Heads, prologue and epilogues run on the FMA pipes. The
// backward keeps every hidden activation of its tile (4 x 128 rows) plus
// the cotangents, ~200 KB of shared memory, so it runs one 256-thread
// block per SM, and re-reads and re-writes its gradient partial (221 KB,
// L2-resident) once per tile. With 8 warps per SM its products issue far
// below the tensor-core rate (fragment loads, TF32 conversions and the
// per-step f32 adds wait on each other): the backward is latency-bound.
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
constexpr int MAX_BACK_TILES = 5; // 16x16 tiles per warp of W^T d_pre

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                             wmma::precision::tf32, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                              wmma::precision::tf32, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                             wmma::precision::tf32, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                              wmma::precision::tf32, wmma::col_major>;
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

__global__ void __launch_bounds__(NTHREADS)
fused_render_bwd_kernel(const float* __restrict__ g_em,
                        const float* __restrict__ em,
                        const float* __restrict__ fstash,
                        const float* __restrict__ omega,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ partial, int stride,
                        float* __restrict__ dt_partial, int nt, int N,
                        int deg, int want_dt, Net net) {
  extern __shared__ __align__(128) float smem[];
  const int W = net.width, Fd = net.feat, FP = net.feat_pad, D = net.depth;
  const bool bf16 = net.bf16;
  const bool split = !bf16;
  float* acts = smem;                    // D x (W rows)
  float* Fs = acts + D * W * LD;         // FP rows
  float* dh = Fs + FP * LD;              // (W + FP) rows; rows [0, W)
                                         // hold d_pre once masked
  float* dF = dh + (W + FP) * LD;        // FP rows
  float* vec = dF + FP * LD;             // BN
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n_stiles = N / BN;
  const int n_tiles = n_stiles * nt;
  const size_t cols = (size_t)nt * N;
  float* part = partial + (size_t)blockIdx.x * stride;
  float* dbp = part + net.n_weights;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t = tile / n_stiles;
    const int n0 = (tile % n_stiles) * BN;
    const size_t col0 = (size_t)t * N + n0;

    // stashed features (already in the compute dtype, padding rows 0)
    // and the head cotangent d_out = g * em * (1 - em)
    for (int idx = tid; idx < FP * BN; idx += NTHREADS) {
      int r = idx / BN, c = idx % BN;
      Fs[r * LD + c] = r < Fd ? fstash[r * cols + col0 + c] : 0.f;
      dF[r * LD + c] = 0.f;
    }
    if (tid < BN) {
      float e = em[col0 + tid];
      vec[tid] = rnd(g_em[col0 + tid] * e * (1.f - e), bf16);
    }
    __syncthreads();

    // recompute the hidden activations
    for (int i = 0; i < D; ++i) {
      Rows in = (i == 0) ? Rows{Fs, FP, nullptr}
                         : Rows{acts + (i - 1) * W * LD, W,
                                skip_after(net, i - 1) ? Fs : nullptr};
      float* out = acts + i * W * LD;
      FragC acc[4];
      layer_product(w + net.w_off[i], net.in_pad[i], W, in, split, acc);
      store_product(out, W, acc);
      __syncthreads();
      bias_relu(out, W, bias + net.b_off[i], bf16);
      __syncthreads();
    }

    // head: dW_D, db_D, and d_h = W_D^T d_out
    {
      const int Kp = net.in_pad[D];
      Rows in{acts + (D - 1) * W * LD, W,
              skip_after(net, D - 1) ? Fs : nullptr};
      const float* wh = w + net.w_off[D];   // (1, Kp), padding zero
      for (int k = tid; k < net.in_dim[D]; k += NTHREADS) {
        const float* r = in.row(k);
        float s = 0.f;
        for (int c = 0; c < BN; ++c) s = fmaf(vec[c], r[c], s);
        part[net.w_off[D] + k] += s;
      }
      if (tid == 0) {
        float s = 0.f;
        for (int c = 0; c < BN; ++c) s += vec[c];
        dbp[net.b_off[D]] += s;
      }
      for (int idx = tid; idx < Kp * BN; idx += NTHREADS) {
        int k = idx / BN, c = idx % BN;
        dh[k * LD + c] = wh[k] * vec[c];
      }
      __syncthreads();
    }

    for (int i = D - 1; i >= 0; --i) {
      // split the skip cotangent (rows [W, W+FP) of d_h belong to F), and
      // d_pre = relu'(h_i) * d_h, rounded, in place in rows [0, W)
      const bool split_f = skip_after(net, i) && want_dt;
      const float* h = acts + i * W * LD;
      for (int idx = tid; idx < W * BN; idx += NTHREADS) {
        int o = idx / BN, c = idx % BN;
        if (split_f && o < FP) dF[o * LD + c] += dh[(W + o) * LD + c];
        dh[o * LD + c] = h[o * LD + c] > 0.f ? rnd(dh[o * LD + c], bf16)
                                             : 0.f;
      }
      // feature rows past the width (narrow MLPs): rows disjoint from
      // those the loop above reads and writes
      if (split_f && FP > W)
        for (int idx = tid; idx < (FP - W) * BN; idx += NTHREADS) {
          int o = W + idx / BN, c = idx % BN;
          dF[o * LD + c] += dh[(W + o) * LD + c];
        }
      __syncthreads();

      const int Kp = net.in_pad[i];
      Rows in = (i == 0) ? Rows{Fs, FP, nullptr}
                         : Rows{acts + (i - 1) * W * LD, W,
                                skip_after(net, i - 1) ? Fs : nullptr};
      // dW_i (W x Kp) += d_pre (W x BN) . in^T (BN x Kp), into this
      // block's partial: warp w owns rows [16w, 16w + 16)
      if (warp * 16 < W) {
        float* pw = part + net.w_off[i] + (size_t)warp * 16 * Kp;
        for (int k0 = 0; k0 < Kp; k0 += 16) {
          FragC acc;
          wmma::load_matrix_sync(acc, pw + k0, Kp, wmma::mem_row_major);
          const float* xr = in.row(k0);
          for (int c0 = 0; c0 < BN; c0 += 8) {
            FragA a;
            FragBt b;
            wmma::load_matrix_sync(a, dh + warp * 16 * LD + c0, LD);
            wmma::load_matrix_sync(b, xr + c0, LD);
            mma_f32(acc, a, b, split);
          }
          wmma::store_matrix_sync(pw + k0, acc, Kp, wmma::mem_row_major);
        }
      }
      for (int o = tid; o < W; o += NTHREADS) {
        float s = 0.f;
        for (int c = 0; c < BN; ++c) s += dh[o * LD + c];
        dbp[net.b_off[i] + o] += s;
      }
      // d_h (Kp rows) = W_i^T d_pre, in 16x16 tiles dealt round-robin to
      // the warps; A(m = k, kk = o) = W_i[o][k] is W_i read column-major.
      // Layer 0 adds onto dF (the skip branch) when want_dt.
      if (i > 0 || want_dt) {
        float* dst = i > 0 ? dh : dF;
        const int n_tiles_h = (Kp / 16) * 4;
        // warp w owns column tile w % 4 and row tiles w / 4 + 2j, so
        // each k-step loads one d_pre fragment and up to MAX_BACK_TILES
        // independent weight fragments
        FragC acc[MAX_BACK_TILES];
        const int nc = warp % 4;
#pragma unroll
        for (int j = 0; j < MAX_BACK_TILES; ++j) {
          const int tt = warp + NWARPS * j;
          if (tt >= n_tiles_h) continue;
          if (i > 0)
            wmma::fill_fragment(acc[j], 0.f);
          else
            wmma::load_matrix_sync(acc[j], dF + (tt / 4) * 16 * LD + nc * 16,
                                   LD, wmma::mem_row_major);
        }
        for (int k0 = 0; k0 < W; k0 += 8) {
          FragB b;
          wmma::load_matrix_sync(b, dh + k0 * LD + nc * 16, LD);
          const float* wk = w + net.w_off[i] + (size_t)k0 * Kp;
#pragma unroll
          for (int j = 0; j < MAX_BACK_TILES; ++j) {
            const int tt = warp + NWARPS * j;
            if (tt >= n_tiles_h) continue;
            FragAt a;
            wmma::load_matrix_sync(a, wk + (tt / 4) * 16, Kp);
            mma_f32(acc[j], a, b, split);
          }
        }
        __syncthreads();                // all reads of d_pre done
#pragma unroll
        for (int j = 0; j < MAX_BACK_TILES; ++j) {
          const int tt = warp + NWARPS * j;
          if (tt < n_tiles_h)
            wmma::store_matrix_sync(dst + (tt / 4) * 16 * LD + nc * 16,
                                    acc[j], LD, wmma::mem_row_major);
        }
      }
      __syncthreads();
    }

    // frame-time cotangent: posenc chain, then d theta = dw . (wy, -wx, 0)
    if (want_dt) {
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
        vec[c] = dtheta * omega[n0 + c];
      }
      __syncthreads();
      if (tid == 0) {
        float s = 0.f;
        for (int c = 0; c < BN; ++c) s += vec[c];
        dt_partial[(size_t)blockIdx.x * nt + t] += s;
      }
    }
    __syncthreads();
  }
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

// 16-row weight tiles, one per warp; at most MAX_BACK_TILES tiles of
// W^T d_pre per warp
bool supported(int depth, int width, int feat) {
  return depth >= 1 && depth + 1 <= MAX_LAYERS && width % 16 == 0 &&
         width <= 16 * NWARPS &&
         ((width + pad16(feat)) / 16) * 4 <= MAX_BACK_TILES * NWARPS;
}

}  // namespace

extern "C" {

int fused_render_tile() { return BN; }

// packed parameter floats: padded weights, then biases
int fused_render_n_params(int depth, int width, int feat, int do_skip) {
  Net net = make_net(depth, width, feat, do_skip, 0);
  return net.n_weights + net.b_off[depth] + 1;
}

size_t fused_render_bwd_smem(int depth, int width, int feat) {
  size_t fp = pad16(feat);
  return sizeof(float) * ((size_t)depth * width * LD + fp * LD +
                          (width + fp) * LD + fp * LD + BN);
}

int fused_render_fwd(const float* t_eff, const float* coords,
                     const float* omega, const float* tg, const float* smask,
                     const float* w, const float* bias, float* em,
                     float* fstash, int nt, int N, int depth, int width,
                     int feat, int do_skip, int deg, float inv_scale,
                     int bf16, void* stream) {
  if (!supported(depth, width, feat) || N % BN != 0)
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
// multiple of 8 (32-byte aligned rows for the WMMA loads and stores).
int fused_render_bwd(const float* g_em, const float* em, const float* fstash,
                     const float* omega, const float* w, const float* bias,
                     float* partial, int stride, float* dt_partial,
                     float* grads, float* d_t, int nt, int N, int depth,
                     int width, int feat, int do_skip, int deg, int bf16,
                     int want_dt, int grid, void* stream) {
  Net net = make_net(depth, width, feat, do_skip, bf16);
  int n_params = net.n_weights + net.b_off[depth] + 1;
  if (!supported(depth, width, feat) || N % BN != 0 || grid < 1 ||
      stride % 8 != 0 || stride < n_params)
    return (int)cudaErrorInvalidValue;
  size_t smem = fused_render_bwd_smem(depth, width, feat);
  cudaError_t err = cudaFuncSetAttribute(
      fused_render_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fused_render_bwd_kernel<<<grid, NTHREADS, smem, s>>>(
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
