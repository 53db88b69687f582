// Fused NeRF render kernels for Hopper (sm_90a): forward and backward.
//
// Replaces the two Pallas TPU kernels of bhnerf_tpu/ops/fused.py:
//   * fused_render_fwd_kernel  <- _fwd_kernel (fused.py:169), launched by
//     _render_fwd (fused.py:381-415)
//   * fused_render_bwd_kernel  <- _bwd_kernel (fused.py:198), launched by
//     _render_bwd (fused.py:418-459); fused_render_reduce_kernel sums the
//     backward's per-block partials.
//
// Per (sample, frame) column the kernels run the whole pipeline on chip:
// velocity warp (rotation about z by -Omega * max(t - t_inj, 0)), the
// positional encoding [w | sin 2^i w | cos 2^i w] by the double-angle
// recursion from one sin/cos, the MLP (ReLU, the encoded features F
// concatenated after layer net_depth//2, a one-wide head), sigmoid(x - 10)
// and the validity/domain mask. Layouts follow the PyTorch wrapper
// (bhnerf_tpu_torch/ops/fused.py): per-sample rows (N,), emission (nt, N),
// the stashed features F (feat, nt*N) and hidden activations (depth,
// width, nt*N), each with column t*N + n. Weights arrive as nn.Linear's
// (out, in) matrices with `in` zero-padded to a multiple of 16 (the
// feature rows F to FP = roundup16(feat)), packed layer after layer;
// gradients come back in the same padded layout followed by the biases.
//
// What bounds them on this card: the matmul chain. A column reads 5
// floats and writes 1; in a training step the forward also stashes, for
// the backward, the features (feat floats a column) and every hidden
// activation (depth x width floats, 2 KB at 4x128), and the backward reads
// both once.
//
// Forward: ~109 kFLOP per column, 134 GFLOP of TF32 per training step in
// f32 mode: 0.27 ms at 495 TFLOP/s against 3.5 MB of device-memory
// traffic, so it is compute-bound too. Every activation of a 128-column
// tile stays in shared memory; the products are mma.sync m16n8k8 TF32 on
// register fragments, a 32 x 32 unit per warp, with the weights staged
// through shared memory ahead of use (see the forward section below).
// The activation stash is stored from the accumulator registers in the
// pass that writes shared memory: 840 MB at the training step's 410,112
// columns, 0.25 ms of the card's 3.35 TB/s beside 0.27 ms of products.
//
// Backward from the stash: ~214 kFLOP per column (weight gradients 109k,
// products back through the weights 104k; 4x128, 21 features). At the
// training step's 410,112 columns that is 88 GFLOP, 263 GFLOP of TF32 in
// f32 mode (3 products each): 0.53 ms at 495 TFLOP/s, against ~970 MB of
// device-memory traffic (0.29 ms; the stash 840 MB of it, read once). So
// it is compute-bound, and the design serves the tensor cores:
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
// gradient partial (221 KB, L2-resident) once per tile. A tile's
// activations arrive from the stash as 16-byte cp.async copies (131 KB,
// issued with the feature load) under an evict-first L2 policy, so the
// stream does not push the partials out of L2.
//
// The TPU kernel kept only F and the emission for its backward and
// recomputed the four hidden layers per tile (another 109 kFLOP a column,
// the forward's products again, here with each weight read from L2 twice
// per 64 columns), trading work for a TPU core's memory. This card has
// 80 GB at 3.35 TB/s, so the wrapper stashes whenever the activations fit
// in a fixed eighth of the card's memory (every training shape of the
// port, up to 5.2 GB), and only above that passes a null stash, which
// makes this kernel recompute them as the TPU's did.
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

namespace {

constexpr int BN = 64;            // backward: columns (sample x frame) per tile
constexpr int LD = BN + 4;        // its shared-memory row stride, 4 mod 32 words
constexpr int MAX_LAYERS = 16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float rnd(float x, bool bf16) {
  return bf16 ? round_bf16(x) : x;
}

struct Net {
  int depth, width, feat, feat_pad, do_skip, bf16;
  int in_dim[MAX_LAYERS];   // real input width of layer i
  int in_pad[MAX_LAYERS];   // padded input width (rows of its input)
  int w_off[MAX_LAYERS];    // offset of layer i in the packed weights
  int b_off[MAX_LAYERS];    // offset of layer i in the packed biases
  int n_weights;            // padded weight floats (biases start here)
  int wf_off[MAX_LAYERS];   // offset of hidden layer i in the forward's
                            // fragment-ordered weights
  int n_wf;                 // floats of those
};

// F is concatenated after layer i (reference fields.py:124)
__device__ __forceinline__ bool skip_after(const Net& net, int i) {
  int skip_layer = net.depth / 2;
  return net.do_skip && i > 0 && skip_layer > 0 && i % skip_layer == 0;
}

// Rows of a layer input: the first `na` rows from `a`, the rest from `b`
// (the skip concatenation [h, F] without a copy). na is a multiple of 16,
// so no 8- or 16-row fragment straddles the two.
template <int STRIDE>
struct RowsT {
  const float* a;
  int na;
  const float* b;
  __device__ __forceinline__ const float* row(int r) const {
    return r < na ? a + r * STRIDE : b + (r - na) * STRIDE;
  }
};
using Rows = RowsT<LD>;

// ---------------------------------------------------------------------------
// products on register fragments (both kernels)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// One operand element as the MMAs take it, split once when loaded: with
// SPLIT (f32 mode) hi = x rounded to TF32 and lo = the rest rounded to
// TF32; without, x is a bf16 value, which TF32 holds exactly.
// FINITE rounds with integer arithmetic on the bit pattern (add half a
// TF32 step to the magnitude; the tensor cores ignore the 13 low bits):
// the same bits as cvt.rna.tf32 for every finite x at half the
// instructions, but a NaN may come out finite.
template <bool SPLIT, bool FINITE = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if (SPLIT && FINITE) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  } else if (SPLIT) {
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
// lda(ks, a) loads the lane's four A elements of each of the MT m-tiles at
// k-step ks, ldb(ks, b) its two B elements of each of the NT n-tiles.
// Each element is split once and feeds all MT x NT tiles; the next
// k-step's raw elements are loaded before this step's MMAs are issued.
template <bool SPLIT, int MT, int NT, bool FINITE = false, typename LA,
          typename LB>
__device__ __forceinline__ void unit_product(float acc[MT][NT][4],
                                             int ksteps, LA lda, LB ldb) {
  float ra[MT][4], rb[NT][2];
  lda(0, ra);
  ldb(0, rb);
  for (int ks = 0; ks < ksteps; ++ks) {
    OpA a[MT];
    OpB b[NT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32<SPLIT, FINITE>(ra[m][j], a[m].hi[j], a[m].lo[j]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split_tf32<SPLIT, FINITE>(rb[n][j], b[n].hi[j], b[n].lo[j]);
    if (ks + 1 < ksteps) {
      lda(ks + 1, ra);
      ldb(ks + 1, rb);
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

// Measurement builds (-DFWD_PHASE_TIMERS, -DBWD_PHASE_TIMERS) sum, per
// block, the clock cycles thread 0 sees between the points that close each
// phase of a tile. Forward: 0 prologue, 1 waiting for a weight chunk,
// 2 products, 3 bias/ReLU stores and the layer's barrier, 4 head.
// Backward: 0 feature load, 1 recompute (or the wait for the stash),
// 2 head, 3 masks and bias sums, 4 weight gradients and products back,
// 5 frame-time cotangent.
constexpr int MAX_TIMED_BLOCKS = 1024;
#define PHASE_STAMP(k)                      \
  if (tid == 0) {                           \
    const long long now = clock64();        \
    phase_cycles[k] += now - stamp;         \
    stamp = now;                            \
  }
#ifdef FWD_PHASE_TIMERS
constexpr int FWD_N_PHASES = 5;
__device__ long long fwd_phase_cycles[MAX_TIMED_BLOCKS * FWD_N_PHASES];
#define FWD_PHASE(k) PHASE_STAMP(k)
#else
#define FWD_PHASE(k)
#endif
#ifdef BWD_PHASE_TIMERS
constexpr int N_PHASES = 6;
__device__ long long bwd_phase_cycles[MAX_TIMED_BLOCKS * N_PHASES];
#define BWD_PHASE(k) PHASE_STAMP(k)
#else
#define BWD_PHASE(k)
#endif

// ---------------------------------------------------------------------------
// forward: a persistent block per SM, weights staged through shared memory
// ---------------------------------------------------------------------------
// A block of 16 warps walks the 128-column tiles t, t + G, t + 2G, ... of
// the flat column list (column j = frame * N + sample; the last tile may
// be short). A layer's output (width x 128) is cut into 32 x 32 units, one
// per warp: the four warps of a group share the 32 weight rows of their
// m-unit and take one 32-column unit each. What the design does about the
// matmul chain:
//   * a pre-pass kernel lays the weights out in MMA fragment order once
//     per launch, so a 32-row x 64-k chunk of a layer is 8 KB of
//     contiguous memory (chunks of 32 or 16 k where many feature rows
//     leave less shared memory) and a lane's four A elements are one 16-byte
//     shared-memory load without bank conflicts;
//   * each group streams its chunks through a ring of FWD_STAGES buffers
//     with cp.async, one chunk ahead of the products and across layer
//     and tile boundaries, so no product waits on L2 and each weight is
//     read from L2 once per 128 columns; the ring is guarded by one named
//     barrier of the group's 128 threads per chunk;
//   * operands are split to TF32 hi/lo once per load with integer
//     rounding (sm_90a emulates cvt.rna.tf32 with twice the
//     instructions);
//   * MMA column g of tile n stands for tile column 4 g + n, which makes
//     a lane's B elements for the unit's four tiles one 16-byte load (the
//     row stride, 8 mod 32 words, keeps it conflict-free) and its outputs
//     16-byte stores;
//   * bias, ReLU and rounding run on the accumulator registers and write
//     the other of two activation buffers: one block barrier per layer;
//   * the prologue runs one (column, coordinate) pair per thread and the
//     head four threads per column with a shuffle sum.
constexpr int FWD_BN = 128;
constexpr int FWD_LD = FWD_BN + 8;
constexpr int FWD_THREADS = 512;
constexpr int FWD_MT = 2;                             // a warp's unit:
constexpr int FWD_NT = 4;                             // 32 x 32
constexpr int FWD_GROUP = FWD_BN / (8 * FWD_NT);      // warps per m-unit
constexpr int FWD_MAX_MU = FWD_THREADS / 32 / FWD_GROUP;
constexpr int FWD_KC = 64;        // k per chunk, halved until a block fits
constexpr int FWD_STAGES = 2;     // chunks in a ring

using FwdRows = RowsT<FWD_LD>;

__host__ __device__ __forceinline__ int fwd_m_units(int width) {
  return (width + 16 * FWD_MT - 1) / (16 * FWD_MT);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A 16-byte cp.async of data read once: first to go from L2, so it does
// not push out what the block reads again (the gradient partials).
__device__ __forceinline__ void cp_async16_once(float* dst, const float* src,
                                                uint64_t policy) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "l"(policy) : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(PENDING) : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// The hidden layers' weights in fragment order: layer i at wf_off[i] as
// [m-unit][k-step][m-tile][lane][4], the lane's A fragment of m16n8k8
// (rows past the width are zero). w is the padded (out, in_pad) layout.
__global__ void fused_render_fwd_pack_kernel(const float* __restrict__ w,
                                             float* __restrict__ wf,
                                             Net net) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= net.n_wf) return;
  int i = 0;
  while (i + 1 < net.depth && idx >= net.wf_off[i + 1]) ++i;
  const int Kp = net.in_pad[i];
  const int local = idx - net.wf_off[i];
  const int mu = local / (16 * FWD_MT * Kp);
  const int rem = local % (16 * FWD_MT * Kp);
  const int ks = rem / (128 * FWD_MT), m = rem / 128 % FWD_MT;
  const int lane = rem / 4 % 32, e = rem % 4;
  const int r = 16 * (FWD_MT * mu + m) + lane / 4 + 8 * (e & 1);
  const int k = 8 * ks + lane % 4 + 4 * (e >> 1);
  wf[idx] = r < net.width ? w[net.w_off[i] + r * Kp + k] : 0.f;
}

template <bool BF16>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fused_render_fwd_kernel(const float* __restrict__ t_eff,
                        const float* __restrict__ coords,
                        const float* __restrict__ omega,
                        const float* __restrict__ tg,
                        const float* __restrict__ smask,
                        const float* __restrict__ w,
                        const float* __restrict__ wf,
                        const float* __restrict__ bias,
                        float* __restrict__ em, float* __restrict__ fstash,
                        float* __restrict__ h_store, int nt, int N,
                        float inv_scale, int deg, int kc_max, Net net) {
  constexpr bool SPLIT = !BF16;
  extern __shared__ __align__(128) float smem[];
  const int W = net.width, Fd = net.feat, FP = net.feat_pad, D = net.depth;
  const int chunk = 16 * FWD_MT * kc_max;       // floats of a ring stage
  // two activation buffers of W rows: layer i writes act(i)
  auto act = [&](int i) { return smem + (i % 2) * W * FWD_LD; };
  float* Fs = smem + 2 * W * FWD_LD;            // FP rows
  float* mask = Fs + FP * FWD_LD;               // (FWD_BN,)
  float* whs = mask + FWD_BN;                   // head weights (W + FP)
  float* ring = whs + W + FP;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int g, q;
  lane_coords(g, q);
  const int mu = warp / FWD_GROUP;              // m-unit: rows [32 mu, +32)
  const int c0 = warp % FWD_GROUP * 8 * FWD_NT; // columns [c0, c0 + 32)
  const bool active = mu < fwd_m_units(W);
  const int gtid = tid % (32 * FWD_GROUP);
  float* stages = ring + mu * FWD_STAGES * chunk;
  const size_t cols = (size_t)nt * N;
  const int n_tiles = (int)((cols + FWD_BN - 1) / FWD_BN);

  // The group's weight stream: the chunks of layers 0..D-1, repeated for
  // each of the block's tiles. `issue` requests the next chunk into the
  // next stage (an empty commit once all are requested keeps the group
  // count in step).
  int chunks_per_tile = 0;
  for (int i = 0; i < D; ++i)
    chunks_per_tile += (net.in_pad[i] + kc_max - 1) / kc_max;
  const int my_tiles = (int)blockIdx.x < n_tiles
      ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  int to_issue = my_tiles * chunks_per_tile;
  int p_layer = 0, p_k0 = 0, p_stage = 0, c_stage = 0;
  auto issue = [&]() {
    if (to_issue > 0) {
      const int Kp = net.in_pad[p_layer];
      const int kc = min(kc_max, Kp - p_k0);
      const float* src = wf + net.wf_off[p_layer] +
                         16 * FWD_MT * ((size_t)mu * Kp + p_k0);
      float* dst = stages + p_stage * chunk;
      for (int v = gtid; v < 4 * FWD_MT * kc; v += 32 * FWD_GROUP)
        cp_async16(dst + 4 * v, src + 4 * v);
      --to_issue;
      p_k0 += kc_max;
      if (p_k0 >= Kp) {
        p_k0 = 0;
        if (++p_layer == D) p_layer = 0;
      }
    }
    p_stage = (p_stage + 1) % FWD_STAGES;
    cp_async_commit();
  };
  if (active)
    for (int s = 0; s < FWD_STAGES - 1; ++s) issue();

  for (int idx = tid; idx < (FP - Fd) * FWD_BN; idx += FWD_THREADS)
    Fs[(Fd + idx / FWD_BN) * FWD_LD + idx % FWD_BN] = 0.f;   // padding rows
  for (int k = tid; k < net.in_pad[D]; k += FWD_THREADS)
    whs[k] = w[net.w_off[D] + k];           // (1, in_pad), padding zero

#ifdef FWD_PHASE_TIMERS
  long long phase_cycles[FWD_N_PHASES] = {}, stamp = clock64();
#endif
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // prologue: velocity warp and positional encoding, one (column,
    // coordinate) pair per thread (mirrors _prologue, reference
    // fused.py:84-121); a fourth set of threads computes the masks.
    // Columns past the end repeat the last one and are never stored.
    for (int p = tid; p < 4 * FWD_BN; p += FWD_THREADS) {
      const int c = p % FWD_BN, j = p / FWD_BN;
      const size_t col = (size_t)tile * FWD_BN + c;
      const bool live = col < cols;
      const size_t cc = live ? col : cols - 1;
      const int t = (int)(cc / N), n = (int)(cc - (size_t)t * N);
      const float tM = t_eff[t] + tg[n];
      const bool valid = tM >= 0.f;
      const float vf = valid ? 1.f : 0.f;
      if (j == 3) {
        mask[c] = live ? vf * smask[n] : 0.f;
      } else {
        float wj;
        if (j == 2) {
          wj = coords[2 * (size_t)N + n] * vf * inv_scale;
        } else {
          const float theta = (valid ? tM : 0.f) * omega[n];
          const float ct = cosf(theta), st = sinf(theta);
          const float x = coords[n], y = coords[(size_t)N + n];
          wj = j == 0 ? (ct * x + st * y) * vf * inv_scale
                      : (ct * y - st * x) * vf * inv_scale;
        }
        float* stash = live && fstash != nullptr ? fstash + col : nullptr;
        auto put = [&](int r, float v) {
          v = rnd(v, BF16);
          Fs[r * FWD_LD + c] = v;
          if (stash != nullptr) stash[(size_t)r * cols] = v;
        };
        put(j, wj);
        if (deg > 0) {
          float s = sinf(wj), co = cosf(wj);
          put(3 + j, s);
          put(3 + 3 * deg + j, co);
          for (int i = 1; i < deg; ++i) {
            const float s2 = 2.f * s * co, c2 = co * co - s * s;
            s = s2;
            co = c2;
            put(3 + 3 * i + j, s);
            put(3 + 3 * deg + 3 * i + j, co);
          }
        }
      }
    }
    __syncthreads();
    FWD_PHASE(0);

    for (int i = 0; i < D; ++i) {
      if (active) {
        const int Kp = net.in_pad[i];
        const FwdRows X = i == 0 ? FwdRows{Fs, FP, nullptr}
                                 : FwdRows{act(i - 1), W, Fs};
        float acc[FWD_MT][FWD_NT][4] = {};
        for (int k0 = 0; k0 < Kp; k0 += kc_max) {
          // chunk landed (this thread's copies, then the group's), and
          // the group is done with the stage the next request overwrites
          cp_async_wait<FWD_STAGES - 2>();
          named_barrier(1 + mu, 32 * FWD_GROUP);
          issue();
          FWD_PHASE(1);
          const float* A = stages + c_stage * chunk + 4 * lane;
          c_stage = (c_stage + 1) % FWD_STAGES;
          unit_product<SPLIT, FWD_MT, FWD_NT, true>(
              acc, min(kc_max, Kp - k0) / 8,
              [&](int ks, float (*a)[4]) {
#pragma unroll
                for (int m = 0; m < FWD_MT; ++m) {
                  const float4 v = *reinterpret_cast<const float4*>(
                      A + 128 * (FWD_MT * ks + m));
                  a[m][0] = v.x; a[m][1] = v.y; a[m][2] = v.z; a[m][3] = v.w;
                }
              },
              [&](int ks, float (*b)[2]) {
                // rows k and k + 4 of one 8-row step share their source
                const float* x = X.row(k0 + 8 * ks + q) + c0 + 4 * g;
                const float4 x0 = *reinterpret_cast<const float4*>(x);
                const float4 x4 =
                    *reinterpret_cast<const float4*>(x + 4 * FWD_LD);
                b[0][0] = x0.x; b[1][0] = x0.y; b[2][0] = x0.z; b[3][0] = x0.w;
                b[0][1] = x4.x; b[1][1] = x4.y; b[2][1] = x4.z; b[3][1] = x4.w;
              });
          FWD_PHASE(2);
        }
        // acc[m][n] = rows g, g + 8 of m-tile m at tile columns
        // c0 + 8 q + n and c0 + 8 q + 4 + n. With h_store the same values
        // also go to the activation stash from these registers: a lane's
        // float4 is four adjacent columns, so the warp's two stores of a
        // row fill 128 contiguous bytes. The 32-column units past the end
        // of a short last tile store nothing.
        float* out = act(i);
        const size_t hcol = (size_t)tile * FWD_BN + c0;
        float* hs = h_store != nullptr && hcol < cols
            ? h_store + (size_t)i * W * cols + hcol + 8 * q : nullptr;
#pragma unroll
        for (int m = 0; m < FWD_MT; ++m) {
          const int r = 16 * (FWD_MT * mu + m) + g;
          if (r >= W) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {           // rows r and r + 8
            const float b = bias[net.b_off[i] + r + 8 * h];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float4 v;
              v.x = rnd(fmaxf(acc[m][0][2 * h + e] + b, 0.f), BF16);
              v.y = rnd(fmaxf(acc[m][1][2 * h + e] + b, 0.f), BF16);
              v.z = rnd(fmaxf(acc[m][2][2 * h + e] + b, 0.f), BF16);
              v.w = rnd(fmaxf(acc[m][3][2 * h + e] + b, 0.f), BF16);
              *reinterpret_cast<float4*>(out + (r + 8 * h) * FWD_LD + c0 +
                                         8 * q + 4 * e) = v;
              if (hs != nullptr)
                __stcs(reinterpret_cast<float4*>(
                           hs + (size_t)(r + 8 * h) * cols + 4 * e), v);
            }
          }
        }
      }
      __syncthreads();
      FWD_PHASE(3);
    }

    // head: four threads per column, each a quarter of the input rows
    for (int p = tid; p < 4 * FWD_BN; p += FWD_THREADS) {
      const int c = p / 4, part = p % 4;
      const FwdRows X{act(D - 1), W, Fs};
      float s = 0.f;
#pragma unroll 4
      for (int k = part; k < net.in_dim[D]; k += 4)
        s = fmaf(whs[k], X.row(k)[c], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const size_t col = (size_t)tile * FWD_BN + c;
      if (part == 0 && col < cols) {
        const float out = bias[net.b_off[D]] + s;
        em[col] = 1.f / (1.f + expf(-(out - 10.f))) * mask[c];
      }
    }
    __syncthreads();   // the next prologue overwrites Fs and mask
    FWD_PHASE(4);
  }
#ifdef FWD_PHASE_TIMERS
  if (tid == 0)
    for (int k = 0; k < FWD_N_PHASES; ++k)
      fwd_phase_cycles[blockIdx.x * FWD_N_PHASES + k] = phase_cycles[k];
#endif
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
        [&](int ks, float (*a)[4]) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int r = m0 + 16 * m + g;
            if (r < M) {
              const float* wr = Wg + (size_t)r * Kp + 8 * ks + 2 * q;
              float2 x0 = __ldg(reinterpret_cast<const float2*>(wr));
              float2 x8 = __ldg(reinterpret_cast<const float2*>(wr + 8 * Kp));
              a[m][0] = x0.x; a[m][1] = x8.x; a[m][2] = x0.y; a[m][3] = x8.y;
            } else {
              a[m][0] = a[m][1] = a[m][2] = a[m][3] = 0.f;
            }
          }
        },
        [&](int ks, float (*bb)[2]) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int k = 8 * ks + 2 * q, c = c0 + 8 * n + g;
            bb[n][0] = X.row(k)[c];
            bb[n][1] = X.row(k + 1)[c];
          }
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
      [&](int ks, float (*a)[4]) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = m0 + 16 * m + g, c = 8 * ks + q;
          if (r < M) {
            const float* d0 = dpre + r * LD + c;
            a[m][0] = d0[0]; a[m][1] = d0[8 * LD]; a[m][2] = d0[4];
            a[m][3] = d0[8 * LD + 4];
          } else {
            a[m][0] = a[m][1] = a[m][2] = a[m][3] = 0.f;
          }
        }
      },
      [&](int ks, float (*bb)[2]) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* xr = X.row(k0 + 8 * n + g) + 8 * ks + q;
          bb[n][0] = xr[0];
          bb[n][1] = xr[4];
        }
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
      [&](int ks, float (*a)[4]) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = m0 + 16 * m + g;
          if (r < Kp) {
            const float* wo = Wg + (size_t)(8 * ks + 2 * q) * Kp + r;
            a[m][0] = __ldg(wo);
            a[m][1] = __ldg(wo + 8);
            a[m][2] = __ldg(wo + Kp);
            a[m][3] = __ldg(wo + Kp + 8);
          } else {
            a[m][0] = a[m][1] = a[m][2] = a[m][3] = 0.f;
          }
        }
      },
      [&](int ks, float (*bb)[2]) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* d0 = dpre + (8 * ks + 2 * q) * LD + c0 + 8 * n + g;
          bb[n][0] = d0[0];
          bb[n][1] = d0[LD];
        }
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
                        const float* __restrict__ h_store,
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
  const uint64_t policy = evict_first_policy();
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

    // the forward's stashed activations, when it kept them: D x W rows of
    // 64 columns, 16-byte copies into the rows the recompute would fill,
    // in flight while the features load. They are read once, so they go
    // first from L2 and leave it to the gradient partials, which every
    // tile reads and writes again (with L2's default policy the stash
    // pushed them out and the weight gradients ran 10-50% slower)
    if (h_store != nullptr) {
      for (int idx = tid; idx < D * W * (BN / 4); idx += BWD_THREADS) {
        const int row = idx / (BN / 4), c = 4 * (idx % (BN / 4));
        cp_async16_once(acts + row * LD + c,
                        h_store + (size_t)row * cols + col0 + c, policy);
      }
      cp_async_commit();
    }
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

    // the hidden activations: the stash landed, or recompute them
    if (h_store != nullptr) {
      cp_async_wait<0>();
      __syncthreads();
      BWD_PHASE(1);
    } else {
      for (int i = 0; i < D; ++i) {
        recompute_layer<SPLIT>(w + net.w_off[i], net.in_pad[i], W,
                               layer_input(net, i, acts, Fs),
                               bias + net.b_off[i], acts + i * W * LD, BF16);
        __syncthreads();
        BWD_PHASE(1);
      }
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
  for (int i = 0; i < depth; ++i) {
    net.wf_off[i] = net.n_wf;
    net.n_wf += fwd_m_units(width) * 16 * FWD_MT * net.in_pad[i];
  }
  return net;
}

// the forward's 32-row m-units, one per group of warps; the backward is
// bounded by its shared memory only (fused_render_bwd_smem)
bool supported(int depth, int width) {
  return depth >= 1 && depth + 1 <= MAX_LAYERS && width % 16 == 0 &&
         width <= 16 * FWD_MT * FWD_MAX_MU;
}

size_t fwd_smem(const Net& net, int kc) {
  return sizeof(float) *
         ((size_t)(2 * net.width + net.feat_pad) * FWD_LD + FWD_BN +
          net.width + net.feat_pad +
          fwd_m_units(net.width) * FWD_STAGES * 16 * FWD_MT * kc);
}

// The forward's launch shape on the current device: the largest chunk
// (kc) whose block fits the shared memory, and the SM count.
struct FwdPlan {
  int kc, sms;
  size_t smem;
};

cudaError_t fwd_plan(const Net& net, FwdPlan* plan) {
  int device, limit;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&plan->sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (plan->kc = FWD_KC; plan->kc >= 16; plan->kc /= 2) {
    plan->smem = fwd_smem(net, plan->kc);
    if (plan->smem <= (size_t)limit) return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int fused_render_tile() { return BN; }

// packed parameter floats: padded weights, then biases
int fused_render_n_params(int depth, int width, int feat, int do_skip) {
  Net net = make_net(depth, width, feat, do_skip, 0);
  return net.n_weights + net.b_off[depth] + 1;
}

#ifdef FWD_PHASE_TIMERS
int fused_render_fwd_phases(long long* out, int blocks) {
  if (blocks > MAX_TIMED_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, fwd_phase_cycles,
                                   sizeof(long long) * blocks * FWD_N_PHASES);
}
#endif

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

// floats of scratch the forward takes as `wf` (its weights in fragment
// order, written by its pre-pass)
int fused_render_fwd_scratch(int depth, int width, int feat, int do_skip) {
  return make_net(depth, width, feat, do_skip, 0).n_wf;
}

// resident blocks per SM and threads per block of the forward
int fused_render_fwd_occupancy(int depth, int width, int feat, int do_skip,
                               int bf16, int* blocks, int* threads) {
  Net net = make_net(depth, width, feat, do_skip, bf16);
  FwdPlan plan;
  cudaError_t err = fwd_plan(net, &plan);
  if (err != cudaSuccess) return (int)err;
  auto kernel = bf16 ? fused_render_fwd_kernel<true>
                     : fused_render_fwd_kernel<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  *threads = FWD_THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, FWD_THREADS, plan.smem);
}

// fstash (feat, nt * N) and h_store (depth, width, nt * N), column
// t * N + n, may each be null: the forward then writes no features or no
// activations.
int fused_render_fwd(const float* t_eff, const float* coords,
                     const float* omega, const float* tg, const float* smask,
                     const float* w, const float* bias, float* wf, float* em,
                     float* fstash, float* h_store, int nt, int N, int depth,
                     int width, int feat, int do_skip, int deg,
                     float inv_scale, int bf16, void* stream) {
  if (!supported(depth, width) || N % BN != 0)
    return (int)cudaErrorInvalidValue;
  Net net = make_net(depth, width, feat, do_skip, bf16);
  FwdPlan plan;
  cudaError_t err = fwd_plan(net, &plan);
  if (err != cudaSuccess) return (int)err;
  auto kernel = bf16 ? fused_render_fwd_kernel<true>
                     : fused_render_fwd_kernel<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fused_render_fwd_pack_kernel<<<(net.n_wf + 255) / 256, 256, 0, s>>>(w, wf,
                                                                      net);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)nt * N + FWD_BN - 1) / FWD_BN;
  kernel<<<(int)(tiles < plan.sms ? tiles : plan.sms), FWD_THREADS,
           plan.smem, s>>>(t_eff, coords, omega, tg, smask, w, wf, bias, em,
                           fstash, h_store, nt, N, inv_scale, deg, plan.kc,
                           net);
  return (int)cudaGetLastError();
}

// partial: (grid, stride) floats, zeroed, stride >= n_params and a
// multiple of 8 (aligned rows for the 8-byte loads and stores). h_store:
// the forward's activation stash, or null to recompute the activations.
int fused_render_bwd(const float* g_em, const float* em, const float* fstash,
                     const float* h_store, const float* omega,
                     const float* w, const float* bias,
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
      g_em, em, fstash, h_store, omega, w, bias, partial, stride,
      dt_partial, nt, N, deg, want_dt, net);
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
