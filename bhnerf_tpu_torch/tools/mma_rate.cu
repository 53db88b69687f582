// Microbenchmark: what one SM sub-partition sustains of the render kernels'
// mma.sync products on registers alone, with no loads, no operand split,
// no per-step add and no barriers. It bounds what any arrangement of the
// kernels' products can reach.
//
// Each warp holds a unit of MT x NT output tiles of m16n8k8 TF32 and per
// step issues, for every tile, `PROD` products (3 = the 3xTF32 of f32
// mode, 1 = bf16 mode) that sum into the tile's accumulator, so every
// MMA depends on the one before it in its tile and none can be hoisted.
// Prints the cycles per MMA and sub-partition (4 per SM) from thread 0's
// clock64 between two block barriers; a single tile with one product
// gives the latency of a dependent MMA.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate \
//        bhnerf_tpu_torch/tools/mma_rate.cu && ./mma_rate
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2], const float c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

template <int MT, int NT, int PROD>
__global__ void bench(float* out, long long* cycles, int iters) {
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
  for (int m = 0; m < MT; ++m)
    for (int i = 0; i < 4; ++i) {
      ah[m][i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i + m);
      al[m][i] = __float_as_uint(1e-4f * (i + m + 1));
    }
  for (int n = 0; n < NT; ++n)
    for (int i = 0; i < 2; ++i) {
      bh[n][i] = __float_as_uint(0.5f + threadIdx.x * 1e-3f + i + n);
      bl[n][i] = __float_as_uint(1e-4f * (i + n + 1));
    }
  float acc[MT][NT][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (PROD == 3) {
          mma(acc[m][n], al[m], bh[n], acc[m][n]);
          mma(acc[m][n], ah[m], bl[n], acc[m][n]);
        }
        mma(acc[m][n], ah[m], bh[n], acc[m][n]);
      }
  }
  __syncthreads();              // the slowest warp closes the interval
  const long long t1 = clock64();
  float r = 0.f;
  for (int m = 0; m < MT; ++m)
    for (int n = 0; n < NT; ++n)
      for (int j = 0; j < 4; ++j) r += acc[m][n][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int MT, int NT, int PROD>
void run(int threads) {
  const int iters = 2000, blocks = 132;
  float* out;
  long long* cyc;
  cudaMalloc(&out, blocks * 1024 * sizeof(float));
  cudaMalloc(&cyc, blocks * sizeof(long long));
  bench<MT, NT, PROD><<<blocks, threads>>>(out, cyc, iters);
  cudaDeviceSynchronize();
  long long first;
  cudaMemcpy(&first, cyc, sizeof(first), cudaMemcpyDeviceToHost);
  const double mmas = (double)iters * MT * NT * PROD * (threads / 32 / 4.0);
  printf("unit %d x %d tiles, %d product(s) per step, %2d warps per SM: "
         "%.2f cycles per MMA and sub-partition (%s)\n",
         MT, NT, PROD, threads / 32, first / mmas,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(cyc);
}

int main() {
  run<1, 1, 1>(128);   // one dependent chain a sub-partition: latency
  run<2, 4, 1>(512);   // the forward's 32 x 32 unit, bf16 and f32 mode
  run<2, 4, 3>(512);
  run<4, 4, 3>(256);   // 8 warps of 64 x 32 units
  run<1, 4, 3>(512);   // the backward's 16 x 32 and 32 x 16 units
  run<2, 2, 3>(512);
  return 0;
}
