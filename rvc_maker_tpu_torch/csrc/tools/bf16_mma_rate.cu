// The rate of mma.sync.m16n8k16 bf16 (fp32 accumulate) on the card with
// nothing else in the loop: blocks of 8 warps, each warp ILP independent
// accumulators, one block per SM (132) and two.  Prints TFLOP/s and the
// share of the dense bf16 peak (989 TFLOP/s, H100 SXM).  The bf16
// counterpart of tf32_mma_rate.cu.  Build and run on the machine with the
// card:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o bf16_mma_rate rvc_maker_tpu_torch/csrc/tools/bf16_mma_rate.cu
//     ./bf16_mma_rate
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <int ILP>
__global__ void __launch_bounds__(256, 1) k(float* out, int iters) {
  float acc[ILP][4] = {};
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = 5, b1 = 7;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ILP; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0;
  for (int i = 0; i < ILP; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
template <int ILP>
void run(float* out, int blocks) {
  const int iters = 4096;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  k<ILP><<<blocks, 256>>>(out, 16);
  cudaEventRecord(e0);
  k<ILP><<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double flops = 2.0 * 16 * 8 * 16 * (double)ILP * iters * blocks * 8;
  printf("ILP %2d blocks %d: %.3f ms, %.1f TFLOP/s bf16 (%.3f of 989)\n", ILP, blocks, ms, flops / ms / 1e9, flops / ms / 1e9 / 989.0);
}
int main() {
  float* out; cudaMalloc(&out, 132 * 4 * 256 * 4);
  run<4>(out, 132); run<8>(out, 132); run<16>(out, 132); run<16>(out, 264); run<32>(out, 132);
  return 0;
}
