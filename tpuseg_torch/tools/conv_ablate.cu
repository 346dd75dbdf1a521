// Timing harness of tools/conv_ablate.py: the tensor-core bodies of K6 and K4
// at the main paths' shapes, through their C entry points, without PyTorch.
// Prints one line per case: "<tag> <case> <ms>".
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" int tpuseg_conv3x3_mma(const void*, const void*, void*, int, int,
                                  int, int, int, int, void*);
extern "C" int tpuseg_convblock_mma(const void*, const void*, const float*,
                                    const float*, const void*, const float*,
                                    const float*, void*, int, int, int, int,
                                    int, int, void*);

static void* device_values(size_t n) {
  std::vector<__nv_bfloat16> h(n);
  for (size_t i = 0; i < n; ++i)
    h[i] = __float2bfloat16((rand() % 200 - 100) / 400.f);
  void* d = nullptr;
  cudaMalloc(&d, n * 2);
  cudaMemcpy(d, h.data(), n * 2, cudaMemcpyHostToDevice);
  return d;
}

template <typename F>
static float mean_ms(F launch, int reps) {
  launch();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms / reps;
}

static void report(const char* tag, const char* what, float ms, int err) {
  const cudaError_t run = cudaDeviceSynchronize();
  if (err != 0 || run != cudaSuccess) {
    printf("%s %s FAILED (launch %d, run %s)\n", tag, what, err,
           cudaGetErrorString(run));
    exit(1);
  }
  printf("%s %s %.3f\n", tag, what, ms);
}

int main(int argc, char** argv) {
  const char* tag = argc > 1 ? argv[1] : "base";
  {  // K6 at the train step's shape: batch 8 of 64^3, 32 output channels
    const int N = 8, co = 32, S = 64;
    const size_t vox = static_cast<size_t>(N) * S * S * S;
    void* y = nullptr;
    cudaMalloc(&y, vox * co * 2);
    for (int ci : {32, 64}) {
      void* x = device_values(vox * ci);
      void* w = device_values(27 * ci * co);
      int err = 0;
      const float ms = mean_ms([&] {
        err |= tpuseg_conv3x3_mma(x, w, y, N, ci, co, S, S, S, nullptr);
      }, 10);
      report(tag, ci == 32 ? "K6_32to32" : "K6_64to32", ms, err);
      cudaFree(x);
      cudaFree(w);
    }
    cudaFree(y);
  }
  {  // K4 at one tile block of the default sweep: (1, ci, 64, 160, 160)
    const int D = 64, H = 160, W = 160;
    const size_t vox = static_cast<size_t>(D) * H * W;
    std::vector<float> ones(32, 1.f);
    float* aff = nullptr;
    cudaMalloc(&aff, 128);
    cudaMemcpy(aff, ones.data(), 128, cudaMemcpyHostToDevice);
    void* y = nullptr;
    cudaMalloc(&y, vox * 32 * 2);
    void* w2 = device_values(27 * 32 * 32);
    for (int ci : {64, 32}) {
      void* x = device_values(vox * ci);
      void* w1 = device_values(27 * ci * 32);
      int err = 0;
      const float ms = mean_ms([&] {
        err |= tpuseg_convblock_mma(x, w1, aff, aff, w2, aff, aff, y, 1, ci, D,
                                    H, W, 1, nullptr);
      }, 10);
      report(tag, ci == 64 ? "K4_ci64" : "K4_ci32", ms, err);
      cudaFree(x);
      cudaFree(w1);
    }
  }
  return 0;
}
