// A probe of the card's dependent-operation latencies, which the latency
// floors of the chain-bound kernels (K8's narrow scan, K12) are stated in:
// one warp runs a chain of n dependent FP64 FMAs, of n dependent warp
// shuffles of a double, and of n / 16 dependent FP64 divisions, square
// roots and pow(x, -0.2) (CUDA's routines, as K12 calls them), and reads
// the SM's cycle counter around each.  It replaces no TPU kernel and is on
// no solve's path; chip_smoke.py calls it once and divides by the chain
// lengths (and times the launch with CUDA events for the SM clock).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void latency_probe(long long* cycles, double* sink, int n) {
  double x = sink[0] + threadIdx.x;
  const double a = sink[1], b = sink[2];
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = __fma_rn(x, a, b);
  long long t1 = clock64();
  cycles[0] = t1 - t0;
  double v = x;
  const int src = (threadIdx.x + 1) & 31;
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) v = __shfl_sync(0xffffffffu, v, src);
  t1 = clock64();
  cycles[1] = t1 - t0;
  const int m = n / 16;
  double q = v + 2.0;
  t0 = clock64();
  for (int i = 0; i < m; ++i) q = a / q;           // stays near sqrt(a)
  t1 = clock64();
  cycles[2] = t1 - t0;
  double r = q;
  t0 = clock64();
  for (int i = 0; i < m; ++i) r = sqrt(r);         // tends to 1
  t1 = clock64();
  cycles[3] = t1 - t0;
  double s = r + 1.0;
  t0 = clock64();
  for (int i = 0; i < m; ++i) s = pow(s, -0.2);    // tends to 1
  t1 = clock64();
  cycles[4] = t1 - t0;
  sink[3 + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// cycles: 5 int64 on the card (the FMA, shuffle, division, root and pow
// chains; written by every lane alike); sink: 35 doubles on the card (x0,
// a, b, then the warp's results); n: the FMA and shuffle chains' length, 16
// times the others'
int pm_latency_probe(long long* cycles, double* sink, int64_t n, void* stream) {
  if (n < 16 || n > 0x7fffffff) return (int)cudaErrorInvalidValue;
  latency_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(cycles, sink, (int)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
