// The double-precision pow of the kernels (tpow in geodesic_common.cuh),
// compiled in its own translation unit with floating-point contraction on,
// as PyTorch's CUDA kernels are built. The kernels' sources are built with
// --fmad=false, so that each of their operations rounds on its own like the
// plain PyTorch versions; inside libdevice's double pow that setting leaves
// multiply-adds unfused that PyTorch's build fuses, and the result then
// differs from torch.pow's by an ulp on about one input in a million (the
// controller's pow then moves an adaptive ray's steps). Linked with each
// library as relocatable device code (utils/cuda_build.py). The float powf
// gives the same bits either way and stays inline.

#include <math.h>

extern "C" __device__ double rtgr_pow64(double x, double y) {
  return pow(x, y);
}
