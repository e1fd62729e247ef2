// Launching a grid in thread-block clusters (Hopper): shared by the kernels
// whose blocks meet through distributed shared memory, K10/K11
// (batch_norm.cu) and K15 (quantize_int8.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// grid x slices blocks, a cluster of slices along y (no cluster where a
// cluster would hold one block)
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int grid, int slices, int threads, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, slices, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = slices > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...));
}

}  // namespace
