// Thread-block cluster helpers shared by the cluster kernels of K6
// (fused_adapter.cu) and K4 (contrastive.cu): the rank-order sum over a
// cluster's shared memory, and the once-a-device launch set-up.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace vct {

// The sum over the cluster's CLUSTER blocks, in rank order, of the float
// at offset `at` of each block's copy of the shared buffer `buf`.
template <int CLUSTER>
__device__ __forceinline__ float cluster_sum(
    const cooperative_groups::cluster_group& cluster, float* buf, int at) {
  float s = cluster.map_shared_rank(buf, 0)[at];
#pragma unroll
  for (int q = 1; q < CLUSTER; ++q) s += cluster.map_shared_rank(buf, q)[at];
  return s;
}

// Once per kernel and device: allow the cluster kernel Kern `smem_max`
// bytes of dynamic shared memory and check that a cluster of CLUSTER
// blocks of THREADS threads can be scheduled with that much
// (cudaOccupancyMaxActiveClusters), so a launch at any smaller size can
// be. The error, or cudaErrorInvalidConfiguration where no cluster fits,
// is returned on every later call too: the wrapper raises, nothing falls
// back.
template <auto Kern, int CLUSTER, int THREADS>
int cluster_ready(size_t smem_max) {
  static int state[64];  // per device: 0 not yet, 1 ready, else 2 + error
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (state[dev] == 1) return 0;
  if (state[dev] > 1) return state[dev] - 2;
  err = (int)cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (!err) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_max;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, Kern, &cfg);
    if (!err && clusters < 1) err = (int)cudaErrorInvalidConfiguration;
  }
  state[dev] = err ? 2 + err : 1;
  return err;
}

}  // namespace vct
