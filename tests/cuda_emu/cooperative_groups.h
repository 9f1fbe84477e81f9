// CPU emulation (see cuda_runtime.h): a cooperative launch and a cluster
// launch are each one block, so a grid or cluster sync is a block barrier.
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { __syncthreads(); }
};
inline grid_group this_grid() { return {}; }
struct cluster_group {
  void sync() { __syncthreads(); }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
