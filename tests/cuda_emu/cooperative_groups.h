// CPU emulation (see cuda_runtime.h): a cooperative launch is one block,
// so a grid sync is a block barrier.
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { __syncthreads(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
