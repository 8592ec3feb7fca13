// The UNet's level mark: one thread that does nothing.
//
// SR3UNet launches one at the start and end of its forward and around its
// outer levels (models/sr3_unet.py), so a device trace of a forward
// replayed as one CUDA graph still shows where those levels start and end:
// the marks are nodes of the graph, in the order the forward launched them.  Its name is its
// own (not torch.cuda._sleep's spin_kernel, the spans' clock markers), and
// the benchmark's level readers look for it by that name.

#include <cuda_runtime.h>

__global__ void sr3d_level_mark_kernel() {}

extern "C" {

// Returns cudaGetLastError() right after the launch.
int sr3d_level_mark(void* stream) {
  sr3d_level_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
