// The count of device operations in the CUDA graph being captured on a
// stream: its kernel, memcpy and memset nodes, the nodes that show in a
// replay's device trace (empty, event and host nodes do not).
//
// utils/profiling.py reads it at the entry and exit of each stage of a
// frame's body while render/compiled.py captures the body, which builds
// the entry's stage map. The capture runs on one stream, so its graph is a
// chain and the k-th device operation of a replay is the k-th such node.
// The call adds nothing to the graph: cudaStreamGetCaptureInfo hands back
// the graph under capture, which may be read while the capture goes on.
//
// Built with K1-K6 and S1-S6 into one library (kernels/build.py).
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

extern "C" int capture_device_ops(void* stream, int64_t* out) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id,
                                             &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t count = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    count += type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemcpy ||
             type == cudaGraphNodeTypeMemset;
  }
  *out = count;
  return 0;
}
