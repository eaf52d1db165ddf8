// Loops decided on the device: CUDA graphs with WHILE conditional nodes.
//
// ``ops/graphs.py`` captures the straight-line work of a solve in segments
// (torch CUDA graphs, kept as cudaGraph_t) and composes them here into one
// graph: each segment a child graph node, each loop a WHILE conditional
// node whose body holds the loop body's segments and, last, a one-thread
// kernel that sets the node's condition from a device flag. A first
// kernel before the conditional node sets it from the same flag, so a
// loop whose flag is already false runs no trip. Conditional nodes nest
// (a line search inside an iteration). Every function returns 0 or the
// cudaError of the call that failed; handles pass as void pointers.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t add_set_node(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraphConditionalHandle handle,
                         const bool* flag, cudaGraphNode_t* node) {
  cudaKernelNodeParams params = {};
  void* args[] = {&handle, &flag};
  params.func = reinterpret_cast<void*>(set_condition_kernel);
  params.gridDim = dim3(1, 1, 1);
  params.blockDim = dim3(1, 1, 1);
  params.sharedMemBytes = 0;
  params.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr, dep ? 1 : 0, &params);
}

}  // namespace

extern "C" {

int photon_graph_create(void** graph_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  *graph_out = graph;
  return static_cast<int>(err);
}

int photon_graph_destroy(void* graph) { return static_cast<int>(cudaGraphDestroy(static_cast<cudaGraph_t>(graph))); }

int photon_graph_node_count(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *count = n;
  return static_cast<int>(err);
}

// ``child`` (cloned) appended to ``graph`` after ``dep`` (null: none).
int photon_graph_add_child(void* graph, void* dep, void* child, void** node_out) {
  cudaGraphNode_t node = nullptr;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaError_t err = cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(graph), d ? &d : nullptr,
                                               d ? 1 : 0, static_cast<cudaGraph_t>(child));
  *node_out = node;
  return static_cast<int>(err);
}

// A WHILE node appended to ``graph`` after ``dep``: the kernel that sets
// its condition from ``*flag``, then the conditional node. Returns the
// node, its (empty) body graph and its handle; the caller fills the body
// and closes it with ``photon_graph_add_set``.
int photon_graph_add_while(void* graph, void* dep, const void* flag, void** node_out, void** body_out,
                           unsigned long long* handle_out) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle handle = 0;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t set = nullptr;
  err = add_set_node(g, static_cast<cudaGraphNode_t>(dep), handle, static_cast<const bool*>(flag), &set);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  err = cudaGraphAddNode(&node, g, &set, 1, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  *node_out = node;
  *body_out = params.conditional.phGraph_out[0];
  *handle_out = handle;
  return 0;
}

// The kernel that sets ``handle``'s condition from ``*flag``, appended to
// ``graph`` (a WHILE body) after ``dep``.
int photon_graph_add_set(void* graph, void* dep, unsigned long long handle, const void* flag, void** node_out) {
  cudaGraphNode_t node = nullptr;
  cudaError_t err = add_set_node(static_cast<cudaGraph_t>(graph), static_cast<cudaGraphNode_t>(dep), handle,
                                 static_cast<const bool*>(flag), &node);
  *node_out = node;
  return static_cast<int>(err);
}

int photon_graph_instantiate(void* graph, void** exec_out) {
  cudaGraphExec_t exec = nullptr;
  cudaError_t err = cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
  *exec_out = exec;
  return static_cast<int>(err);
}

int photon_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

int photon_graph_exec_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

}  // extern "C"
