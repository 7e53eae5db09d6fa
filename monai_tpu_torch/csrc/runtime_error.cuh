// The error a C entry returns to its caller, shared by every kernel source of this directory.

#pragma once

#include <cuda_runtime.h>

namespace {

// A result for the caller: err where a runtime call or a launch failed, with the runtime's
// record of that error cleared (the caller's next launch would read it; the caller raises
// with it), else cudaGetLastError().
inline cudaError_t cleared(cudaError_t err) {
  if (err == cudaSuccess) return cudaGetLastError();
  cudaGetLastError();
  return err;
}

}  // namespace
