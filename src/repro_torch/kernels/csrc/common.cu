// Error text for the codes the entry points return (see common.cuh).
#include "common.cuh"

extern "C" const char* repro_error_string(int code) {
  switch (code) {
    case rk::kBadDType: return "unsupported dtype";
    case rk::kBadHeadDim: return "unsupported head dim";
    case rk::kBadShape: return "unsupported shape";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
