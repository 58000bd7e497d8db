// Shared by every kernel library of the port: the C export macro, the
// error-string entry point and the launch-result convention (each exported
// function launches one kernel and returns cudaGetLastError()).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ZK_EXPORT extern "C" __attribute__((visibility("default")))

typedef long long i64;

ZK_EXPORT const char* zk_error_string(i64 err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static inline int zk_blocks(i64 n, int threads) {
  i64 b = (n + threads - 1) / threads;
  // grid-stride loops cover the rest
  return static_cast<int>(b < (1LL << 30) ? (b > 0 ? b : 1) : (1LL << 30));
}
