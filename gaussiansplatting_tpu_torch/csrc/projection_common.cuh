// Pieces shared by the projection kernels of the 3D Gaussian
// (projection.cu) and of the surfel (surfel_projection.cu): the block
// size, the plain forms' constants, and torch's clamp, isfinite and int32
// floor division as one thread computes them.
//
// In an anonymous namespace, as each file had them, so every name and
// instance is the one each file compiled before.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMaxCoord = 1e6f; // |mean| beyond it culls (ops/projection.py)
constexpr float kQuatEps = 1e-3f; // core/transforms.normalize_quat
constexpr float kDeadLo = 0.01f, kDeadHi = 0.99f;  // the colour's dead zone

// torch.clamp(x, lo, hi): min(max(x, lo), hi), NaN kept.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// torch.isfinite: neither infinite nor NaN
__device__ __forceinline__ bool finitef(float x) { return fabsf(x) <= 3.402823466e+38f; }

// torch's floor division of int32
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

}  // namespace
