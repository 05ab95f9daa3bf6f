// Per-ray BVH traversal for NVIDIA GPUs, called from JAX through the XLA FFI
// (ops/traverse_cuda.py builds the tables and launches it).
//
// One thread walks one ray over the binary world BVH with a short private
// stack, nearer child first, as the reference's traverseBVHStack does
// (src/kernels.h:202-275). The contract is ops/traverse.py's: closest hit
// (or first hit for stop-on-hit lanes) against the world triangles with
// t < t_init, returning t, the world-triangle index and the barycentrics.
//
// Tables (all float32, integer fields stored as bit patterns):
//   nodes  [N, 16]  one record per node; only inner nodes' records are read:
//                   left box | right box | left ref | right ref | pad
//   tris   [WT, 12] v0 | e1 = v1 - v0 | e2 = v2 - v0, each padded to float4
//   root   [8]      root box | root ref | pad
// A child ref >= 0 is an inner node index; a ref < 0 is a leaf whose
// ~ref = (first triangle << 3) | triangle count.
//
// Build: make -C cuda_pathtracer_tpu/ops/cuda

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// kept equal to BLOCK and STACK in ops/traverse_cuda.py
constexpr int kBlock = 128;
constexpr int kStack = 64;

constexpr int kFlagWalk = 1;   // the ray enters the tree
constexpr int kFlagStop = 2;   // the ray stops at its first hit

__device__ __forceinline__ float3 safe_inv(float3 d) {
  // ops/intersect.py:safe_inv_dir
  const float tiny = 1e-20f;
  float3 r;
  r.x = 1.0f / (fabsf(d.x) < tiny ? (d.x >= 0.0f ? tiny : -tiny) : d.x);
  r.y = 1.0f / (fabsf(d.y) < tiny ? (d.y >= 0.0f ? tiny : -tiny) : d.y);
  r.z = 1.0f / (fabsf(d.z) < tiny ? (d.z >= 0.0f ? tiny : -tiny) : d.z);
  return r;
}

// ops/intersect.py:slab_test
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, float3 o, float3 inv,
                                     float t_best, float* t_near) {
  const float t0x = (lx - o.x) * inv.x, t1x = (hx - o.x) * inv.x;
  const float t0y = (ly - o.y) * inv.y, t1y = (hy - o.y) * inv.y;
  const float t0z = (lz - o.z) * inv.z, t1z = (hz - o.z) * inv.z;
  const float tmin =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  *t_near = tmin;
  return tmax >= fmaxf(0.0f, tmin) && tmin < t_best;
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const float4* __restrict__ nodes,
                    const float4* __restrict__ tris,
                    const float* __restrict__ root,
                    const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t_init,
                    const int32_t* __restrict__ flags, float* __restrict__ t_out,
                    int32_t* __restrict__ prim_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const float3 o = make_float3(ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]);
  const float3 d = make_float3(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
  float t = t_init[i];
  const int f = flags[i];
  int32_t best = -1;
  float best_u = 0.0f, best_v = 0.0f;

  if (f & kFlagWalk) {
    const bool stop = (f & kFlagStop) != 0;
    const float3 inv = safe_inv(d);
    int32_t stack_ref[kStack];
    float stack_t[kStack];
    int sp = 0;
    float t_near;
    int32_t ref = __float_as_int(root[6]);
    bool have = slab(root[0], root[1], root[2], root[3], root[4], root[5], o,
                     inv, t, &t_near);
    while (true) {
      if (have && ref >= 0) {
        // inner node: test both children, enter the nearer, push the other
        const float4* n = nodes + 4 * static_cast<int64_t>(ref);
        const float4 a = __ldg(n), b = __ldg(n + 1), c = __ldg(n + 2),
                     r = __ldg(n + 3);
        float tl, tr;
        const bool hl = slab(a.x, a.y, a.z, a.w, b.x, b.y, o, inv, t, &tl);
        const bool hr = slab(b.z, b.w, c.x, c.y, c.z, c.w, o, inv, t, &tr);
        const int32_t lref = __float_as_int(r.x), rref = __float_as_int(r.y);
        if (hl && hr) {
          const bool left_first = tl <= tr;
          stack_ref[sp] = left_first ? rref : lref;
          stack_t[sp] = left_first ? tr : tl;
          ++sp;
          ref = left_first ? lref : rref;
          continue;
        }
        if (hl || hr) {
          ref = hl ? lref : rref;
          continue;
        }
      } else if (have) {
        // leaf: test its triangles in index order (ties keep the first)
        const int32_t code = ~ref;
        const int32_t start = code >> 3, count = code & 7;
        bool found = false;
        for (int k = 0; k < count; ++k) {
          const float4* tp = tris + 3 * static_cast<int64_t>(start + k);
          const float4 p0 = __ldg(tp), p1 = __ldg(tp + 1), p2 = __ldg(tp + 2);
          const float3 v0 = make_float3(p0.x, p0.y, p0.z);
          const float3 e1 = make_float3(p1.x, p1.y, p1.z);
          const float3 e2 = make_float3(p2.x, p2.y, p2.z);
          // ops/intersect.py:ray_triangle (Moller-Trumbore)
          const float3 pvec = cross3(d, e2);
          const float det = dot3(e1, pvec);
          if (fabsf(det) < 1e-4f) continue;
          const float inv_det = 1.0f / det;
          const float3 tvec = make_float3(o.x - v0.x, o.y - v0.y, o.z - v0.z);
          const float u = dot3(tvec, pvec) * inv_det;
          const float3 qvec = cross3(tvec, e1);
          const float v = dot3(d, qvec) * inv_det;
          const float th = dot3(e2, qvec) * inv_det;
          if (u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
              th > 0.0f && th < t) {
            t = th;
            best = start + k;
            best_u = u;
            best_v = v;
            found = true;
          }
        }
        if (stop && found) break;
      }
      // pop the next entry still nearer than the best hit
      have = false;
      while (sp > 0) {
        --sp;
        if (stack_t[sp] < t) {
          ref = stack_ref[sp];
          have = true;
          break;
        }
      }
      if (!have) break;
    }
  }
  t_out[i] = t;
  prim_out[i] = best;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

static ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                               ffi::Buffer<ffi::F32> tris,
                               ffi::Buffer<ffi::F32> root,
                               ffi::Buffer<ffi::F32> ro,
                               ffi::Buffer<ffi::F32> rd,
                               ffi::Buffer<ffi::F32> t_init,
                               ffi::Buffer<ffi::S32> flags,
                               ffi::ResultBuffer<ffi::F32> t_out,
                               ffi::ResultBuffer<ffi::S32> prim_out,
                               ffi::ResultBuffer<ffi::F32> u_out,
                               ffi::ResultBuffer<ffi::F32> v_out) {
  const int64_t n = t_init.element_count();
  if (n % kBlock != 0) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "ray count must be a multiple of the block size");
  }
  if (n == 0) return ffi::Error::Success();
  traverse_kernel<<<static_cast<unsigned>(n / kBlock), kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), root.typed_data(),
      ro.typed_data(), rd.typed_data(), t_init.typed_data(),
      flags.typed_data(), t_out->typed_data(), prim_out->typed_data(),
      u_out->typed_data(), v_out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(CptTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()  // root
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ro
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rd
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_init
                                  .Arg<ffi::Buffer<ffi::S32>>()  // flags
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // prim
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // v
);
