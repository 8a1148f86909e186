// Dense-leaf BVH traversal for NVIDIA Hopper (sm_90a), called from JAX
// through XLA's foreign function interface (ops/traverse_dense.py).
//
// Design (Aila & Laine, "Understanding the Efficiency of Ray Traversal on
// GPUs", HPG 2009): one thread per ray, a per-thread stack, while-while
// traversal with near-first ordered descent. Closest hit prunes with the
// ray's own best t; any hit leaves the ray at its first accepted hit.
//
// Closest hit is independent of the visit order: of triangles at exactly
// the same t, the one first in (instance, primitive id) order wins, as in a
// brute-force argmin; a box entered exactly at the best t is still visited.
//
// Tables are the ones bvh/dense.py builds (DenseBVH):
//   nodes16 (N*16,) f32, per node: [c0lo(3) c0hi(3) c1lo(3) c1hi(3) child0
//     child1 pad pad], read as four float4 through the read-only path.
//     Child codes (stored as floats, exact below 2^24):
//       code >= 0             internal node index
//       code == ABSENT        empty slot
//       code < 0, v=-(code+1):
//         v & 1 == 0          triangle leaf, v >> 1 = group * 8 + log2(period)
//         v & 1 == 1          instance leaf, v >> 1 = instance id; the id
//                             RESTORE_ID is the sentinel that returns the
//                             ray to world space
//   groups (G*16, 128) f32: group g holds rows [16g, 16g + 16); rows 0..8 are
//     v0.xyz, e1.xyz, e2.xyz and row 9 the mesh-local primitive id, one
//     triangle per column. A leaf reads the first `period` columns.
//   inst16 (I*16,) f32, per instance: [0:12] the inverse (object from world)
//     3x4 transform by rows, [12] the BLAS root node.
//
// At an instance leaf the ray is rebased into object space (the direction
// is transformed unnormalised, so t is the same in both spaces and best-t
// pruning carries across levels) and a RESTORE sentinel is pushed below the
// BLAS subtree; popping it restores the world-space ray.
//
// The stack holds at most `stack_depth` entries (a runtime attribute, at
// most the template capacity). A push onto a full stack overwrites the top
// entry and sets FLAG_STACK_OVERFLOW in the ray's flags output: it is never
// written out of bounds. A ray stops after `max_steps` node and leaf visits
// (FLAG_STEP_LIMIT), and a child code that points outside the tables ends
// the ray's traversal (FLAG_BAD_CODE).
//
// Arithmetic: the slab test and Moller-Trumbore are the same expressions,
// in the same order, as the plain traversal in ops/traverse_dense.py. The
// library is compiled without --use_fast_math and with --fmad=false, so FMA
// contraction is OFF: every product and sum is rounded on its own, as the
// source is written.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNodeF4 = 4;  // float4 rows per node (16 floats)
constexpr int kInstF = 16;
constexpr int kGroupRows = 16;
constexpr int kLeafW = 128;
constexpr int kRestoreId = (1 << 22) - 1;
constexpr int kRestoreCode = -(2 * kRestoreId + 2);
constexpr int kAbsent = -(1 << 30);
constexpr int kDone = 0x7FFFFFFF;
constexpr int kBlock = 128;  // threads per block, one ray per thread

constexpr int kFlagStackOverflow = 1;
constexpr int kFlagStepLimit = 2;
constexpr int kFlagBadCode = 4;

struct Ray {
  float ox, oy, oz, dx, dy, dz, rx, ry, rz;
};

__device__ __forceinline__ float safe_rcp(float d) {
  const float eps = 1e-20f;
  const float dd = fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d;
  return 1.0f / dd;
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, safe_rcp(dx), safe_rcp(dy), safe_rcp(dz)};
}

// Slab test of one child box; returns hit and the entry distance in *tn.
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float t_clip, float* tn) {
  const float tx0 = (lx - r.ox) * r.rx;
  const float tx1 = (hx - r.ox) * r.rx;
  const float ty0 = (ly - r.oy) * r.ry;
  const float ty1 = (hy - r.oy) * r.ry;
  const float tz0 = (lz - r.oz) * r.rz;
  const float tz1 = (hz - r.oz) * r.rz;
  const float n = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                        fminf(tz0, tz1));
  const float f = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                        fmaxf(tz0, tz1));
  *tn = n;
  return (n <= f) && (f > 0.0f) && (n <= t_clip) && (t_clip > 0.0f);
}

template <bool kClosest, int kMaxStack>
__global__ void __launch_bounds__(kBlock) traverse_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ groups, int n_groups,
    const float* __restrict__ inst, int n_inst,
    const float* __restrict__ ray_ox, const float* __restrict__ ray_oy,
    const float* __restrict__ ray_oz, const float* __restrict__ ray_dx,
    const float* __restrict__ ray_dy, const float* __restrict__ ray_dz,
    const float* __restrict__ ray_tmax, int n_rays, int stack_cap,
    int64_t max_steps, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ prim_out, int* __restrict__ inst_out,
    int* __restrict__ flags_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  const float wox = __ldg(ray_ox + i), woy = __ldg(ray_oy + i),
              woz = __ldg(ray_oz + i);
  const float wdx = __ldg(ray_dx + i), wdy = __ldg(ray_dy + i),
              wdz = __ldg(ray_dz + i);
  const float t_max = __ldg(ray_tmax + i);
  const Ray world = make_ray(wox, woy, woz, wdx, wdy, wdz);
  Ray ray = world;

  float best_t = t_max, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1, best_inst = -1;
  bool occluded = false;
  int cur_inst = -1;

  int stack[kMaxStack];
  int sp = 0;
  int flags = 0;
  int64_t steps = 0;
  int cur = 0;  // root

  auto push = [&](int code) {
    if (sp >= stack_cap) {
      flags |= kFlagStackOverflow;
      stack[stack_cap - 1] = code;
    } else {
      stack[sp++] = code;
    }
  };
  auto pop = [&]() { return sp > 0 ? stack[--sp] : kDone; };

  while (cur != kDone) {
    // ---- descend internal nodes until a leaf code comes up -------------
    while (cur >= 0 && cur != kDone) {
      if (steps >= max_steps) { flags |= kFlagStepLimit; cur = kDone; break; }
      ++steps;
      if (cur >= n_nodes) { flags |= kFlagBadCode; cur = pop(); continue; }
      const float4 a = __ldg(nodes + kNodeF4 * cur + 0);
      const float4 b = __ldg(nodes + kNodeF4 * cur + 1);
      const float4 c = __ldg(nodes + kNodeF4 * cur + 2);
      const float4 e = __ldg(nodes + kNodeF4 * cur + 3);
      const int c0 = static_cast<int>(e.x);
      const int c1 = static_cast<int>(e.y);
      const float t_clip = kClosest ? best_t : t_max;
      float tn0, tn1;
      const bool h0 = slab(ray, a.x, a.y, a.z, a.w, b.x, b.y, t_clip, &tn0)
                      && c0 != kAbsent;
      const bool h1 = slab(ray, b.z, b.w, c.x, c.y, c.z, c.w, t_clip, &tn1)
                      && c1 != kAbsent;
      const bool swap = h1 && (!h0 || tn1 < tn0);
      const int near = swap ? c1 : c0;
      const int far = swap ? c0 : c1;
      const bool near_ok = swap ? h1 : h0;
      const bool far_ok = swap ? h0 : h1;
      if (near_ok && far_ok) push(far);
      cur = near_ok ? near : (far_ok ? far : pop());
    }
    // ---- leaves: triangle sweeps and instance enter / restore ----------
    while (cur < 0) {
      if (steps >= max_steps) { flags |= kFlagStepLimit; cur = kDone; break; }
      ++steps;
      const int v = -(cur + 1);
      if ((v & 1) == 0) {
        const int gv = v >> 1;
        const int g = gv >> 3;
        const int count = 1 << (gv & 7);
        if (g >= n_groups || count > kLeafW) {
          flags |= kFlagBadCode;
          cur = pop();
          continue;
        }
        const float* grp = groups + static_cast<size_t>(g) * kGroupRows * kLeafW;
        for (int j = 0; j < count; ++j) {
          const float v0x = __ldg(grp + 0 * kLeafW + j);
          const float v0y = __ldg(grp + 1 * kLeafW + j);
          const float v0z = __ldg(grp + 2 * kLeafW + j);
          const float e1x = __ldg(grp + 3 * kLeafW + j);
          const float e1y = __ldg(grp + 4 * kLeafW + j);
          const float e1z = __ldg(grp + 5 * kLeafW + j);
          const float e2x = __ldg(grp + 6 * kLeafW + j);
          const float e2y = __ldg(grp + 7 * kLeafW + j);
          const float e2z = __ldg(grp + 8 * kLeafW + j);
          const float px = ray.dy * e2z - ray.dz * e2y;
          const float py = ray.dz * e2x - ray.dx * e2z;
          const float pz = ray.dx * e2y - ray.dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool det_ok = fabsf(det) > 1e-9f;
          const float inv = 1.0f / (det_ok ? det : 1.0f);
          const float tx = ray.ox - v0x;
          const float ty = ray.oy - v0y;
          const float tz = ray.oz - v0z;
          const float uu = (tx * px + ty * py + tz * pz) * inv;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float vv = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * inv;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
          const bool ok = det_ok && uu >= 0.0f && vv >= 0.0f &&
                          uu + vv <= 1.0f && tt > 0.0f;
          if (kClosest) {
            const int pid = static_cast<int>(__ldg(grp + 9 * kLeafW + j));
            const bool tie_first =
                tt == best_t && best_prim >= 0 &&
                (cur_inst < best_inst ||
                 (cur_inst == best_inst && pid < best_prim));
            if (ok && (tt < best_t || tie_first)) {
              best_t = tt;
              best_u = uu;
              best_v = vv;
              best_prim = pid;
              best_inst = cur_inst;
            }
          } else if (ok && tt < t_max) {
            occluded = true;
            break;
          }
        }
        if (!kClosest && occluded) { cur = kDone; sp = 0; break; }
        cur = pop();
      } else {
        const int iid = v >> 1;
        if (iid == kRestoreId) {
          ray = world;
          cur_inst = -1;
          cur = pop();
        } else if (iid >= n_inst) {
          flags |= kFlagBadCode;
          cur = pop();
        } else {
          push(kRestoreCode);
          const float* m = inst + static_cast<size_t>(iid) * kInstF;
          const float m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2),
                      m3 = __ldg(m + 3), m4 = __ldg(m + 4), m5 = __ldg(m + 5),
                      m6 = __ldg(m + 6), m7 = __ldg(m + 7), m8 = __ldg(m + 8),
                      m9 = __ldg(m + 9), m10 = __ldg(m + 10),
                      m11 = __ldg(m + 11);
          ray = make_ray(m0 * wox + m1 * woy + m2 * woz + m3,
                         m4 * wox + m5 * woy + m6 * woz + m7,
                         m8 * wox + m9 * woy + m10 * woz + m11,
                         m0 * wdx + m1 * wdy + m2 * wdz,
                         m4 * wdx + m5 * wdy + m6 * wdz,
                         m8 * wdx + m9 * wdy + m10 * wdz);
          cur_inst = iid;
          cur = static_cast<int>(__ldg(m + 12));
        }
      }
    }
  }

  if (kClosest) {
    t_out[i] = best_t;
    u_out[i] = best_u;
    v_out[i] = best_v;
    prim_out[i] = best_prim;
    inst_out[i] = best_inst;
  } else {
    prim_out[i] = occluded ? 1 : 0;
  }
  flags_out[i] = flags;
}

struct Tables {
  const float4* nodes;
  int n_nodes;
  const float* groups;
  int n_groups;
  const float* inst;
  int n_inst;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  int n;
};

template <bool kClosest, int kMaxStack>
void launch(cudaStream_t stream, const Tables& tb, const Rays& r,
            int stack_cap, int64_t max_steps, float* t, float* u, float* v,
            int* prim, int* inst, int* flags) {
  const int grid = (r.n + kBlock - 1) / kBlock;
  traverse_kernel<kClosest, kMaxStack><<<grid, kBlock, 0, stream>>>(
      tb.nodes, tb.n_nodes, tb.groups, tb.n_groups, tb.inst, tb.n_inst,
      r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmax, r.n, stack_cap, max_steps,
      t, u, v, prim, inst, flags);
}

template <bool kClosest>
ffi::Error dispatch(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                    ffi::Buffer<ffi::F32> groups, ffi::Buffer<ffi::F32> inst,
                    ffi::Buffer<ffi::F32> ox, ffi::Buffer<ffi::F32> oy,
                    ffi::Buffer<ffi::F32> oz, ffi::Buffer<ffi::F32> dx,
                    ffi::Buffer<ffi::F32> dy, ffi::Buffer<ffi::F32> dz,
                    ffi::Buffer<ffi::F32> tmax, int64_t stack_depth,
                    int64_t max_steps, float* t, float* u,
                    float* v, int* prim, int* inst_out, int* flags) {
  const size_t n = tmax.element_count();
  for (const auto* b : {&ox, &oy, &oz, &dx, &dy, &dz}) {
    if (b->element_count() != n) {
      return ffi::Error::InvalidArgument("ray component lengths differ");
    }
  }
  if (n == 0) return ffi::Error::Success();
  if (n > static_cast<size_t>(INT32_MAX)) {
    return ffi::Error::InvalidArgument("more than 2^31 - 1 rays");
  }
  if (stack_depth < 1 || stack_depth > 128) {
    return ffi::Error::InvalidArgument("stack_depth must be in [1, 128]");
  }
  if (nodes.element_count() % 16 != 0 ||
      groups.element_count() % (kGroupRows * kLeafW) != 0) {
    return ffi::Error::InvalidArgument("malformed dense BVH tables");
  }
  const Tables tb{reinterpret_cast<const float4*>(nodes.typed_data()),
                  static_cast<int>(nodes.element_count() / 16),
                  groups.typed_data(),
                  static_cast<int>(groups.element_count() /
                                   (kGroupRows * kLeafW)),
                  inst.typed_data(),
                  static_cast<int>(inst.element_count() / kInstF)};
  const Rays r{ox.typed_data(), oy.typed_data(), oz.typed_data(),
               dx.typed_data(), dy.typed_data(), dz.typed_data(),
               tmax.typed_data(), static_cast<int>(n)};
  const int cap = static_cast<int>(stack_depth);
  if (cap <= 32) {
    launch<kClosest, 32>(stream, tb, r, cap, max_steps, t, u, v, prim,
                         inst_out, flags);
  } else if (cap <= 64) {
    launch<kClosest, 64>(stream, tb, r, cap, max_steps, t, u, v, prim,
                         inst_out, flags);
  } else {
    launch<kClosest, 128>(stream, tb, r, cap, max_steps, t, u, v, prim,
                          inst_out, flags);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("traversal launch failed: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error closest_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::F32> groups,
                        ffi::Buffer<ffi::F32> inst, ffi::Buffer<ffi::F32> ox,
                        ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                        ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                        ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> tmax,
                        int64_t stack_depth, int64_t max_steps,
                        ffi::ResultBuffer<ffi::F32> t,
                        ffi::ResultBuffer<ffi::F32> u,
                        ffi::ResultBuffer<ffi::F32> v,
                        ffi::ResultBuffer<ffi::S32> prim,
                        ffi::ResultBuffer<ffi::S32> inst_out,
                        ffi::ResultBuffer<ffi::S32> flags) {
  return dispatch<true>(stream, nodes, groups, inst, ox, oy, oz, dx, dy, dz,
                        tmax, stack_depth, max_steps, t->typed_data(),
                        u->typed_data(), v->typed_data(), prim->typed_data(),
                        inst_out->typed_data(), flags->typed_data());
}

ffi::Error any_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                    ffi::Buffer<ffi::F32> groups, ffi::Buffer<ffi::F32> inst,
                    ffi::Buffer<ffi::F32> ox, ffi::Buffer<ffi::F32> oy,
                    ffi::Buffer<ffi::F32> oz, ffi::Buffer<ffi::F32> dx,
                    ffi::Buffer<ffi::F32> dy, ffi::Buffer<ffi::F32> dz,
                    ffi::Buffer<ffi::F32> tmax, int64_t stack_depth,
                    int64_t max_steps,
                    ffi::ResultBuffer<ffi::S32> occluded,
                    ffi::ResultBuffer<ffi::S32> flags) {
  return dispatch<false>(stream, nodes, groups, inst, ox, oy, oz, dx, dy, dz,
                         tmax, stack_depth, max_steps, nullptr,
                         nullptr, nullptr, occluded->typed_data(), nullptr,
                         flags->typed_data());
}

}  // namespace

#define PBRT_TRAVERSE_ARGS                                 \
  .Ctx<ffi::PlatformStream<cudaStream_t>>()                \
      .Arg<ffi::Buffer<ffi::F32>>()   /* nodes16 */        \
      .Arg<ffi::Buffer<ffi::F32>>()   /* groups */         \
      .Arg<ffi::Buffer<ffi::F32>>()   /* inst16 */         \
      .Arg<ffi::Buffer<ffi::F32>>()   /* ox */             \
      .Arg<ffi::Buffer<ffi::F32>>()   /* oy */             \
      .Arg<ffi::Buffer<ffi::F32>>()   /* oz */             \
      .Arg<ffi::Buffer<ffi::F32>>()   /* dx */             \
      .Arg<ffi::Buffer<ffi::F32>>()   /* dy */             \
      .Arg<ffi::Buffer<ffi::F32>>()   /* dz */             \
      .Arg<ffi::Buffer<ffi::F32>>()   /* tmax */           \
      .Attr<int64_t>("stack_depth")                        \
      .Attr<int64_t>("max_steps")

XLA_FFI_DEFINE_HANDLER_SYMBOL(PbrtTraceClosest, closest_impl,
                              ffi::Ffi::Bind() PBRT_TRAVERSE_ARGS
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t
                                  .Ret<ffi::Buffer<ffi::F32>>()   // u
                                  .Ret<ffi::Buffer<ffi::F32>>()   // v
                                  .Ret<ffi::Buffer<ffi::S32>>()   // prim
                                  .Ret<ffi::Buffer<ffi::S32>>()   // inst
                                  .Ret<ffi::Buffer<ffi::S32>>()); // flags

XLA_FFI_DEFINE_HANDLER_SYMBOL(PbrtTraceAny, any_impl,
                              ffi::Ffi::Bind() PBRT_TRAVERSE_ARGS
                                  .Ret<ffi::Buffer<ffi::S32>>()   // occluded
                                  .Ret<ffi::Buffer<ffi::S32>>()); // flags
