// The pieces every traversal kernel shares (constants, the scene's
// tables, the instance transform, the triangle test, the output record).
// K1-K6 walk with walk.cuh, built on the pieces here. test_tri is the
// plain versions' triangle test (kernels/traversal.py _test_tris) op for
// op; walk.cuh's test_tri4 is the same test with early exits.
//
// Any-hit mode (make_test_tri's `occlusion` in
// tpu_raytracer/kernels/traversal.py, for shadow rays): the first
// accepted triangle sets the ray's t to -kBig. The TPU kernel can only
// mask the lane off after that; a thread returns at once, with the same
// result. Output t is then -kBig (occluded) or kFltMax (clear); tri and
// inst are whatever the walk reached and carry no meaning.
//
// The header is plain C++ usable from both nvcc and a host compiler, so
// the traversal itself is tested on the CPU (csrc/traverse_host.cpp)
// before any card runs it. Build with --fmad=false (nvcc) or
// -ffp-contract=off (g++): the math below keeps make_test_tri's f32
// operation order, and a fused multiply-add would round differently from
// the plain PyTorch version.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define WT_HD __host__ __device__ __forceinline__
#else
#define WT_HD static inline
#endif

namespace wt {

constexpr int kStack = 192;           // kernels/wide4.py STACK_SIZE
constexpr float kBig = 3.0e38f;       // t_best start (dual.py BIG)
constexpr float kFltMax = 3.4028235e38f;  // miss sentinel
constexpr float kParallelEps = 1e-6f;
constexpr float kEdgeLo = -1e-3f;     // -EDGE_EPS
constexpr float kEdgeHi = 1.001f;     // f32(1 + EDGE_EPS)
constexpr float kTiny = 1e-30f;
// Boxes are culled against t_best widened by this factor (8 ulps). The
// slab entry of a flat box (an axis-aligned wall: pad 0, NUDGE lost in
// rounding) can round an ulp or two past the t of a triangle lying on
// it, and a strict near < t_best test would then cull a box that holds
// an exact-t tie. With the lower-instance tie rule of test_tri, the
// widened cap makes cross-instance ties resolve as the linear instance
// loop does, whatever order the instances are visited in. It only adds
// visits, so t never changes; an any-hit ray's cap -kBig stays below
// every entry distance.
constexpr float kCapSlack = 1.0f + 1.0f / 1048576.0f;

// One scene's tables for a walk of arity A (walk.cuh): K1 and K3 read the
// 4-wide tree's records, K2 the binary tree's (kernels/binary.py).
struct Scene {
  const float* node;       // [W, 8A] node records (walk.cuh)
  const float* tri_rec;    // [T, 16]: v0, n, rA, rB, 4 spare
  const float* inst_tab;   // [I, 12]: quat wxyz, position, inverse scale
  const int32_t* inst_root;  // [I] tree root per instance
  int num_instances;
};

struct Hit {
  float t;
  int32_t tri;
  int32_t inst;
};

// quat_rot of tpu_raytracer/kernels/traversal.py:_quat_rot, same op order.
WT_HD void quat_rot(const float* q, float vx, float vy, float vz,
                    float* rx, float* ry, float* rz) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float a = -vx * qx - vy * qy - vz * qz;
  const float b = vx * qw + vy * qz - vz * qy;
  const float c = vy * qw + vz * qx - vx * qz;
  const float d = vz * qw + vx * qy - vy * qx;
  *rx = qw * b - qx * a - qy * d + qz * c;
  *ry = qw * c - qy * a - qz * b + qx * d;
  *rz = qw * d - qz * a - qx * c + qy * b;
}

WT_HD float safe_inv(float v) {
  const float s = fabsf(v) < kTiny ? (v < 0.0f ? -kTiny : kTiny) : v;
  return 1.0f / s;
}

// make_test_tri for one (ray, triangle): strict t < best->t update, and
// at an exact-t tie the lower instance id wins. That tie rule is the
// linear instance loop's (instances in index order, strict <), so the
// result does not depend on the order instances are visited in: K1
// visits them in index order, where the rule never fires, and K3 in its
// TLAS's spatial order. Returns whether the triangle was accepted.
WT_HD bool test_tri(const float* r, const float* o, const float* d,
                    int32_t k, int32_t inst, bool any_hit, Hit* best) {
  const float denom = d[0] * r[3] + d[1] * r[4] + d[2] * r[5];
  const float cx = r[0] - o[0];
  const float cy = r[1] - o[1];
  const float cz = r[2] - o[2];
  const float num = cx * r[3] + cy * r[4] + cz * r[5];
  const float t = num / denom;
  const float e2x = t * d[0] - cx;
  const float e2y = t * d[1] - cy;
  const float e2z = t * d[2] - cz;
  const float u = r[6] * e2x + r[7] * e2y + r[8] * e2z;
  const float v = r[9] * e2x + r[10] * e2y + r[11] * e2z;
  const bool ok = (denom <= -kParallelEps) && (u >= kEdgeLo) &&
                  (v >= kEdgeLo) && (u + v <= kEdgeHi) && (t >= 0.0f) &&
                  (t < best->t || (t == best->t && inst < best->inst));
  if (ok) {
    best->t = any_hit ? -kBig : t;
    best->tri = k;
    best->inst = inst;
  }
  return ok;
}

// Object-space ray of the instance whose 12-float row is `q`
// (quaternion wxyz, position, inverse scale): direction d, origin o and
// the safe reciprocal direction inv.
WT_HD void object_ray(const float* q, const float* wo, const float* wd,
                      float* o, float* d, float* inv) {
  const float px = q[4], py = q[5], pz = q[6];
  const float sx = q[7], sy = q[8], sz = q[9];
  quat_rot(q, wd[0], wd[1], wd[2], &d[0], &d[1], &d[2]);
  d[0] = d[0] * sx;
  d[1] = d[1] * sy;
  d[2] = d[2] * sz;
  quat_rot(q, wo[0] - px, wo[1] - py, wo[2] - pz, &o[0], &o[1], &o[2]);
  o[0] = o[0] * sx;
  o[1] = o[1] * sy;
  o[2] = o[2] * sz;
  inv[0] = safe_inv(d[0]);
  inv[1] = safe_inv(d[1]);
  inv[2] = safe_inv(d[2]);
}

// The output record: a single-instance scene reports inst 0 on a hit
// (dual.py output stage), and a miss (no triangle accepted; a bounded walk
// ends one with t at its bound) reports t = FLT_MAX.
WT_HD Hit finish_hit(Hit best, int num_instances) {
  if (num_instances == 1) best.inst = best.tri >= 0 ? 0 : -1;
  if (best.tri < 0) best.t = kFltMax;
  return best;
}

}  // namespace wt
