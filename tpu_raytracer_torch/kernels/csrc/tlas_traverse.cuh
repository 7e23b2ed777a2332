// Per-ray two-level traversal (kernel K3): a world-space binary TLAS over
// instance boxes, then each reached instance's 4-wide BLAS in object
// space, nearest or any hit.
//
// Replaces the TPU kernel tpu_raytracer/kernels/tlas.py:_tlas_kernel. It
// computes what that kernel computes — one shared t per ray across the
// whole two-level walk, instances visited nearest first so that a close
// hit culls farther instances at their TLAS box — as one thread per ray
// instead of 4096-ray packets sharing SMEM stacks. The BLAS walk is K1's
// walk<4> (walk.cuh), and the TLAS walk shares its short stack: TLAS
// entries sit below, and each BLAS walk pushes and pops above them until
// the stack is back at its base. The wrapper checks that the TLAS depth
// plus the BLAS's stack_needed fit the stack's kStack entries.
//
// Visit order, which decides tri/inst at exact-t ties (tlas.py:20-31), is
// the TPU kernel's (tlas.py:478-508) in nearest mode: at an internal node
// both child boxes are slab-tested against the ray's current t; the nearer
// child is visited first and child a wins a tie (da <= db). At a leaf the
// instances are walked in inst_ids order, and every hit records its
// instance id. The plain PyTorch version (kernels/tlas.py) keeps the same
// order, so the two agree bit for bit. In any-hit mode the children are
// taken in child order (walk.cuh says why any order gives the same
// answer).
//
// What bounds it on an H100: as K1 (walk.cuh), dependent loads and the
// instructions around them — a TLAS node (one code, 12 box floats as 3
// float4), then BLAS nodes and triangle records — and divergence within a
// warp once rays stop being coherent (reflection and shadow rays from
// scattered hit points reach different instances in different orders).
// Every table of these scenes fits in the 50 MB L2.
//
// Plain C++ for nvcc and a host compiler (csrc/traverse_host.cpp serves
// the CPU tests); built with --fmad=false / -ffp-contract=off like K1.
#pragma once

#include "walk.cuh"

namespace wt {

struct Tlas {
  const int32_t* code;      // [Nt]: internal -> child b (child a = node + 1);
                            // leaf -> -(start * 1024 + count) - 1
  const float* box;         // [Nt, 12]: child a's box, child b's box
                            // (min xyz, max xyz each, NUDGE baked in)
  const int32_t* inst_ids;  // [I]: leaf position -> instance id
};

// Nearest (or any) hit of one world ray through the TLAS. The root is
// entered without a box test, as the TPU kernel does. With kCarry the
// hit's carried fields (walk.cuh Carry) go to `carry`.
template <bool kAnyHit, bool kCarry = false>
WT_HD Hit trace_ray_tlas4(const Scene& s, const Tlas& tl, const float* wo, const float* wd,
                          ShortStack& st, Carry* carry = nullptr) {
  Hit best{kBig, -1, -1};
  const float inv[3] = {safe_inv(wd[0]), safe_inv(wd[1]), safe_inv(wd[2])};
  int32_t node = 0;
  for (;;) {
    const int32_t code = tl.code[node];
    int32_t next = -1;
    if (code >= 0) {
      float b[12];
      const float* rec = tl.box + 12 * static_cast<int64_t>(node);
      load4(rec, b);
      load4(rec + 4, b + 4);
      load4(rec + 8, b + 8);
      const float cap = best.t * kCapSlack;
      const float da = slab_entry(b[0], b[1], b[2], b[3], b[4], b[5], wo, inv, cap);
      const float db = slab_entry(b[6], b[7], b[8], b[9], b[10], b[11], wo, inv, cap);
      // farther child first, so the nearer is the next node
      if (kAnyHit || da <= db) {
        if (db < kBig) defer(st, next, code);
        if (da < kBig) defer(st, next, node + 1);
      } else {
        if (da < kBig) defer(st, next, node + 1);
        if (db < kBig) defer(st, next, code);
      }
    } else {
      const int32_t packed = -code - 1;
      const int32_t start = packed >> 10;
      const int32_t n = packed & 1023;
      for (int32_t p = start; p < start + n; ++p) {
        if (walk_instance<4, kAnyHit, kCarry>(s, tl.inst_ids[p], wo, wd, st, &best, carry)) {
          return best;
        }
      }
    }
    if (next >= 0) {
      node = next;
    } else if (st.sp > 0) {
      node = st.pop();
    } else {
      break;
    }
  }
  if (best.t >= kBig) best.t = kFltMax;
  return best;
}

}  // namespace wt
