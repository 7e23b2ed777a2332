// Per-ray two-level traversal (kernel K3): a world-space binary TLAS over
// instance boxes, then each reached instance's 4-wide BLAS in object
// space, nearest or any hit.
//
// Replaces the TPU kernel tpu_raytracer/kernels/tlas.py:_tlas_kernel. It
// computes what that kernel computes — one shared t per ray across the
// whole two-level walk, instances visited nearest first so that a close
// hit culls farther instances at their TLAS box — as one thread per ray
// with a private 48-slot TLAS stack (tlas.py TLAS_STACK) beside the
// BLAS walk's 192-slot stack, instead of 4096-ray packets sharing SMEM
// stacks. The BLAS walk is K1's own walk_instance (wide_traverse.cuh).
//
// Visit order, which decides tri/inst at exact-t ties (tlas.py:20-31), is
// the TPU kernel's (tlas.py:478-508): at an internal node both child
// boxes are slab-tested against the ray's current t; the nearer child is
// visited first and child a wins a tie (da <= db). At a leaf the
// instances are walked in inst_ids order, and every hit records its
// instance id. The plain PyTorch version (kernels/tlas.py) keeps the same
// order, so the two agree bit for bit.
//
// What bounds it on an H100: as K1, dependent global loads — a TLAS node
// (one code, 12 box floats), then BLAS nodes and triangle records — with
// a few dozen flops each, and divergence within a warp once rays stop
// being coherent (reflection and shadow rays from scattered hit points
// reach different instances in different orders). The simple design
// relies on every table of these scenes (the TLAS has 2I-1 nodes; the
// BLAS tables are K1's) fitting in the 50 MB L2, and on enough resident
// warps to hide the load latency. Sorting secondary rays for coherence,
// treelets in shared memory and persistent threads are later work.
//
// Plain C++ for nvcc and a host compiler (csrc/tlas_traverse_host.cpp
// serves the CPU tests); built with --fmad=false / -ffp-contract=off like
// K1, and sharing K1's safe_inv and child_entry for the TLAS slab test.
#pragma once

#include "wide_traverse.cuh"

namespace wt {

constexpr int kTlasStack = 48;  // kernels/tlas.py TLAS_STACK

struct Tlas {
  const int32_t* code;      // [Nt]: internal -> child b (child a = node + 1);
                            // leaf -> -(start * 1024 + count) - 1
  const float* box;         // [Nt, 12]: child a's box, child b's box
                            // (min xyz, max xyz each, NUDGE baked in)
  const int32_t* inst_ids;  // [I]: leaf position -> instance id
};

// Nearest (or any) hit of one world ray through the TLAS. The root is
// entered without a box test, as the TPU kernel does.
WT_HD Hit trace_ray_tlas(const Scene& s, const Tlas& tl, const float* wo,
                         const float* wd, bool any_hit) {
  Hit best{kBig, -1, -1};
  const float inv[3] = {safe_inv(wd[0]), safe_inv(wd[1]), safe_inv(wd[2])};
  int32_t stack[kTlasStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int32_t node = stack[--sp];
    const int32_t code = tl.code[node];
    if (code >= 0) {
      const float* b = tl.box + 12 * node;
      const float da = child_entry(b, wo, inv, best.t);
      const float db = child_entry(b + 6, wo, inv, best.t);
      // the nearer child is pushed last, so it pops first
      if (da <= db) {
        if (db < kBig) stack[sp++] = code;
        if (da < kBig) stack[sp++] = node + 1;
      } else {
        if (da < kBig) stack[sp++] = node + 1;
        if (db < kBig) stack[sp++] = code;
      }
      continue;
    }
    const int32_t packed = -code - 1;
    const int32_t start = packed >> 10;
    const int32_t n = packed & 1023;
    for (int32_t p = start; p < start + n; ++p) {
      walk_instance(s, tl.inst_ids[p], wo, wd, any_hit, &best);
      if (any_hit && best.t < 0.0f) return best;
    }
  }
  if (best.t >= kBig) best.t = kFltMax;
  return best;
}

}  // namespace wt
