// Per-ray traversal of a paged BVH: kernels K4 (4-wide pages), K5
// (binary pages) and K6 (page-major order), nearest hit.
//
// Replaces the TPU kernels tpu_raytracer/kernels/paged_wide.py:
// _paged_wide_kernel (K4, with its in-page walk make_inpage_traverser),
// kernels/paged.py:_paged_kernel (K5) and kernels/paged_major.py:
// _page_major_kernel (K6). The scene's BVH is cut into pages (subtrees of
// at most page_tris triangles and page_nodes binary nodes,
// accel/paging.py) under a small binary top tree whose leaves are
// portals to pages. Each page is stored as its own tree in the
// child-code layout (accel/wide.py) with page-local node ids (root 0)
// and leaf starts relative to the page's first triangle, so triangle ids
// in the hit record stay global.
//
// The TPU kernels exist because a big scene does not fit the TPU core's
// VMEM: they DMA one page at a time from HBM. On the card every table
// stays in device memory and a thread reads what it needs, so the
// translation keeps what they compute and drops the staging:
//   * K4 (trace_ray_paged4): one thread per ray on persistent warps walks
//     the top tree as K3 walks its TLAS (tlas_traverse.cuh): a top node's
//     two boxes as 3 float4 loads, the nearer child next, the other on
//     the short stack of walk.cuh. At a portal the thread walks that
//     page's 4-wide node records with walk<4> (walk.cuh), leaf starts
//     counting from the page's first triangle, on the same stack above
//     the top-tree entries, then resumes the top tree.
//   * K5 (trace_ray_paged<2>): one thread per ray, a private stack for
//     the top tree; at a portal the thread walks that page's binary tree
//     with walk_tree<2> (wide_traverse.cuh), from global memory.
//   * K6 (trace_ray_page_major): the host plans (instance, page) items
//     front to back with a conservative per-tile visibility mask
//     (kernels/paged_major.py); each thread walks, in that order, the
//     items its 256-ray tile may see, with its t_best in registers and
//     walk_tree<4> in each page. No top tree is walked.
// The instance loop and the quaternion object space are K1's, and so is
// the accept rule: strict t < t_best, an exact-t tie goes to the lower
// instance, boxes culled against t_best widened by kCapSlack. The nearest
// t is the same whatever the visit order (t is only ever lowered to a
// strictly smaller accepted distance, and boxes are conservative), so
// every paged walk gives K1's t on the same scene but where a hit accepted
// up to EDGE_EPS outside its leaf box is kept or culled by box order;
// tri/inst can differ from K1's only there or where two triangles tie on t
// exactly.
//
// What bounds it on an H100: as K1 (walk.cuh), the instructions around
// dependent loads (top nodes, page nodes, 16-float triangle records) and
// divergence within a warp; K5 and K6 still read a node's codes and boxes
// as scalar loads from two tables. The 1M-triangle colonnade's tables
// (~66 MB of triangle records) overflow the 50 MB L2, so misses go to HBM.
//
// Plain C++ for nvcc and a host compiler (csrc/traverse_host.cpp serves
// the CPU tests); built with --fmad=false / -ffp-contract=off like K1.
#pragma once

#include "walk.cuh"

namespace wt {

constexpr int kTopStack = 64;  // kernels/paged.py TOP_STACK (K5's top-tree stack)
constexpr int kTileRays = 256;  // kernels/paged_major.py TILE_RAYS

// The pages of a paged scene, all in one arity's child-code layout (K4
// reads the same pages' node records, kernels/paged.py `node`).
struct Pages {
  const int32_t* code;       // [N, A] page-local child codes
  const float* box;          // [N, box_stride(A)] page-local child boxes
  const int32_t* node_base;  // [P] row of each page's root in code/box
  const int32_t* tri0;       // [P] first (global) triangle of each page
  const float* tri_rec;      // [T, 16]
  const float* inst_tab;     // [I, 12]
  int num_instances;
};

// The compacted binary top tree (accel/paging.py), in the TLAS's code
// layout: internal -> child b (child a = node + 1); portal -> -(page + 1).
struct TopTree {
  const int32_t* code;  // [Nt]
  const float* box;     // [Nt, 12] child a's box, child b's box (NUDGE baked)
  const int32_t* root;  // [I] top-tree root of each instance's mesh
};

// The page-major plan: items (instance, page) front to back, and for
// each item the tiles of kTileRays consecutive rays that may see it.
struct Plan {
  const int32_t* item_pid;  // [K]
  const int32_t* item_iid;  // [K]
  int num_items;
  const uint8_t* mask;      // [K, num_tiles] 1: the tile may see the item
  int num_tiles;
};

template <int kArity>
WT_HD void walk_page(const Pages& pg, int32_t pid, const float* o,
                     const float* d, const float* inv, int32_t inst_val,
                     Hit* best) {
  const int32_t base = pg.node_base[pid];
  walk_tree<kArity>(pg.code + kArity * base, pg.box + box_stride(kArity) * base,
                    0, pg.tri0[pid], pg.tri_rec, o, d, inv, inst_val, false,
                    best);
}

// K5 (kArity 2): nearest hit of one world ray through each instance's
// top tree and the pages its portals lead to. The top root is entered
// without a box test; at an internal node both child boxes are tested
// against the ray's current t and the nearer child is visited first,
// child a on a tie (the JAX kernels' pop1_top order).
template <int kArity>
WT_HD Hit trace_ray_paged(const Pages& pg, const TopTree& top, const float* wo,
                          const float* wd) {
  Hit best{kBig, -1, -1};
  for (int i = 0; i < pg.num_instances; ++i) {
    float o[3], d[3], inv[3];
    object_ray(pg.inst_tab + 12 * i, wo, wd, o, d, inv);
    const int32_t inst_val = pg.num_instances == 1 ? -1 : i;
    int32_t stack[kTopStack];
    int sp = 0;
    stack[sp++] = top.root[i];
    while (sp > 0) {
      const int32_t node = stack[--sp];
      const int32_t code = top.code[node];
      if (code < 0) {
        walk_page<kArity>(pg, -code - 1, o, d, inv, inst_val, &best);
        continue;
      }
      const float* b = top.box + 12 * node;
      const float da = child_entry(b, o, inv, best.t);
      const float db = child_entry(b + 6, o, inv, best.t);
      // the nearer child is pushed last, so it pops first
      if (da <= db) {
        if (db < kBig) stack[sp++] = code;
        if (da < kBig) stack[sp++] = node + 1;
      } else {
        if (da < kBig) stack[sp++] = node + 1;
        if (db < kBig) stack[sp++] = code;
      }
    }
  }
  return finish_hit(best, pg.num_instances);
}

// K4: trace_ray_paged's visits with walk.cuh's design, over the 4-wide
// pages' node records `node` [N, 32]. Per instance the top tree is walked
// as K3 walks its TLAS: the nearer child becomes the next node, child a
// winning a tie (da <= db), and the farther is pushed. Its entries share
// `st` with each page walk's, which sit above them until the page is
// done, so the stack holds at most top_depth + stack_needed(page depth)
// entries (checked by the wrapper).
WT_HD Hit trace_ray_paged4(const Pages& pg, const float* node, const TopTree& top,
                           const float* wo, const float* wd, ShortStack& st) {
  Hit best{kBig, -1, -1};
  ShortStack& top_st = st;
  for (int i = 0; i < pg.num_instances; ++i) {
    float o[3], d[3], inv[3];
    object_ray(pg.inst_tab + 12 * i, wo, wd, o, d, inv);
    const int32_t inst_val = pg.num_instances == 1 ? -1 : i;
    int32_t cur = top.root[i];
    for (;;) {
      const int32_t code = top.code[cur];
      int32_t next = -1;
      if (code >= 0) {
        float b[12];
        const float* rec = top.box + 12 * static_cast<int64_t>(cur);
        load4(rec, b);
        load4(rec + 4, b + 4);
        load4(rec + 8, b + 8);
        const float cap = best.t * kCapSlack;
        const float da = slab_entry(b[0], b[1], b[2], b[3], b[4], b[5], o, inv, cap);
        const float db = slab_entry(b[6], b[7], b[8], b[9], b[10], b[11], o, inv, cap);
        // farther child first, so the nearer is the next node
        if (da <= db) {
          if (db < kBig) defer(top_st, next, code);
          if (da < kBig) defer(top_st, next, cur + 1);
        } else {
          if (da < kBig) defer(top_st, next, cur + 1);
          if (db < kBig) defer(top_st, next, code);
        }
      } else {
        const int32_t pid = -code - 1;
        walk<4, false>(node + node_lanes(4) * static_cast<int64_t>(pg.node_base[pid]), 0,
                       pg.tri0[pid], pg.tri_rec, o, d, inv, inst_val, st, &best);
      }
      if (next >= 0) {
        cur = next;
      } else if (top_st.sp > 0) {
        cur = top_st.pop();
      } else {
        break;
      }
    }
  }
  return finish_hit(best, pg.num_instances);
}

// K6: nearest hit of one world ray in tile `tile`, walking the 4-wide
// pages of the plan's items in plan order, skipping the items the tile
// cannot see.
WT_HD Hit trace_ray_page_major(const Pages& pg, const Plan& plan, int tile,
                               const float* wo, const float* wd) {
  Hit best{kBig, -1, -1};
  for (int k = 0; k < plan.num_items; ++k) {
    if (!plan.mask[static_cast<int64_t>(k) * plan.num_tiles + tile]) continue;
    const int i = plan.item_iid[k];
    float o[3], d[3], inv[3];
    object_ray(pg.inst_tab + 12 * i, wo, wd, o, d, inv);
    walk_page<4>(pg, plan.item_pid[k], o, d, inv,
                 pg.num_instances == 1 ? -1 : i, &best);
  }
  return finish_hit(best, pg.num_instances);
}

}  // namespace wt
