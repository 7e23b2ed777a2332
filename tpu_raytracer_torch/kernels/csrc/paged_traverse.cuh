// Per-ray traversal of a paged BVH: kernels K4 (4-wide pages), K5
// (binary pages) and K6 (page-major order), nearest hit.
//
// Replaces the TPU kernels tpu_raytracer/kernels/paged_wide.py:
// _paged_wide_kernel (K4, with its in-page walk make_inpage_traverser),
// kernels/paged.py:_paged_kernel (K5) and kernels/paged_major.py:
// _page_major_kernel (K6). The scene's BVH is cut into pages (subtrees of
// at most page_tris triangles and page_nodes binary nodes,
// accel/paging.py) under a small binary top tree whose leaves are
// portals to pages. Each page is stored as its own tree of node records
// (walk.cuh) with page-local node ids (root 0) and leaf starts relative
// to the page's first triangle, so triangle ids in the hit record stay
// global.
//
// The TPU kernels exist because a big scene does not fit the TPU core's
// VMEM: they DMA one page at a time from HBM. On the card every table
// stays in device memory and a thread reads what it needs, so the
// translation keeps what they compute and drops the staging:
//   * K4 and K5 (trace_ray_paged<A>): one thread per ray on persistent
//     warps walks the top tree as K3 walks its TLAS (tlas_traverse.cuh): a
//     top node's two boxes as 3 float4 loads, the nearer child next, the
//     other on the short stack of walk.cuh. At a portal the thread walks
//     that page's node records with walk<A> (A = 4 for K4, 2 for K5),
//     leaf starts counting from the page's first triangle, on the same
//     stack above the top-tree entries, then resumes the top tree.
//   * K6 (trace_ray_page_major): a plan (page_plan.cuh) orders the
//     (instance, page) items front to back and lists, for each tile of
//     kTileRays consecutive rays, the items the tile may see. Each thread
//     walks its tile's items in plan order with walk<4>, its best hit in
//     registers; no top tree is walked.
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
// dependent loads (top nodes, page node records, 16-float triangle
// records) and divergence within a warp. The 1M-triangle colonnade's
// tables (~66 MB of triangle records) overflow the 50 MB L2, so misses go
// to HBM.
//
// Plain C++ for nvcc and a host compiler (csrc/traverse_host.cpp serves
// the CPU tests); built with --fmad=false / -ffp-contract=off like K1.
#pragma once

#include "walk.cuh"

namespace wt {

constexpr int kTileRays = 256;  // kernels/paged_major.py TILE_RAYS

// The pages of a paged scene, all of one arity A.
struct Pages {
  const float* node;         // [N, node_lanes(A)] page-local node records (walk.cuh)
  const int32_t* node_base;  // [P] row of each page's root in node
  const int32_t* tri0;       // [P] first (global) triangle of each page
  const float* tri_rec;      // [T, 16]
  const float* inst_tab;     // [I, 12]
  int num_instances;

  // Node records of page `pid`'s tree.
  WT_HDM const float* page(int32_t pid, int arity) const {
    return node + node_lanes(arity) * static_cast<int64_t>(node_base[pid]);
  }
};

// The compacted binary top tree (accel/paging.py), in the TLAS's code
// layout: internal -> child b (child a = node + 1); portal -> -(page + 1).
struct TopTree {
  const int32_t* code;  // [Nt]
  const float* box;     // [Nt, 12] child a's box, child b's box (NUDGE baked)
  const int32_t* root;  // [I] top-tree root of each instance's mesh
};

// The page-major plan (page_plan.cuh): items (instance, page) front to
// back, and for each tile of kTileRays consecutive rays the plan
// positions of the items it may see, ascending.
struct Plan {
  const int32_t* item_pid;    // [K] page of the item at each plan position
  const int32_t* item_iid;    // [K] its instance
  const int32_t* tile_start;  // [num_tiles + 1] each tile's first entry in tile_item
  const int32_t* tile_item;   // [nnz] plan positions, tile by tile
};

// K4 (kArity 4) and K5 (kArity 2): nearest hit of one world ray through
// each instance's top tree and the pages its portals lead to. The top root
// is entered without a box test. Per instance the top tree is walked as K3
// walks its TLAS: both child boxes are tested against the ray's current
// t, the nearer child becomes the next node, child a winning a tie
// (da <= db, the JAX kernels' pop1_top order), and the farther is pushed.
// Its entries share `st` with each page walk's, which sit above them until
// the page is done, so the stack holds at most top_depth + (A - 1) * page
// depth + 4 entries (checked by the wrapper).
template <int kArity>
WT_HD Hit trace_ray_paged(const Pages& pg, const TopTree& top, const float* wo,
                          const float* wd, ShortStack& st) {
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
        walk<kArity, false>(pg.page(pid, kArity), 0, pg.tri0[pid], pg.tri_rec, o, d, inv,
                            inst_val, st, &best);
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

// K6: nearest hit of one world ray of tile `tile`, walking the 4-wide
// pages of the tile's plan items in plan order. The object-space ray is
// computed again only when an item's instance differs from the previous
// item's (once per ray for a single instance); object_ray is a pure
// function, so its bits do not depend on when it runs.
WT_HD Hit trace_ray_page_major(const Pages& pg, const Plan& plan, int64_t tile,
                               const float* wo, const float* wd, ShortStack& st) {
  Hit best{kBig, -1, -1};
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f}, inv[3] = {0.0f, 0.0f, 0.0f};
  int32_t cur = -1;  // the instance whose object-space ray o, d, inv hold
  const int32_t end = plan.tile_start[tile + 1];
  for (int32_t j = plan.tile_start[tile]; j < end; ++j) {
    const int32_t k = plan.tile_item[j];
    const int32_t i = plan.item_iid[k];
    if (i != cur) {
      object_ray(pg.inst_tab + 12 * i, wo, wd, o, d, inv);
      cur = i;
    }
    const int32_t pid = plan.item_pid[k];
    walk<4, false>(pg.page(pid, 4), 0, pg.tri0[pid], pg.tri_rec, o, d, inv,
                   pg.num_instances == 1 ? -1 : i, st, &best);
  }
  return finish_hit(best, pg.num_instances);
}

}  // namespace wt
