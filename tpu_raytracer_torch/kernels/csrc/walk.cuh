// The walk of kernels K1-K6, designed for the H100, at arity 4 and 2.
//
// K1 (wide_traverse.cu) walks every instance's 4-wide BVH in turn, K2
// (wide_traverse.cu) every instance's binary BVH, K3 (tlas_traverse.cu)
// the instances its TLAS reaches in their 4-wide BVH, K4 and K5
// (paged_traverse.cu) the 4-wide or binary pages their top tree's portals
// open, and K6 (paged_major.cu) the 4-wide pages of its tile's plan
// items; all walk each tree with walk<A> below. It computes what the plain
// versions' walk (kernels/traversal.py walk_tree: a private stack, an
// O(A^2) rank loop, NaN-aware min/max, the triangle test without early
// exits) computes, event for event per ray, and differs in how:
//
//  * One node record of 8A floats (kernels/wide4.py `node_records`: K1's
//    and K3's `wnode [W, 32]`, K2's binary `node [N, 16]`, the pages'
//    `node`, [N, 32] for K4 and K6, [N, 16] for K5): the 6A box floats
//    (lane 6c + k holds child c's coordinate k: min xyz, max xyz) and the
//    A child codes bit-cast into lanes 6A .. 7A-1. A pop is 6A/4 float4
//    loads and 1 int4 load (7 at A = 4, 4 at A = 2) instead of 7A scalar
//    ones from two tables, and a triangle test reads its record
//    (tri_rec [T, 16]) as 3 float4. The wrappers check every table for
//    16-byte alignment.
//  * A short stack (ShortStack): the top S entries of each thread's stack
//    in a ring of S slots in shared memory, laid out [slot][thread] so that
//    a warp's pushes hit 32 banks; older entries spill to local memory in
//    exact LIFO order. The nearest internal child is kept in a register as
//    the next node instead of being pushed and popped at once, which is the
//    same visit order: walk_tree pushes it last, so it pops next.
//  * A sorting network on (entry distance, child index) keys in place of
//    walk_tree's O(A^2) rank loop: one compare-exchange at A = 2, the
//    optimal 5-exchange network at A = 4. The keys are distinct, so the
//    network gives the rank loop's order, ties included (tested on the CPU
//    through wt_sort_host). fminf/fmaxf replace the NaN-aware max/min
//    (slab_entry says why that is exact).
//  * The triangle test leaves as soon as its outcome is known (test_tri4).
//  * Any hit without order (walk<A, true>): no sort; children are taken in
//    child order, internal ones pushed, then the leaves tested, and the
//    walk stops at the first accepted triangle.
//    This is exact because the cap cannot change before the first accept:
//    an any-hit ray's t is its t_max until a triangle is accepted (the walk
//    then returns), so every slab test and every triangle test until then
//    is made against the same cap, and the set of boxes and triangles a walk
//    reaches before its first accept is the same in every visit order. The
//    ray is blocked exactly when that set holds an accepted triangle, which
//    is the nearest walk's answer.
//  * A bound (K1 and K2): trace_ray starts the best hit at the launch's
//    t_max instead of kBig. The walk reads its cap from the best hit, so a
//    ray pops no box it enters past t_max * kCapSlack and accepts no
//    triangle at t_max or beyond. Where the unbounded walk's hit lies
//    nearer than t_max, the bounded walk returns it (t, tri and inst: it
//    makes the unbounded walk's visits less the culled boxes, in the same
//    order), unless that hit lies up to EDGE_EPS outside a leaf box that
//    the lower cap culls (the triangle test's tolerance). A ray with no
//    hit nearer than t_max ends with tri -1, a miss. At t_max = kBig the
//    walk is the unbounded one, event for event.
//  * Leaf starts relative to a `tri_base` (the pages of K4-K6, whose
//    leaves count from the page's first triangle; 0 for K1-K3), added in
//    test_leaf so that hit ids stay global.
//  * Persistent warps (for_each_ray): a grid of as many blocks as the SMs
//    hold at once, each warp taking 32 rays at a time from a counter (K6
//    takes one block per tile of its plan instead, paged_major.cu).
//  * The carry (kCarry, K1 and K3 in nearest mode only): the accepted
//    triangle's barycentric u, v and its record's face normal (rows 3-5)
//    are selected into a Carry record in the branch that accepts it,
//    exact-t ties to the lower instance included. This replaces
//    make_test_tri's carry_uv and carry_n (tpu_raytracer/kernels/
//    traversal.py:145): selects only, no new arithmetic. Every walk that
//    does not carry takes kCarry = false and a null Carry, and compiles
//    to the code it had without it.
//
// Nearest mode keeps every ray's sequence of events: children ranked near
// first with ties to the lower child index, internal children pushed
// farthest first, leaf children tested right after the pushes, nearest
// first, each in ascending triangle index; the f32 operation order of the
// plain versions' child_entry and _test_tris. So K1-K6 equal their plain
// versions (kernels/traversal.py, binary.py, tlas.py, paged.py,
// paged_major.py) bit for bit in t, tri and inst.
//
// What bounds it on an H100 (PERF.md section 6 has the A/Bs against the
// earlier walks): neither bytes (the tables sit in the 50 MB L2, all but
// the 1M-triangle colonnade's triangle records) nor f32 operations (it
// runs at 5-19% of that bound) but the instructions each ray issues per
// pop and per triangle test, and the lanes that idle while a warp's other
// rays pop more nodes or test more triangles. The 16-byte loads, the short
// stack and the sorting network cut instructions; the early exits of the
// triangle test cut most on shadow and reflection rays; persistent warps
// cut idle lanes. What is left is divergence. Replacing a warp's finished
// rays one lane at a time (Aila and Laine's dynamic fetch) measured far
// slower here: lanes at different depths no longer share a node's loads.
//
// What does not apply: tensor cores (wgmma) and TMA tile pipelines. The
// slab and triangle tests are scalar f32 work per ray at data-dependent
// addresses, and --fmad=false pins their rounding to the plain versions'.
//
// The per-ray logic is plain C++ for nvcc and g++ (traverse_host.cpp runs
// it on the CPU for the tests, with S a compile-time parameter so that a
// test can force the spill path); only the 16-byte loads, shared memory,
// atomics and the persistent loop are CUDA's alone.
#pragma once

#include <string.h>

#include "wide_traverse.cuh"

#if defined(__CUDACC__)
#define WT_UNROLL _Pragma("unroll")
#define WT_HDM __host__ __device__ __forceinline__
#else
#define WT_UNROLL
#define WT_HDM inline
#endif

namespace wt {

// f32 lanes of an arity-A node record, and the first of its A code lanes.
WT_HD constexpr int node_lanes(int arity) { return 8 * arity; }
WT_HD constexpr int code_lane(int arity) { return 6 * arity; }

// Lane of child c's box coordinate k (0-2 min xyz, 3-5 max xyz): per child,
// the box tables' own layout.
WT_HD constexpr int box_lane(int c, int k) { return 6 * c + k; }

// Four floats at a 16-byte-aligned address: one 128-bit read-only load on
// the card.
WT_HD void load4(const float* p, float* out) {
#if defined(__CUDA_ARCH__)
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
#else
  for (int i = 0; i < 4; ++i) out[i] = p[i];
#endif
}

// The 6A box floats and A child codes of node record `rec`: 6A/4 float4
// loads and one int4 load of the code lanes (at A = 2 lanes 12..15, the
// last two zero).
template <int kArity>
WT_HD void load_node(const float* rec, float* box, int32_t* code) {
  WT_UNROLL
  for (int i = 0; i < 6 * kArity / 4; ++i) load4(rec + 4 * i, box + 4 * i);
#if defined(__CUDA_ARCH__)
  const int4 c = __ldg(reinterpret_cast<const int4*>(rec + code_lane(kArity)));
  code[0] = c.x;
  code[1] = c.y;
  if constexpr (kArity == 4) {
    code[2] = c.z;
    code[3] = c.w;
  }
#else
  memcpy(code, rec + code_lane(kArity), kArity * sizeof(int32_t));
#endif
}

// The plain versions' child_entry (kernels/traversal.py: NaN-propagating
// max and min of the per-axis entries and exits) with fminf/fmaxf, for
// `cap_slack` = t_best * kCapSlack. Exact here: safe_inv bounds
// |inv| by 1e30 and boxes and origins are finite (absent children's
// inverted boxes and K2's entered leaf-root box are +-3e38), so every
// (b - o) * inv is finite or +-inf, never NaN, and on non-NaN operands
// fmaxf/fminf give the value the NaN-aware max/min give. Only the sign of a zero
// may differ (near may come out -0 where it was +0); +0 and -0 compare
// equal in every test here and in the sort, and an entry distance never
// reaches the output.
WT_HD float slab_entry(float lx, float ly, float lz, float hx, float hy, float hz,
                       const float* o, const float* inv, float cap_slack) {
  const float t1x = (lx - o[0]) * inv[0];
  const float t2x = (hx - o[0]) * inv[0];
  const float t1y = (ly - o[1]) * inv[1];
  const float t2y = (hy - o[1]) * inv[1];
  const float t1z = (lz - o[2]) * inv[2];
  const float t2z = (hz - o[2]) * inv[2];
  const float near_ = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float far_ = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  const bool hit = (far_ >= near_) && (far_ > 0.0f) && (near_ < cap_slack);
  return hit ? near_ : kBig;
}

// Compare-exchange of ranks a < b on (dist, child index) keys, carrying
// the child codes along.
WT_HD void cx(float* d, int* idx, int32_t* code, int a, int b) {
  if (d[b] < d[a] || (d[b] == d[a] && idx[b] < idx[a])) {
    const float td = d[a];
    d[a] = d[b];
    d[b] = td;
    const int ti = idx[a];
    idx[a] = idx[b];
    idx[b] = ti;
    const int32_t tc = code[a];
    code[a] = code[b];
    code[b] = tc;
  }
}

// Sort A children near first, ties by child index: at A = 2 the one
// exchange (0,1), at A = 4 the optimal network (0,1)(2,3) (0,2)(1,3)
// (1,2). Keys are distinct (the index breaks ties), so the result is the
// one total order the rank loop of walk_tree gives. Afterwards d[p],
// idx[p], code[p] are those of the child of rank p.
template <int kArity>
WT_HD void sort_children(float* d, int* idx, int32_t* code) {
  cx(d, idx, code, 0, 1);
  if constexpr (kArity == 4) {
    cx(d, idx, code, 2, 3);
    cx(d, idx, code, 0, 2);
    cx(d, idx, code, 1, 3);
    cx(d, idx, code, 1, 2);
  }
}

// A thread's traversal stack. The top S entries (S a power of two) live in
// a ring of S slots, slot k at ring[k * stride] (on the card the thread's
// column of a __shared__ [S][blockDim] array; on the host a local array);
// entries below them live in `spill` (local memory), indexed by position.
// A push onto a full ring first moves the ring's oldest entry to spill; a
// pop takes the top from the ring or, once the ring has drained, from
// spill. Entries leave in exact LIFO order. The total stays within kStack
// (kernels/wide4.py stack_needed; K3-K5 add their top tree's depth,
// checked by their wrappers).
struct ShortStack {
  int32_t* ring;
  int stride;
  int mask;  // S - 1
  int32_t* spill;
  int sp;      // entries in all
  int lo;      // position of the oldest entry in the ring
  int64_t spills;  // entries moved to spill (counted by the host build)

  WT_HDM ShortStack(int32_t* ring_, int stride_, int mask_, int32_t* spill_)
      : ring(ring_), stride(stride_), mask(mask_), spill(spill_), sp(0), lo(0), spills(0) {}

  WT_HDM void push(int32_t v) {
    if (sp - lo > mask) {
      spill[lo] = ring[(lo & mask) * stride];
      ++lo;
#if !defined(__CUDA_ARCH__)
      ++spills;
#endif
    }
    ring[(sp & mask) * stride] = v;
    ++sp;
  }

  WT_HDM int32_t pop() {
    --sp;
    if (sp >= lo) return ring[(sp & mask) * stride];
    lo = sp;
    return spill[sp];
  }
};

// `next` becomes `child` and the node it held, if any, is pushed: called
// farthest child first, it leaves the nearest in `next` and pushes the
// others farthest first, as walk_tree's pushes do.
WT_HD void defer(ShortStack& st, int32_t& next, int32_t child) {
  if (next >= 0) st.push(next);
  next = child;
}

// The carried fields of the accepted triangle (kCarry walks): its
// barycentric u and v, and its record's object-space face normal. Zero
// on a miss, as the TPU kernel's fresh state.
struct Carry {
  float u = 0.0f;
  float v = 0.0f;
  float n[3] = {0.0f, 0.0f, 0.0f};
};

// Where a carrying kernel writes ray r's Carry: u [R], v [R] and the face
// normal n [R, 3]; a null pointer is a field not carried (the walk still
// selects it, in registers).
struct CarryOut {
  float* __restrict__ u;
  float* __restrict__ v;
  float* __restrict__ n;

  WT_HDM void store(int64_t r, const Carry& c) const {
    if (u != nullptr) u[r] = c.u;
    if (v != nullptr) v[r] = c.v;
    if (n != nullptr) {
      for (int k = 0; k < 3; ++k) n[3 * r + k] = c.n[k];
    }
  }

  WT_HDM bool any() const { return u != nullptr || v != nullptr || n != nullptr; }
};

// test_tri of wide_traverse.cuh with the same f32 operations in the same
// order, leaving as soon as the outcome is known: at a back face or a ray
// parallel to the plane before the division, at a t behind the origin or
// not nearer than the best hit before the edge rows. Each early exit is a
// conjunct of test_tri's acceptance failing (a NaN fails every one), so
// the result is test_tri's; only arithmetic whose result is not needed is
// skipped. With kCarry the accept also selects u, v and the record's
// normal into `carry`.
template <bool kCarry = false>
WT_HD bool test_tri4(const float* r, const float* o, const float* d, int32_t k,
                     int32_t inst, bool any_hit, Hit* best, Carry* carry = nullptr) {
  const float denom = d[0] * r[3] + d[1] * r[4] + d[2] * r[5];
  if (!(denom <= -kParallelEps)) return false;
  const float cx = r[0] - o[0];
  const float cy = r[1] - o[1];
  const float cz = r[2] - o[2];
  const float num = cx * r[3] + cy * r[4] + cz * r[5];
  const float t = num / denom;
  if (!((t >= 0.0f) && (t < best->t || (t == best->t && inst < best->inst)))) return false;
  const float e2x = t * d[0] - cx;
  const float e2y = t * d[1] - cy;
  const float e2z = t * d[2] - cz;
  const float u = r[6] * e2x + r[7] * e2y + r[8] * e2z;
  const float v = r[9] * e2x + r[10] * e2y + r[11] * e2z;
  if (!((u >= kEdgeLo) && (v >= kEdgeLo) && (u + v <= kEdgeHi))) return false;
  best->t = any_hit ? -kBig : t;
  best->tri = k;
  best->inst = inst;
  if constexpr (kCarry) {
    carry->u = u;
    carry->v = v;
    carry->n[0] = r[3];
    carry->n[1] = r[4];
    carry->n[2] = r[5];
  }
  return true;
}

// The triangles of leaf code `cc`, whose start counts from `tri_base`, in
// ascending index. Returns true when an any-hit test accepted one.
template <bool kAnyHit, bool kCarry = false>
WT_HD bool test_leaf(int32_t cc, int32_t tri_base, const float* tri_rec, const float* o,
                     const float* d, int32_t inst_val, Hit* best, Carry* carry = nullptr) {
  static_assert(!(kAnyHit && kCarry), "an any-hit walk carries nothing");
  const int32_t packed = -cc - 1;
  const int32_t start = (packed >> 10) + tri_base;
  const int32_t n = packed & 1023;
  for (int32_t k = start; k < start + n; ++k) {
    float r[12];
    const float* rec = tri_rec + 16 * static_cast<int64_t>(k);
    load4(rec, r);
    load4(rec + 4, r + 4);
    load4(rec + 8, r + 8);
    if (test_tri4<kCarry>(r, o, d, k, inst_val, kAnyHit, best, carry) && kAnyHit) return true;
  }
  return false;
}

// Walk one tree of arity kArity from node `root` of the node records
// `nodes` for an object-space ray, leaf starts counting from `tri_base`,
// updating `best`, on top of whatever `st` holds (K3-K5 keep their top
// tree's entries below). Returns true when an any-hit walk accepted a
// triangle (and stopped there, leaving its entries on the stack). With
// kCarry the accepted triangle's fields go to `carry`.
template <int kArity, bool kAnyHit, bool kCarry = false>
WT_HD bool walk(const float* nodes, int32_t root, int32_t tri_base, const float* tri_rec,
                const float* o, const float* d, const float* inv, int32_t inst_val,
                ShortStack& st, Hit* best, Carry* carry = nullptr) {
  const int base = st.sp;
  int32_t node = root;
  for (;;) {
    float b[6 * kArity];
    int32_t code[kArity];
    load_node<kArity>(nodes + node_lanes(kArity) * static_cast<int64_t>(node), b, code);
    const float cap = best->t * kCapSlack;
    float dist[kArity];
    WT_UNROLL
    for (int c = 0; c < kArity; ++c) {
      dist[c] = slab_entry(b[box_lane(c, 0)], b[box_lane(c, 1)], b[box_lane(c, 2)],
                           b[box_lane(c, 3)], b[box_lane(c, 4)], b[box_lane(c, 5)], o, inv,
                           cap);
    }
    int32_t next = -1;
    if (!kAnyHit) {
      int idx[kArity];
      WT_UNROLL
      for (int c = 0; c < kArity; ++c) idx[c] = c;
      sort_children<kArity>(dist, idx, code);
    }
    // children that hit, in rank order (nearest first) or, for any hit,
    // in child order: internal ones deferred last to first, so that the
    // first is the next node and the others are pushed farthest first;
    // then the leaves, first to last
    WT_UNROLL
    for (int p = kArity - 1; p >= 0; --p) {
      if (dist[p] < kBig && code[p] >= 0) defer(st, next, code[p]);
    }
    WT_UNROLL
    for (int p = 0; p < kArity; ++p) {
      if (dist[p] < kBig && code[p] < 0 &&
          test_leaf<kAnyHit, kCarry>(code[p], tri_base, tri_rec, o, d, inst_val, best,
                                     carry)) {
        return true;
      }
    }
    if (next >= 0) {
      node = next;
    } else if (st.sp > base) {
      node = st.pop();
    } else {
      return false;
    }
  }
}

// Walk instance `i`'s tree of arity kArity (the scene's node records) for
// one world ray. Returns true on an any-hit accept.
template <int kArity, bool kAnyHit, bool kCarry = false>
WT_HD bool walk_instance(const Scene& s, int i, const float* wo, const float* wd,
                         ShortStack& st, Hit* best, Carry* carry = nullptr) {
  float o[3], d[3], inv[3];
  object_ray(s.inst_tab + 12 * i, wo, wd, o, d, inv);
  return walk<kArity, kAnyHit, kCarry>(s.node, s.inst_root[i], 0, s.tri_rec, o, d, inv,
                                       s.num_instances == 1 ? -1 : i, st, best, carry);
}

// K1 (arity 4) and K2 (arity 2): nearest (or any) hit nearer than t_max
// (kBig: unbounded) of one world ray over every instance in index order,
// t carried across instances; with kCarry (K1) the hit's carried fields
// in `carry`.
template <int kArity, bool kAnyHit, bool kCarry = false>
WT_HD Hit trace_ray(const Scene& s, const float* wo, const float* wd, ShortStack& st,
                    float t_max, Carry* carry = nullptr) {
  Hit best{t_max, -1, -1};
  for (int i = 0; i < s.num_instances; ++i) {
    if (walk_instance<kArity, kAnyHit, kCarry>(s, i, wo, wd, st, &best, carry)) break;
  }
  return finish_hit(best, s.num_instances);
}

#if defined(__CUDACC__)
// Calls trace(r) for each ray r of this thread, with persistent warps: the
// grid holds as many blocks as the SMs keep resident, and each warp takes
// the next 32 rays from the zeroed global counter once all its lanes have
// finished theirs (Aila and Laine 2009), so a warp held by one slow ray
// does not hold its block's slot on the SM.
template <class F>
__device__ __forceinline__ void for_each_ray(int64_t num_rays, unsigned long long* counter,
                                             F&& trace) {
  const unsigned lane = threadIdx.x & 31u;
  for (;;) {
    unsigned long long first = 0;
    if (lane == 0) first = atomicAdd(counter, 32ull);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= static_cast<unsigned long long>(num_rays)) return;
    const int64_t r = static_cast<int64_t>(first) + lane;
    if (r < num_rays) trace(r);
  }
}
#endif

}  // namespace wt
