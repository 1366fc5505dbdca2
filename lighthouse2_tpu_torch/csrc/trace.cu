// BVH4 closest-hit and any-hit trace kernels for Hopper (sm_90a).
//
// What they replace. lighthouse2_tpu/render/kernels/trace.py:
//   lh2_trace_closest  <- _make_closest_kernel (with its helpers
//                         _make_next_leaf, _frustum_hit, _lane_slab,
//                         _sub_forms, _sub_hits), launched by _trace_chunk
//   lh2_trace_occluded <- _make_anyhit_kernel, launched by _trace_chunk
// They keep the TPU kernels' hit contract (nearest triangle with
// 1e-6 < t < tmax, u >= 0, v >= 0, u + v <= 1; tmax <= 0 is a dead lane that
// misses; any-hit stops at the first hit) but not their design: the scalar-
// core walk, block frustums, MXU plane forms and DMA ring fit the TPU only.
// Triangle ids are int32 (the TPU kernel's f32 tile*128+lane code is exact
// only below 2^24).
//
// What bounds them on this card. Not bytes and not operations: the scene is
// ~9 MB and sits in the 50 MB L2, and a ray does a few hundred flops. A ray
// is a chain of dependent loads (the next node's address is known only after
// the current node's box tests), and the 32 rays of a warp take different
// paths of different lengths. So the time is load latency times chain length,
// and how many sectors each step pulls through L1/L2.
//
// What the design does about it.
//   - A 4-wide BVH (bvh/wide.py collapses the SAH BVH2 at upload): each step
//     tests four children, so the chain is about half as long as the BVH2's.
//   - One node is one 128-byte record, six float4 of child boxes (lo.x[4] ..
//     hi.z[4]), an int4 of child codes and an int4 of counts: eight
//     independent 16-byte loads from one cache line, instead of ~15 4-byte
//     loads from 15 lines in the component-major BVH2.
//   - Triangles in leaf order as three float4 each, (v0, id bits), e1, e2:
//     one triangle is three aligned 16-byte loads with no prim indirection.
//   - All scene reads go through const __restrict__ pointers and __ldg.
//   - Closest hit visits hit children nearest first (ties to the lower slot,
//     ordered by a 4-input sorting network) and pushes the rest far-first
//     with their entry t; an entry whose t is no longer below the best hit
//     is dropped when it is popped. Any-hit takes hit children in slot order
//     and returns at the first hit. The stack holds (item, t) pairs as one
//     8-byte word in local memory; a node pushes at most 3 entries, and the
//     wrapper refuses a BVH4 deeper than the stack allows.
//   - While-while loops (Aila & Laine, HPG 2009): nodes are taken in an
//     inner loop until the ray holds a leaf, so the leaves of a warp are
//     tested together instead of alternating with node steps.
//   - One thread per ray, 128-thread blocks: closest-hit uses 56 registers
//     and occluded 54, with no spills (nvcc -Xptxas -v). Measured and not
//     kept (tools/trace_variants.py, PERF.md): persistent warps, an L2
//     access-policy window over the scene, the stack in shared memory, a
//     40-register cap, the if-if loop, rank-ordered pushes.
//
// Numerics. The item order and every floating-point operation follow the
// plain PyTorch version, lighthouse2_tpu_torch/bvh/wide.py (_walk, and
// core/geometry.py mt_comp), operation for operation. The library is
// compiled with -fmad=false so no multiply-add is contracted into an FMA:
// the kernel then rounds exactly as the plain version does and the two
// agree lane for lane, per-ray counts included.
#include <cuda_runtime.h>

#define STACK_CAP 64   // keep equal to bvh/wide.py STACK_CAP
#define LEAF_SHIFT 3   // leaf item = ~(first << 3 | count) (bvh/wide.py)
#define BIG_T 1e30f
#define T_MIN 1e-6f
#define DET_EPS 1e-9f
#define BLOCK 128

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  const float sx = fabsf(r.dx) < 1e-20f ? 1e-20f : r.dx;
  const float sy = fabsf(r.dy) < 1e-20f ? 1e-20f : r.dy;
  const float sz = fabsf(r.dz) < 1e-20f ? 1e-20f : r.dz;
  r.ix = 1.0f / sx; r.iy = 1.0f / sy; r.iz = 1.0f / sz;
  return r;
}

// Slab test of one child box (wide.py _walk, same order). Returns tn.
__device__ __forceinline__ float slab(const Ray& r, float lx, float ly,
                                      float lz, float hx, float hy, float hz,
                                      float best_t, bool& hit) {
  const float t0x = (lx - r.ox) * r.ix;
  const float t1x = (hx - r.ox) * r.ix;
  const float t0y = (ly - r.oy) * r.iy;
  const float t1y = (hy - r.oy) * r.iy;
  const float t0z = (lz - r.oz) * r.iz;
  const float t1z = (hz - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  hit = (tf >= fmaxf(tn, 0.0f)) && (tn < best_t);
  return tn;
}

// Moller-Trumbore against triangle row `row` (geometry.py mt_comp, same
// order). The row is three float4: (v0, id bits), (e1, 0), (e2, 0).
__device__ __forceinline__ bool intersect(const float4* __restrict__ tri4,
                                          const Ray& r, int row, float t_max,
                                          float& t, float& u, float& v,
                                          int& pid) {
  const float4 a = __ldg(tri4 + 3 * row);
  const float4 b = __ldg(tri4 + 3 * row + 1);
  const float4 c = __ldg(tri4 + 3 * row + 2);
  pid = __float_as_int(a.w);
  const float hx = r.dy * c.z - r.dz * c.y;
  const float hy = r.dz * c.x - r.dx * c.z;
  const float hz = r.dx * c.y - r.dy * c.x;
  const float det = b.x * hx + b.y * hy + b.z * hz;
  const bool valid = fabsf(det) > DET_EPS;
  const float f = 1.0f / (valid ? det : 1.0f);
  const float sx = r.ox - a.x;
  const float sy = r.oy - a.y;
  const float sz = r.oz - a.z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * b.z - sz * b.y;
  const float qy = sz * b.x - sx * b.z;
  const float qz = sx * b.y - sy * b.x;
  v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = f * (c.x * qx + c.y * qy + c.z * qz);
  return valid && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > T_MIN && t < t_max;
}

__device__ __forceinline__ float comp(const float4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}
__device__ __forceinline__ int comp(const int4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// Per-thread stack of (item, entry t bits) in local memory.
struct LocalStack {
  int2 e[STACK_CAP];
  __device__ __forceinline__ void put(int i, int2 v) { e[i] = v; }
  __device__ __forceinline__ int2 get(int i) const { return e[i]; }
};

// Test the triangles of leaf item `item`. Returns true when an any-hit walk
// must stop (ANYHIT and a hit).
template <bool ANYHIT>
__device__ __forceinline__ bool visit_leaf(const float4* __restrict__ tri4,
                                           int max_leaf, const Ray& r,
                                           int item, float& best_t,
                                           int& best_p, float& best_u,
                                           float& best_v, bool& occ,
                                           int& n_tests) {
  const int code = ~item;
  const int first = code >> LEAF_SHIFT;
  const int cnt = code & ((1 << LEAF_SHIFT) - 1);
  for (int k = 0; k < cnt && k < max_leaf; ++k) {
    float t, u, v;
    int pid;
    ++n_tests;
    if (intersect(tri4, r, first + k, best_t, t, u, v, pid)) {
      occ = true;
      if (ANYHIT) return true;
      best_t = t; best_p = pid; best_u = u; best_v = v;
    }
  }
  return false;
}

// Slab-test the four children of node `item`. The first hit child in
// visiting order goes next, returned in (next, next_t); the other hit
// children are pushed so that the next one in that order pops first.
// Closest hit visits nearest first, ties to the lower slot: a 4-input
// sorting network on (tn, slot) with the misses keyed +inf. Any-hit visits
// in slot order. Returns whether a child was hit.
template <bool ANYHIT, class Stack>
__device__ __forceinline__ bool visit_node(const float4* __restrict__ node4,
                                           const Ray& r, int item,
                                           float best_t, Stack& stack,
                                           int& sp, int& next, float& next_t,
                                           int& n_boxes) {
  const float4* nd = node4 + 8 * item;
  const float4 lx = __ldg(nd), ly = __ldg(nd + 1), lz = __ldg(nd + 2);
  const float4 hx = __ldg(nd + 3), hy = __ldg(nd + 4), hz = __ldg(nd + 5);
  const int4 codes = __ldg(reinterpret_cast<const int4*>(nd + 6));
  const int4 cnts = __ldg(reinterpret_cast<const int4*>(nd + 7));
  float tn[4];
  bool hit[4];
  int child[4];
  int nh = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = comp(cnts, k);
    const int cd = comp(codes, k);
    n_boxes += c >= 0;
    bool h;
    tn[k] = slab(r, comp(lx, k), comp(ly, k), comp(lz, k), comp(hx, k),
                 comp(hy, k), comp(hz, k), best_t, h);
    hit[k] = h && c >= 0;
    nh += hit[k];
    child[k] = c > 0 ? ~((cd << LEAF_SHIFT) | c) : cd;
  }
  if (nh == 0) return false;
  if (ANYHIT) {
    int rank = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!hit[k]) continue;
      if (rank == 0) {
        next = child[k];
        next_t = tn[k];
      } else {
        stack.put(sp + nh - 1 - rank,
                  make_int2(child[k], __float_as_int(tn[k])));
      }
      ++rank;
    }
  } else {
    float key[4];
    int slot[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      key[k] = hit[k] ? tn[k] : INFINITY;   // a hit has tn < best_t <= 1e30
      slot[k] = k;
    }
    const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int a = net[e][0], b = net[e][1];
      const bool swap =
          key[a] > key[b] || (key[a] == key[b] && slot[a] > slot[b]);
      const float ka = key[a];
      const int sa = slot[a], ca = child[a];
      key[a] = swap ? key[b] : ka; key[b] = swap ? ka : key[b];
      slot[a] = swap ? slot[b] : sa; slot[b] = swap ? sa : slot[b];
      child[a] = swap ? child[b] : ca; child[b] = swap ? ca : child[b];
    }
    next = child[0];
    next_t = key[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (k < nh)
        stack.put(sp + nh - 1 - k,
                  make_int2(child[k], __float_as_int(key[k])));
  }
  sp += nh - 1;
  return true;
}

// One ray's walk (wide.py _walk): each step visits one item, a BVH4 node
// (>= 0) or a leaf (~(first << 3 | count)), or drops a pruned one; a node
// step goes on to the first hit child, every other step pops. ANYHIT returns
// at the first hit. The loop is while-while (Aila & Laine, HPG 2009): an
// inner loop takes nodes and pruned items until the ray holds a live leaf,
// so the leaves of a warp are tested together and not interleaved with node
// steps. The item sequence of each ray is the plain walk's.
template <bool ANYHIT, class Stack>
__device__ __forceinline__ void walk(const float4* __restrict__ node4,
                                     const float4* __restrict__ tri4,
                                     int max_leaf, const Ray& r,
                                     Stack& stack, float& best_t,
                                     int& best_p, float& best_u,
                                     float& best_v, bool& occ, int& n_steps,
                                     int& n_boxes, int& n_tests) {
  int sp = 0;
  int item = 0;
  float cur_t = 0.0f;
  while (true) {
    while (true) {
      ++n_steps;
      bool go = false;
      int next = 0;
      float next_t = 0.0f;
      if (!(cur_t >= best_t)) {
        if (item < 0) break;
        go = visit_node<ANYHIT>(node4, r, item, best_t, stack, sp, next,
                                next_t, n_boxes);
      }
      if (go) {
        item = next;
        cur_t = next_t;
      } else if (sp > 0) {
        --sp;
        const int2 top = stack.get(sp);
        item = top.x;
        cur_t = __int_as_float(top.y);
      } else {
        return;
      }
    }
    if (visit_leaf<ANYHIT>(tri4, max_leaf, r, item, best_t, best_p, best_u,
                           best_v, occ, n_tests))
      return;
    if (sp == 0) return;
    --sp;
    const int2 top = stack.get(sp);
    item = top.x;
    cur_t = __int_as_float(top.y);
  }
}

__global__ void __launch_bounds__(BLOCK)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax,
               const float4* __restrict__ node4,
               const float4* __restrict__ tri4, int max_leaf, int n,
               float* __restrict__ out_t, int* __restrict__ out_prim,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float best_t = fminf(tmax[i], BIG_T);
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool occ = false;
  int steps = 0, boxes = 0, tests = 0;
  LocalStack stack;
  walk<false>(node4, tri4, max_leaf, r, stack, best_t, best_p, best_u, best_v,
              occ, steps, boxes, tests);
  out_t[i] = best_t;
  out_prim[i] = best_p;
  out_u[i] = best_u;
  out_v[i] = best_v;
  if (stats) {
    stats[i] = steps;
    stats[n + i] = boxes;
    stats[2 * n + i] = tests;
  }
}

__global__ void __launch_bounds__(BLOCK)
occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmax,
                const float4* __restrict__ node4,
                const float4* __restrict__ tri4, int max_leaf, int n,
                bool* __restrict__ out_occ, int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float best_t = fminf(tmax[i], BIG_T);
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool occ = false;
  int steps = 0, boxes = 0, tests = 0;
  LocalStack stack;
  walk<true>(node4, tri4, max_leaf, r, stack, best_t, best_p, best_u, best_v,
             occ, steps, boxes, tests);
  out_occ[i] = occ;
  if (stats) {
    stats[i] = steps;
    stats[n + i] = boxes;
    stats[2 * n + i] = tests;
  }
}

// C entry points (bound with ctypes by render/kernels/trace.py). Each
// launches on `stream` without synchronising and returns cudaGetLastError().
// node4 is DeviceBVH.node4 ([M4, 32] f32), tri4 is DeviceBVH.tri4 ([T, 12]
// f32), both 16-byte aligned. `stats` may be null; otherwise it receives
// int32 [3, n] per-ray counts: steps (items visited), child boxes tested and
// triangle tests.
extern "C" int lh2_trace_closest(const float* o, const float* d,
                                 const float* tmax, const float* node4,
                                 const float* tri4, int max_leaf, int n,
                                 float* out_t, int* out_prim, float* out_u,
                                 float* out_v, int* stats, void* stream) {
  if (n > 0) {
    closest_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, reinterpret_cast<const float4*>(node4),
        reinterpret_cast<const float4*>(tri4), max_leaf, n, out_t, out_prim,
        out_u, out_v, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh2_trace_occluded(const float* o, const float* d,
                                  const float* tmax, const float* node4,
                                  const float* tri4, int max_leaf, int n,
                                  bool* out_occ, int* stats, void* stream) {
  if (n > 0) {
    occluded_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, reinterpret_cast<const float4*>(node4),
        reinterpret_cast<const float4*>(tri4), max_leaf, n, out_occ, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage marks (utils/telemetry.py). One single-thread kernel per stage
// boundary of a pass, launched on the pass's stream, so that a CUDA graph
// captures it with the pass and every replay runs it: a host profiler range
// never reaches the kernels of a replay, a mark is one of them. Each kernel
// is named after the stage it opens, so a profiler's device trace shows the
// stages, and each reads %globaltimer (ns) and adds the time since the
// previous mark to the stage that mark opened. `buf` is int64: the open
// stage (-1: none), the last mark's time, the passes closed, then each
// stage's nanoseconds (utils/telemetry.py allocates it, so the number of
// stages lives there alone). lh2_mark_end (stage -1) opens nothing: the
// time from one pass's end to the next pass's first mark (the replay's
// copies in and out, the host's gap) goes to no stage.
__device__ __forceinline__ void stage_mark(long long* buf, int stage) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long open = buf[0];
  if (open >= 0) buf[3 + open] += static_cast<long long>(now) - buf[1];
  if (stage < 0) buf[2] += 1;
  buf[1] = static_cast<long long>(now);
  buf[0] = stage;
}

#define LH2_MARK(name, stage) \
  __global__ void lh2_mark_##name(long long* buf) { stage_mark(buf, stage); }
LH2_MARK(generate, 0)
LH2_MARK(trace, 1)
LH2_MARK(refine, 2)
LH2_MARK(shade, 3)
LH2_MARK(occlude, 4)
LH2_MARK(apply, 5)
LH2_MARK(finish, 6)
LH2_MARK(end, -1)

// The stages in the order lh2_mark numbers them; the loader holds
// utils/telemetry.py STAGES to it.
extern "C" const char* lh2_mark_stages() {
  return "generate trace refine shade occlude apply finish";
}

// Launches the mark of `stage` (0.., or -1 for the end) on `stream`, one
// thread; returns cudaGetLastError(), or cudaErrorInvalidValue for a stage
// out of range.
extern "C" int lh2_mark(int stage, long long* buf, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: lh2_mark_generate<<<1, 1, 0, s>>>(buf); break;
    case 1: lh2_mark_trace<<<1, 1, 0, s>>>(buf); break;
    case 2: lh2_mark_refine<<<1, 1, 0, s>>>(buf); break;
    case 3: lh2_mark_shade<<<1, 1, 0, s>>>(buf); break;
    case 4: lh2_mark_occlude<<<1, 1, 0, s>>>(buf); break;
    case 5: lh2_mark_apply<<<1, 1, 0, s>>>(buf); break;
    case 6: lh2_mark_finish<<<1, 1, 0, s>>>(buf); break;
    case -1: lh2_mark_end<<<1, 1, 0, s>>>(buf); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
