// Alternatives to the shipped trace kernels, built only by
// lighthouse2_tpu_torch/tools/trace_variants.py to time them against the
// shipped ones in one process. Nothing on the render path loads this file.
//
//   lh2v_walk
//       the shipped walk with another loop, child order, leaf loads, stack
//       or launch shape: the if-if loop (each step a node, a leaf or a
//       pruned item; the first BVH4 kernel), ranks instead of the sorting
//       network, triangle loads issued ahead of the tests, the stack in
//       shared memory (stride BLOCK, 3 * depth4 + 1 entries), 64- and
//       256-thread blocks, __launch_bounds__ asking for 6, 8, 10 or 12
//       blocks an SM; the item order per ray is the same in all;
//   lh2v_closest_persistent / lh2v_occluded_persistent
//       the shipped walk with persistent warps: one grid that fills the card
//       once, each warp fetching 32 rays at a time from an atomic counter
//       (Aila & Laine, HPG 2009);
//   lh2v_closest_l2window / lh2v_occluded_l2window
//       the shipped kernels launched with an L2 access-policy window over the
//       scene (cudaLaunchAttributeAccessPolicyWindow, persisting hits) after
//       lh2v_set_persisting_l2 has reserved L2 for persisting lines;
//   lh2v_closest_aos2 / lh2v_occluded_aos2
//       the BVH2 walk of the first CUDA port (node order of bvh/traverse.py)
//       over an array-of-structs BVH2: one 64-byte record per node holding
//       both child boxes, and the leaf-ordered float4 triangles of the BVH4,
//       with the if-if or the while-while loop. It splits the BVH4's gain
//       between the layout, the loop and the width.
#include "trace.cu"

extern __shared__ int2 stack_smem[];

// Stack in shared memory, entry i of thread x at [i * BLOCK + x].
struct SharedStack {
  int2* base;
  __device__ __forceinline__ void put(int i, int2 v) { base[i * BLOCK] = v; }
  __device__ __forceinline__ int2 get(int i) const { return base[i * BLOCK]; }
};

// visit_node with the hit children ordered by ranks instead of the sorting
// network: rank[k] counts the hit children that go before child k (nearer,
// or as near and in a lower slot; any-hit: in a lower slot). The same pushes
// in the same places.
template <bool ANYHIT, class Stack>
__device__ __forceinline__ bool visit_node_ranked(
    const float4* __restrict__ node4, const Ray& r, int item, float best_t,
    Stack& stack, int& sp, int& next, float& next_t, int& n_boxes) {
  const float4* nd = node4 + 8 * item;
  const float4 lx = __ldg(nd), ly = __ldg(nd + 1), lz = __ldg(nd + 2);
  const float4 hx = __ldg(nd + 3), hy = __ldg(nd + 4), hz = __ldg(nd + 5);
  const int4 codes = __ldg(reinterpret_cast<const int4*>(nd + 6));
  const int4 cnts = __ldg(reinterpret_cast<const int4*>(nd + 7));
  float tn[4];
  bool hit[4];
  int child[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = comp(cnts, k);
    const int cd = comp(codes, k);
    n_boxes += c >= 0;
    bool h;
    tn[k] = slab(r, comp(lx, k), comp(ly, k), comp(lz, k), comp(hx, k),
                 comp(hy, k), comp(hz, k), best_t, h);
    hit[k] = h && c >= 0;
    child[k] = c > 0 ? ~((cd << LEAF_SHIFT) | c) : cd;
  }
  int rank[4];
  int nh = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    nh += hit[k];
    rank[k] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j == k) continue;
      const bool before =
          ANYHIT ? j < k : (tn[j] < tn[k] || (tn[j] == tn[k] && j < k));
      rank[k] += hit[j] && before;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!hit[k]) continue;
    if (rank[k] == 0) {
      next = child[k];
      next_t = tn[k];
    } else {
      stack.put(sp + nh - 1 - rank[k],
                make_int2(child[k], __float_as_int(tn[k])));
    }
  }
  if (nh > 0) sp += nh - 1;
  return nh > 0;
}

// visit_leaf with the triangle loads issued ahead of the tests: PREFETCH 1
// loads triangle k + 1 while triangle k is tested, PREFETCH 2 loads all of
// the leaf's (at most 4) triangles first. The same tests in the same order.
template <bool ANYHIT, int PREFETCH>
__device__ __forceinline__ bool visit_leaf_ahead(
    const float4* __restrict__ tri4, const Ray& r, int item, float& best_t,
    int& best_p, float& best_u, float& best_v, bool& occ, int& n_tests) {
  const int code = ~item;
  const int first = code >> LEAF_SHIFT;
  const int cnt = min(code & ((1 << LEAF_SHIFT) - 1), 4);
  float4 a[4], b[4], c[4];
  const float4* g = tri4 + 3 * first;
#pragma unroll
  for (int k = 0; k < (PREFETCH == 2 ? 4 : 1); ++k) {
    if (k < cnt) {
      a[k] = __ldg(g + 3 * k); b[k] = __ldg(g + 3 * k + 1);
      c[k] = __ldg(g + 3 * k + 2);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= cnt) break;
    if (PREFETCH == 1 && k + 1 < 4 && k + 1 < cnt) {
      a[k + 1] = __ldg(g + 3 * k + 3); b[k + 1] = __ldg(g + 3 * k + 4);
      c[k + 1] = __ldg(g + 3 * k + 5);
    }
    ++n_tests;
    const float hx = r.dy * c[k].z - r.dz * c[k].y;
    const float hy = r.dz * c[k].x - r.dx * c[k].z;
    const float hz = r.dx * c[k].y - r.dy * c[k].x;
    const float det = b[k].x * hx + b[k].y * hy + b[k].z * hz;
    const bool valid = fabsf(det) > DET_EPS;
    const float f = 1.0f / (valid ? det : 1.0f);
    const float sx = r.ox - a[k].x;
    const float sy = r.oy - a[k].y;
    const float sz = r.oz - a[k].z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * b[k].z - sz * b[k].y;
    const float qy = sz * b[k].x - sx * b[k].z;
    const float qz = sx * b[k].y - sy * b[k].x;
    const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float t = f * (c[k].x * qx + c[k].y * qy + c[k].z * qz);
    if (valid && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
        t > T_MIN && t < best_t) {
      occ = true;
      if (ANYHIT) return true;
      best_t = t; best_p = __float_as_int(a[k].w); best_u = u; best_v = v;
    }
  }
  return false;
}

// The walk with a choice of loop (IFIF: the if-if loop, each step a node,
// a leaf or a pruned item; else the shipped while-while loop), child order
// (RANKED: visit_node_ranked) and leaf loads (PREFETCH: visit_leaf_ahead).
// Every choice visits the same items in the same order.
template <bool ANYHIT, bool IFIF, bool RANKED, int PREFETCH, class Stack>
__device__ __forceinline__ void walk_v(const float4* __restrict__ node4,
                                       const float4* __restrict__ tri4,
                                       int max_leaf, const Ray& r,
                                       Stack& stack, float& best_t,
                                       int& best_p, float& best_u,
                                       float& best_v, bool& occ,
                                       int& n_steps, int& n_boxes,
                                       int& n_tests) {
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
        if (item < 0) {
          if (!IFIF) break;
          const bool stop =
              PREFETCH ? visit_leaf_ahead<ANYHIT, PREFETCH>(
                             tri4, r, item, best_t, best_p, best_u, best_v,
                             occ, n_tests)
                       : visit_leaf<ANYHIT>(tri4, max_leaf, r, item, best_t,
                                            best_p, best_u, best_v, occ,
                                            n_tests);
          if (stop) return;
        } else if (RANKED) {
          go = visit_node_ranked<ANYHIT>(node4, r, item, best_t, stack, sp,
                                         next, next_t, n_boxes);
        } else {
          go = visit_node<ANYHIT>(node4, r, item, best_t, stack, sp, next,
                                  next_t, n_boxes);
        }
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
    const bool stop =
        PREFETCH ? visit_leaf_ahead<ANYHIT, PREFETCH>(tri4, r, item, best_t,
                                                      best_p, best_u, best_v,
                                                      occ, n_tests)
                 : visit_leaf<ANYHIT>(tri4, max_leaf, r, item, best_t, best_p,
                                      best_u, best_v, occ, n_tests);
    if (stop) return;
    if (sp == 0) return;
    --sp;
    const int2 top = stack.get(sp);
    item = top.x;
    cur_t = __int_as_float(top.y);
  }
}

template <bool ANYHIT, bool IFIF, bool RANKED, int PREFETCH, bool SHARED,
          int B, int MINB>
__global__ void __launch_bounds__(B, MINB)
variant_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax,
               const float4* __restrict__ node4,
               const float4* __restrict__ tri4, int max_leaf, int n,
               float* __restrict__ out_t, int* __restrict__ out_prim,
               float* __restrict__ out_u, float* __restrict__ out_v,
               bool* __restrict__ out_occ, int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float best_t = fminf(tmax[i], BIG_T);
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool occ = false;
  int steps = 0, boxes = 0, tests = 0;
  if (SHARED) {
    SharedStack stack{stack_smem + threadIdx.x};
    walk_v<ANYHIT, IFIF, RANKED, PREFETCH>(node4, tri4, max_leaf, r, stack,
                                           best_t, best_p, best_u, best_v,
                                           occ, steps, boxes, tests);
  } else {
    LocalStack stack;
    walk_v<ANYHIT, IFIF, RANKED, PREFETCH>(node4, tri4, max_leaf, r, stack,
                                           best_t, best_p, best_u, best_v,
                                           occ, steps, boxes, tests);
  }
  if (ANYHIT) {
    out_occ[i] = occ;
  } else {
    out_t[i] = best_t;
    out_prim[i] = best_p;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
  if (stats) {
    stats[i] = steps;
    stats[n + i] = boxes;
    stats[2 * n + i] = tests;
  }
}

template <bool ANYHIT, bool IFIF, bool RANKED, int PREFETCH, bool SHARED,
          int B, int MINB>
static void launch_variant(const float* o, const float* d, const float* tmax,
                           const float* node4, const float* tri4,
                           int max_leaf, int n, float* out_t, int* out_prim,
                           float* out_u, float* out_v, bool* out_occ,
                           int* stats, int cap, cudaStream_t s) {
  static_assert(!SHARED || B == BLOCK, "SharedStack strides by BLOCK");
  const size_t smem = SHARED ? sizeof(int2) * B * cap : 0;
  auto* k = variant_kernel<ANYHIT, IFIF, RANKED, PREFETCH, SHARED, B, MINB>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  k<<<(n + B - 1) / B, B, smem, s>>>(
      o, d, tmax, reinterpret_cast<const float4*>(node4),
      reinterpret_cast<const float4*>(tri4), max_leaf, n, out_t, out_prim,
      out_u, out_v, out_occ, stats);
}

// variant (loop, order, leaf loads, stack, block, blocks/SM asked for):
//   0 the shipped walk: while-while, sorting network, in-loop, local, 128, 1
//   1 if-if                 2 shared-memory stack    3 if-if, shared stack
//   4 12 blocks/SM (<= 40 registers)                 5 rank order
//   6 256-thread blocks     7 64-thread blocks       8 10 blocks/SM
//   9 leaf loads one triangle ahead                  10 all leaf loads first
//   11 all leaf loads first, 6 blocks/SM (<= 80 registers)
//   12 all leaf loads first, 8 blocks/SM (<= 64 registers)
// cap: shared stack entries a thread (>= 3 * depth4 + 1).
extern "C" int lh2v_walk(int variant, int anyhit, const float* o,
                         const float* d, const float* tmax, const float* node4,
                         const float* tri4, int max_leaf, int n, float* out_t,
                         int* out_prim, float* out_u, float* out_v,
                         bool* out_occ, int* stats, int cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (max_leaf > 4) return static_cast<int>(cudaErrorInvalidValue);
#define LH2V_CASE(V, IFIF, RANKED, PF, SH, B, MB)                             \
  case V:                                                                     \
    if (anyhit)                                                               \
      launch_variant<true, IFIF, RANKED, PF, SH, B, MB>(                      \
          o, d, tmax, node4, tri4, max_leaf, n, out_t, out_prim, out_u,       \
          out_v, out_occ, stats, cap, s);                                     \
    else                                                                      \
      launch_variant<false, IFIF, RANKED, PF, SH, B, MB>(                     \
          o, d, tmax, node4, tri4, max_leaf, n, out_t, out_prim, out_u,       \
          out_v, out_occ, stats, cap, s);                                     \
    break;
  switch (variant) {
    LH2V_CASE(0, false, false, 0, false, BLOCK, 1)
    LH2V_CASE(1, true, false, 0, false, BLOCK, 1)
    LH2V_CASE(2, false, false, 0, true, BLOCK, 1)
    LH2V_CASE(3, true, false, 0, true, BLOCK, 1)
    LH2V_CASE(4, false, false, 0, false, BLOCK, 12)
    LH2V_CASE(5, false, true, 0, false, BLOCK, 1)
    LH2V_CASE(6, false, false, 0, false, 256, 1)
    LH2V_CASE(7, false, false, 0, false, 64, 1)
    LH2V_CASE(8, false, false, 0, false, BLOCK, 10)
    LH2V_CASE(9, false, false, 1, false, BLOCK, 1)
    LH2V_CASE(10, false, false, 2, false, BLOCK, 1)
    LH2V_CASE(11, false, false, 2, false, BLOCK, 6)
    LH2V_CASE(12, false, false, 2, false, BLOCK, 8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LH2V_CASE
  return static_cast<int>(cudaGetLastError());
}

template <bool ANYHIT>
__global__ void __launch_bounds__(BLOCK)
persistent_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ tmax,
                  const float4* __restrict__ node4,
                  const float4* __restrict__ tri4, int max_leaf, int n,
                  float* __restrict__ out_t, int* __restrict__ out_prim,
                  float* __restrict__ out_u, float* __restrict__ out_v,
                  bool* __restrict__ out_occ, int* __restrict__ next_ray) {
  const int lane = threadIdx.x & 31;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) return;
    const int i = base + lane;
    if (i < n) {
      const Ray r = load_ray(o, d, i);
      float best_t = fminf(tmax[i], BIG_T);
      int best_p = -1;
      float best_u = 0.0f, best_v = 0.0f;
      bool occ = false;
      int steps = 0, boxes = 0, tests = 0;
      LocalStack stack;
      walk<ANYHIT>(node4, tri4, max_leaf, r, stack, best_t, best_p, best_u,
                   best_v, occ, steps, boxes, tests);
      if (ANYHIT) {
        out_occ[i] = occ;
      } else {
        out_t[i] = best_t;
        out_prim[i] = best_p;
        out_u[i] = best_u;
        out_v[i] = best_v;
      }
    }
    __syncwarp();
  }
}

template <bool ANYHIT>
static int launch_persistent(const float* o, const float* d,
                             const float* tmax, const float* node4,
                             const float* tri4, int max_leaf, int n,
                             float* out_t, int* out_prim, float* out_u,
                             float* out_v, bool* out_occ, int* next_ray,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, persistent_kernel<ANYHIT>, BLOCK, 0);
  cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (n > 0) {
    persistent_kernel<ANYHIT><<<sms * per_sm, BLOCK, 0, s>>>(
        o, d, tmax, reinterpret_cast<const float4*>(node4),
        reinterpret_cast<const float4*>(tri4), max_leaf, n, out_t, out_prim,
        out_u, out_v, out_occ, next_ray);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh2v_closest_persistent(const float* o, const float* d,
                                       const float* tmax, const float* node4,
                                       const float* tri4, int max_leaf, int n,
                                       float* out_t, int* out_prim,
                                       float* out_u, float* out_v,
                                       int* next_ray, void* stream) {
  return launch_persistent<false>(o, d, tmax, node4, tri4, max_leaf, n, out_t,
                                  out_prim, out_u, out_v, nullptr, next_ray,
                                  stream);
}

extern "C" int lh2v_occluded_persistent(const float* o, const float* d,
                                        const float* tmax, const float* node4,
                                        const float* tri4, int max_leaf,
                                        int n, bool* out_occ, int* next_ray,
                                        void* stream) {
  return launch_persistent<true>(o, d, tmax, node4, tri4, max_leaf, n,
                                 nullptr, nullptr, nullptr, nullptr, out_occ,
                                 next_ray, stream);
}

// Reserve `bytes` of L2 for persisting lines (0 releases it). Returns the
// cudaError and writes the card's largest reservation and window.
extern "C" int lh2v_set_persisting_l2(size_t bytes, int* max_persisting,
                                      int* max_window) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(max_persisting, cudaDevAttrMaxPersistingL2CacheSize,
                         dev);
  cudaDeviceGetAttribute(max_window, cudaDevAttrMaxAccessPolicyWindowSize,
                         dev);
  cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, bytes);
  if (bytes == 0) cudaCtxResetPersistingL2Cache();
  return static_cast<int>(cudaGetLastError());
}

static cudaLaunchConfig_t window_config(int n, void* stream,
                                        cudaLaunchAttribute* attr,
                                        void* base, size_t bytes,
                                        float hit_ratio) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BLOCK - 1) / BLOCK);
  cfg.blockDim = dim3(BLOCK);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeAccessPolicyWindow;
  attr->val.accessPolicyWindow.base_ptr = base;
  attr->val.accessPolicyWindow.num_bytes = bytes;
  attr->val.accessPolicyWindow.hitRatio = hit_ratio;
  attr->val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr->val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" int lh2v_closest_l2window(const float* o, const float* d,
                                     const float* tmax, const float* node4,
                                     const float* tri4, int max_leaf, int n,
                                     float* out_t, int* out_prim,
                                     float* out_u, float* out_v,
                                     void* window_base, size_t window_bytes,
                                     float hit_ratio, void* stream) {
  if (n > 0) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = window_config(n, stream, &attr, window_base,
                                           window_bytes, hit_ratio);
    cudaLaunchKernelEx(&cfg, closest_kernel, o, d, tmax,
                       reinterpret_cast<const float4*>(node4),
                       reinterpret_cast<const float4*>(tri4), max_leaf, n,
                       out_t, out_prim, out_u, out_v,
                       static_cast<int*>(nullptr));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh2v_occluded_l2window(const float* o, const float* d,
                                      const float* tmax, const float* node4,
                                      const float* tri4, int max_leaf, int n,
                                      bool* out_occ, void* window_base,
                                      size_t window_bytes, float hit_ratio,
                                      void* stream) {
  if (n > 0) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = window_config(n, stream, &attr, window_base,
                                           window_bytes, hit_ratio);
    cudaLaunchKernelEx(&cfg, occluded_kernel, o, d, tmax,
                       reinterpret_cast<const float4*>(node4),
                       reinterpret_cast<const float4*>(tri4), max_leaf, n,
                       out_occ, static_cast<int*>(nullptr));
  }
  return static_cast<int>(cudaGetLastError());
}

// BVH2 array-of-structs record, 16 words: left child box (lo.xyz, hi.xyz),
// right child box, then int left, right, count, first. The node order of
// bvh/traverse.py (near child first, ties to the left, far child pushed),
// as an if-if loop (WW false, the first CUDA port's loop) or a while-while
// loop (WW true).
template <bool ANYHIT, bool WW>
__device__ __forceinline__ void walk_aos2(const float4* __restrict__ node2,
                                          const float4* __restrict__ tri4,
                                          int max_leaf, const Ray& r,
                                          float& best_t, int& best_p,
                                          float& best_u, float& best_v,
                                          bool& occ, int& n_steps,
                                          int& n_pairs, int& n_tests) {
  int2 stack[STACK_CAP];
  int sp = 0;
  int node = 0;
  float cur_t = 0.0f;
  while (true) {
    int4 link = make_int4(0, 0, 0, 0);
    while (true) {
      ++n_steps;
      bool go = false;
      int next = 0;
      float next_t = 0.0f;
      bool leaf = false;
      if (!(cur_t >= best_t)) {
        const float4* nd = node2 + 4 * node;
        link = __ldg(reinterpret_cast<const int4*>(nd + 3));
        leaf = link.z > 0;
        if (!leaf) {
          ++n_pairs;
          const float4 q0 = __ldg(nd), q1 = __ldg(nd + 1), q2 = __ldg(nd + 2);
          bool hl, hr;
          const float tl = slab(r, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, best_t,
                                hl);
          const float tr = slab(r, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, best_t,
                                hr);
          if (hl && hr) {
            const bool near_l = tl <= tr;
            next = near_l ? link.x : link.y;
            next_t = fminf(tl, tr);
            stack[sp++] = make_int2(near_l ? link.y : link.x,
                                    __float_as_int(fmaxf(tl, tr)));
            go = true;
          } else if (hl || hr) {
            next = hl ? link.x : link.y;
            next_t = hl ? tl : tr;
            go = true;
          }
        }
      }
      if (WW && leaf) break;
      if (leaf) {
        for (int k = 0; k < link.z && k < max_leaf; ++k) {
          float t, u, v;
          int pid;
          ++n_tests;
          if (intersect(tri4, r, link.w + k, best_t, t, u, v, pid)) {
            occ = true;
            if (ANYHIT) return;
            best_t = t; best_p = pid; best_u = u; best_v = v;
          }
        }
      }
      if (go) {
        node = next;
        cur_t = next_t;
      } else if (sp > 0) {
        --sp;
        node = stack[sp].x;
        cur_t = __int_as_float(stack[sp].y);
      } else {
        return;
      }
    }
    for (int k = 0; k < link.z && k < max_leaf; ++k) {
      float t, u, v;
      int pid;
      ++n_tests;
      if (intersect(tri4, r, link.w + k, best_t, t, u, v, pid)) {
        occ = true;
        if (ANYHIT) return;
        best_t = t; best_p = pid; best_u = u; best_v = v;
      }
    }
    if (sp == 0) return;
    --sp;
    node = stack[sp].x;
    cur_t = __int_as_float(stack[sp].y);
  }
}

template <bool ANYHIT, bool WW>
__global__ void __launch_bounds__(BLOCK)
aos2_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ tmax, const float4* __restrict__ node2,
            const float4* __restrict__ tri4, int max_leaf, int n,
            float* __restrict__ out_t, int* __restrict__ out_prim,
            float* __restrict__ out_u, float* __restrict__ out_v,
            bool* __restrict__ out_occ, int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float best_t = fminf(tmax[i], BIG_T);
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool occ = false;
  int steps = 0, pairs = 0, tests = 0;
  walk_aos2<ANYHIT, WW>(node2, tri4, max_leaf, r, best_t, best_p, best_u,
                        best_v, occ, steps, pairs, tests);
  if (ANYHIT) {
    out_occ[i] = occ;
  } else {
    out_t[i] = best_t;
    out_prim[i] = best_p;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
  if (stats) {
    stats[i] = steps;
    stats[n + i] = pairs;
    stats[2 * n + i] = tests;
  }
}

template <bool ANYHIT, bool WW>
static void launch_aos2(const float* o, const float* d, const float* tmax,
                        const float* node2, const float* tri4, int max_leaf,
                        int n, float* out_t, int* out_prim, float* out_u,
                        float* out_v, bool* out_occ, int* stats,
                        void* stream) {
  aos2_kernel<ANYHIT, WW><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      o, d, tmax, reinterpret_cast<const float4*>(node2),
      reinterpret_cast<const float4*>(tri4), max_leaf, n, out_t, out_prim,
      out_u, out_v, out_occ, stats);
}

// ww: 0 the if-if loop, 1 the while-while loop.
extern "C" int lh2v_closest_aos2(const float* o, const float* d,
                                 const float* tmax, const float* node2,
                                 const float* tri4, int max_leaf, int n,
                                 int ww, float* out_t, int* out_prim,
                                 float* out_u, float* out_v, int* stats,
                                 void* stream) {
  if (n > 0) {
    if (ww)
      launch_aos2<false, true>(o, d, tmax, node2, tri4, max_leaf, n, out_t,
                               out_prim, out_u, out_v, nullptr, stats, stream);
    else
      launch_aos2<false, false>(o, d, tmax, node2, tri4, max_leaf, n, out_t,
                                out_prim, out_u, out_v, nullptr, stats,
                                stream);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh2v_occluded_aos2(const float* o, const float* d,
                                  const float* tmax, const float* node2,
                                  const float* tri4, int max_leaf, int n,
                                  int ww, bool* out_occ, int* stats,
                                  void* stream) {
  if (n > 0) {
    if (ww)
      launch_aos2<true, true>(o, d, tmax, node2, tri4, max_leaf, n, nullptr,
                              nullptr, nullptr, nullptr, out_occ, stats,
                              stream);
    else
      launch_aos2<true, false>(o, d, tmax, node2, tri4, max_leaf, n, nullptr,
                               nullptr, nullptr, nullptr, out_occ, stats,
                               stream);
  }
  return static_cast<int>(cudaGetLastError());
}
