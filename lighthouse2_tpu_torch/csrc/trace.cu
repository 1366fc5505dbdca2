// BVH2 closest-hit and any-hit trace kernels for Hopper (sm_90a).
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
// Here one thread walks one ray over the BVH2 that DeviceBVH holds
// (nbox [6,M], left/right/count [M], prim [T], tri9 [9,T]), near child
// first, with an explicit per-thread stack. Triangle ids are int32 (the TPU
// kernel's f32 tile*128+lane code is exact only below 2^24).
//
// Numerics. The node order and every floating-point operation follow the
// plain PyTorch version, lighthouse2_tpu_torch/bvh/traverse.py (_slab and
// core/geometry.py mt_comp), operation for operation. The library is
// compiled with -fmad=false so no multiply-add is contracted into an FMA:
// the kernel then rounds exactly as the plain version does and the two
// agree lane for lane.
//
// What bounds it on this card. The work is latency- and divergence-bound
// per ray: each step is a dependent chain of node loads, and the 32 rays of
// a warp take different paths and different step counts. The bytes are
// small: ~36 B per ray of input and output plus ~8 MB of scene for the
// 129k-triangle bathroom (tri9 4.7 MB, nbox 1.9 MB, the node and prim index
// arrays 1.5 MB), all of it resident in the 50 MB L2.
//
// What this simple design does about it: nothing yet. Later work: a wide
// (4- or 8-ary) BVH with compressed child boxes, float4 node and triangle
// layouts so a node or a triangle is one or two 16-byte loads, and persistent
// threads that fetch rays from a queue with ray compaction between bounces.
#include <cuda_runtime.h>

#define STACK_CAP 64   // keep equal to bvh/traverse.py STACK_CAP
#define BIG_T 1e30f
#define T_MIN 1e-6f
#define DET_EPS 1e-9f
#define BLOCK 128

struct Bvh {
  const float* nbox;   // [6, M]
  const int* left;     // [M]
  const int* right;    // [M]
  const int* count;    // [M]
  const int* prim;     // [T]
  const float* tri9;   // [9, T]
  int M, T, max_leaf;
};

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

// Slab test of node nid (traverse.py _slab). Returns the entry distance.
__device__ __forceinline__ float slab(const Bvh& b, const Ray& r, int nid,
                                      float best_t, bool& hit) {
  const int M = b.M;
  const float t0x = (b.nbox[nid] - r.ox) * r.ix;
  const float t1x = (b.nbox[3 * M + nid] - r.ox) * r.ix;
  const float t0y = (b.nbox[M + nid] - r.oy) * r.iy;
  const float t1y = (b.nbox[4 * M + nid] - r.oy) * r.iy;
  const float t0z = (b.nbox[2 * M + nid] - r.oz) * r.iz;
  const float t1z = (b.nbox[5 * M + nid] - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  hit = (tf >= fmaxf(tn, 0.0f)) && (tn < best_t);
  return tn;
}

// Moller-Trumbore against triangle pid (geometry.py mt_comp, same order).
__device__ __forceinline__ bool intersect(const Bvh& b, const Ray& r, int pid,
                                          float t_max, float& t, float& u,
                                          float& v) {
  const int T = b.T;
  const float* g = b.tri9;
  const float v0x = g[pid], v0y = g[T + pid], v0z = g[2 * T + pid];
  const float e1x = g[3 * T + pid], e1y = g[4 * T + pid], e1z = g[5 * T + pid];
  const float e2x = g[6 * T + pid], e2y = g[7 * T + pid], e2z = g[8 * T + pid];
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const bool valid = fabsf(a) > DET_EPS;
  const float f = 1.0f / (valid ? a : 1.0f);
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return valid && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > T_MIN && t < t_max;
}

// One ray's walk. ANYHIT returns at the first hit. The node sequence is the
// plain version's: a pruned or leaf node pops; an interior node descends
// into its hit child, the nearer one when both are hit (the farther pushed).
template <bool ANYHIT>
__device__ __forceinline__ void walk(const Bvh& b, const Ray& r, float& best_t,
                                     int& best_p, float& best_u, float& best_v,
                                     bool& occ, int* counts) {
  int stack_n[STACK_CAP];
  float stack_t[STACK_CAP];
  int sp = 0;
  int node = 0;
  float cur_t = 0.0f;
  while (true) {
    ++counts[0];
    bool go = false;
    int next = 0;
    float next_t = 0.0f;
    if (!(cur_t >= best_t)) {
      const int cnt = b.count[node];
      if (cnt > 0) {
        const int first = b.left[node];
        for (int k = 0; k < cnt && k < b.max_leaf; ++k) {
          const int pid = b.prim[first + k];
          float t, u, v;
          ++counts[2];
          if (intersect(b, r, pid, best_t, t, u, v)) {
            occ = true;
            if (ANYHIT) return;
            best_t = t; best_p = pid; best_u = u; best_v = v;
          }
        }
      } else {
        ++counts[1];
        const int l = b.left[node], rt = b.right[node];
        bool hl, hr;
        const float tl = slab(b, r, l, best_t, hl);
        const float tr = slab(b, r, rt, best_t, hr);
        if (hl && hr) {
          const bool near_l = tl <= tr;
          next = near_l ? l : rt;
          next_t = fminf(tl, tr);
          stack_n[sp] = near_l ? rt : l;
          stack_t[sp] = fmaxf(tl, tr);
          ++sp;
          go = true;
        } else if (hl || hr) {
          next = hl ? l : rt;
          next_t = hl ? tl : tr;
          go = true;
        }
      }
    }
    if (go) {
      node = next;
      cur_t = next_t;
    } else if (sp > 0) {
      --sp;
      node = stack_n[sp];
      cur_t = stack_t[sp];
    } else {
      return;
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax, Bvh b, int n,
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
  int counts[3] = {0, 0, 0};
  walk<false>(b, r, best_t, best_p, best_u, best_v, occ, counts);
  out_t[i] = best_t;
  out_prim[i] = best_p;
  out_u[i] = best_u;
  out_v[i] = best_v;
  if (stats) {
    stats[i] = counts[0];
    stats[n + i] = counts[1];
    stats[2 * n + i] = counts[2];
  }
}

__global__ void __launch_bounds__(BLOCK)
occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmax, Bvh b, int n,
                bool* __restrict__ out_occ, int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float best_t = fminf(tmax[i], BIG_T);
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool occ = false;
  int counts[3] = {0, 0, 0};
  walk<true>(b, r, best_t, best_p, best_u, best_v, occ, counts);
  out_occ[i] = occ;
  if (stats) {
    stats[i] = counts[0];
    stats[n + i] = counts[1];
    stats[2 * n + i] = counts[2];
  }
}

static Bvh make_bvh(const float* nbox, const int* left, const int* right,
                    const int* count, const int* prim, const float* tri9,
                    int n_nodes, int n_tris, int max_leaf) {
  Bvh b;
  b.nbox = nbox; b.left = left; b.right = right; b.count = count;
  b.prim = prim; b.tri9 = tri9;
  b.M = n_nodes; b.T = n_tris; b.max_leaf = max_leaf;
  return b;
}

// C entry points (bound with ctypes by render/kernels/trace.py). Each
// launches on `stream` without synchronising and returns cudaGetLastError().
// `stats` may be null; otherwise it receives int32 [3, n] per-ray counts:
// steps (node visits), interior nodes whose two child boxes were tested, and
// triangle tests.
extern "C" int lh2_trace_closest(const float* o, const float* d,
                                 const float* tmax, const float* nbox,
                                 const int* left, const int* right,
                                 const int* count, const int* prim,
                                 const float* tri9, int n_nodes, int n_tris,
                                 int max_leaf, int n, float* out_t,
                                 int* out_prim, float* out_u, float* out_v,
                                 int* stats, void* stream) {
  if (n > 0) {
    const Bvh b = make_bvh(nbox, left, right, count, prim, tri9, n_nodes,
                           n_tris, max_leaf);
    closest_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, b, n, out_t, out_prim, out_u, out_v, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh2_trace_occluded(const float* o, const float* d,
                                  const float* tmax, const float* nbox,
                                  const int* left, const int* right,
                                  const int* count, const int* prim,
                                  const float* tri9, int n_nodes, int n_tris,
                                  int max_leaf, int n, bool* out_occ,
                                  int* stats, void* stream) {
  if (n > 0) {
    const Bvh b = make_bvh(nbox, left, right, count, prim, tri9, n_nodes,
                           n_tris, max_leaf);
    occluded_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, b, n, out_occ, stats);
  }
  return static_cast<int>(cudaGetLastError());
}
