// Cluster-tile closest-hit and any-hit trace kernels for Hopper (sm_90a).
//
// What they replace. lighthouse2_tpu/render/kernels/trace.py:
//   lh2_cluster_closest  <- _make_closest_kernel (with _make_next_leaf,
//                           _frustum_hit, _lane_slab, _sub_forms, _sub_hits)
//   lh2_cluster_occluded <- _make_anyhit_kernel
// both launched there by _trace_chunk. They take the Pallas kernels' own
// inputs: the ClusterBVH's top tree (boxes [8, M] f32, meta [4, M] int32),
// its plane + barycentric tiles (bmat [CT, 8, 768] f32) and the ray tile
// x [8, Nc] f32 (o.xyz, d.xyz, 1, tmax) of Nc = 1024 * n_blocks lanes. The
// closest kernel writes the winner code tile * 128 + lane (int32, -1 on a
// miss), the best t, and each block's tile visits and sub-packet
// intersections; the any-hit kernel whether anything lies before tmax.
//
// Design (simple and right first; one thread block per 1024-ray block):
//   - the block computes its own frustum (_block_frustum: origin box and
//     inverse-direction interval over the live lanes, tmax <= 0 is dead) by
//     a block reduction; a block without a live lane writes a miss;
//   - thread 0 walks the top tree (a stack in shared memory) near child
//     first, the near child chosen by the frustum's direction sign on the
//     node's split axis, culling nodes with the conservative interval slab
//     test of _frustum_hit including its any-sign distance bound, and
//     publishes the next leaf through shared memory;
//   - at a leaf every thread tests its own lane against the leaf's box
//     (_lane_slab, against its best t); a warp vote marks each 128-lane
//     sub-packet that has a candidate lane;
//   - each of the cluster's tiles (8 x 768 f32, 24 KB) is copied into
//     shared memory, and each thread of a marked sub-packet evaluates the
//     six linear forms of all 128 triangles for its ray, term by term in
//     FP32 (no tensor cores): t = tn / dn, u = ou + t du, v = ov + t dv,
//     a hit where u >= 0, v >= 0, u + v <= 1 and 1e-6 < t < best;
//   - tie rules as the Pallas kernel's: in a tile the lowest lane among the
//     minima wins, and a tile replaces the current hit only if strictly
//     closer.
// The walk bound (schedule): the walk culls with `bm`, which starts at the
// block's largest live tmax and is refreshed after EVERY leaf from the
// block's largest best t over its live lanes (closest) or largest tmax over
// its live unoccluded lanes (any-hit). Closest-hit computes the sub-packet
// marks once per leaf (against the best t at the leaf's start) and uses
// them for all of the cluster's tiles; any-hit marks again before every
// tile, skips occluded lanes and leaves the block once bm <= 0 (every live
// lane occluded). The plain version (render/kernels/cluster.py) runs this
// schedule, so the visit and sub-packet counters agree lane for lane; they
// differ from the Pallas kernel's, whose DMA ring processes two leaves per
// step and refreshes its bound every BM_PERIOD leaves. The hits do not
// depend on the schedule, apart from exact t-ties.
//
// What bounds them on this card. Operations: every marked sub-packet costs
// 128 x 128 (ray, triangle) pairs of ~55 FP32 operations, about 1 MFLOP a
// sub-packet and tile, against a few hundred flops a ray for the BVH4
// kernels of trace.cu; the TPU design spends these FLOPs to feed its MXU.
// Bytes are small beside them (a 24 KB tile a leaf a block, read from L2).
// The walk of one thread per block serialises the node tests. TMA tile
// loads, a ring of tiles, wgmma / 3xTF32 products on the tiles and a
// parallel walk are work for later.
//
// Numerics. Every operation follows the plain version operation for
// operation, and the library is compiled with -fmad=false, so no multiply-
// add is contracted: kernel and plain version agree on every lane. The
// forms skip the structurally zero rows of each block of bmat (rows 3..5
// of the origin forms, 0..2 and 6 of the direction forms, row 7 of all),
// which cut_clusters and rebake_geometry never fill.
#include <cuda_runtime.h>

#define BLOCK 1024
#define SUB 128
#define NWARPS (BLOCK / 32)
#define LANES 128
#define BMAT_ROWS 8
#define BMAT_COLS 768
#define TILE_FLOATS (BMAT_ROWS * BMAT_COLS)
#define MAX_STACK 1024     // keep equal to render/kernels/cluster.py MAX_STACK
#define BIG 1e30f
#define MT_EPS 1e-6f

// frustum slots in shared memory (_block_frustum's rows)
#define FR_OMIN 0
#define FR_OMAX 3
#define FR_IMIN 6
#define FR_IMAX 9
#define FR_TLIM 12
#define FR_N 13

// bmat column blocks
#define BLK_TN 0
#define BLK_DN 1
#define BLK_OU 2
#define BLK_DU 3
#define BLK_OV 4
#define BLK_DV 5

struct Shared {
  float tile[TILE_FLOATS];   // first member: 16-byte aligned for float4
  float red[NWARPS][FR_N];
  float fr[FR_N];
  float wmax[NWARPS];
  int stack[MAX_STACK];
  int leaf;
  unsigned bits[2];
};

__device__ __forceinline__ float inv_dir(float d) {
  const float mag = fmaxf(fabsf(d), 1e-18f);
  return d < 0.0f ? -1.0f / mag : 1.0f / mag;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Lane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmax;
  bool live;
};

// Load this thread's ray, reduce the block's frustum into s.fr. Returns
// whether the block has a live lane (the same value in every thread).
__device__ bool load_block(const float* __restrict__ x, int nc, Shared& s,
                           Lane& r) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long i = static_cast<long>(blockIdx.x) * BLOCK + tid;
  r.ox = x[i];
  r.oy = x[static_cast<long>(nc) + i];
  r.oz = x[2L * nc + i];
  r.dx = x[3L * nc + i];
  r.dy = x[4L * nc + i];
  r.dz = x[5L * nc + i];
  r.tmax = x[7L * nc + i];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  r.live = r.tmax > 0.0f;
  float v[FR_N] = {
      r.live ? r.ox : BIG,  r.live ? r.oy : BIG,  r.live ? r.oz : BIG,
      r.live ? r.ox : -BIG, r.live ? r.oy : -BIG, r.live ? r.oz : -BIG,
      r.live ? r.ix : BIG,  r.live ? r.iy : BIG,  r.live ? r.iz : BIG,
      r.live ? r.ix : -BIG, r.live ? r.iy : -BIG, r.live ? r.iz : -BIG,
      r.live ? r.tmax : 0.0f};
#pragma unroll
  for (int k = 0; k < FR_N; ++k) {
    const bool is_min = (k < 3) || (k >= 6 && k < 9);
    v[k] = is_min ? warp_min(v[k]) : warp_max(v[k]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < FR_N; ++k) s.red[warp][k] = v[k];
  }
  const int any_live = __syncthreads_or(r.live);
  if (tid < FR_N) {
    const bool is_min = (tid < 3) || (tid >= 6 && tid < 9);
    float a = s.red[0][tid];
    for (int w = 1; w < NWARPS; ++w)
      a = is_min ? fminf(a, s.red[w][tid]) : fmaxf(a, s.red[w][tid]);
    s.fr[tid] = a;
  }
  if (tid == 0) {
    s.stack[0] = 0;
    s.bits[0] = 0u;
    s.bits[1] = 0u;
  }
  __syncthreads();
  return any_live != 0;
}

// _frustum_hit: can any ray of the block's frustum hit node nd before tlim?
__device__ __forceinline__ bool frustum_hit(const float* __restrict__ boxes,
                                            int m, int nd, const float* fr,
                                            float tlim) {
  float tn = 0.0f, tf = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float om_lo = fr[FR_OMIN + a], om_hi = fr[FR_OMAX + a];
    const float i_lo = fr[FR_IMIN + a], i_hi = fr[FR_IMAX + a];
    const float bmin = __ldg(boxes + a * m + nd);
    const float bmax = __ldg(boxes + (3 + a) * m + nd);
    const float u1 = bmin - om_hi, v1 = bmin - om_lo;
    const float u2 = bmax - om_hi, v2 = bmax - om_lo;
    const float p0 = u1 * i_lo, p1 = u1 * i_hi, p2 = v1 * i_lo, p3 = v1 * i_hi;
    const float p4 = u2 * i_lo, p5 = u2 * i_hi, p6 = v2 * i_lo, p7 = v2 * i_hi;
    const float lo = fminf(fminf(fminf(p0, p1), fminf(p2, p3)),
                           fminf(fminf(p4, p5), fminf(p6, p7)));
    const float hi = fmaxf(fmaxf(fmaxf(p0, p1), fmaxf(p2, p3)),
                           fmaxf(fmaxf(p4, p5), fmaxf(p6, p7)));
    tn = fmaxf(tn, fmaxf(lo, fmaxf(u1, -v2)));
    tf = fminf(tf, hi);
  }
  return (tf >= tn) && (tn < tlim);
}

// _make_next_leaf: pop until a frustum-hit leaf (its node id) or an empty
// stack (-1). Children are pushed far first so the near child pops first.
__device__ int next_leaf(const float* __restrict__ boxes,
                         const int* __restrict__ meta, int m, Shared& s,
                         int& sp, float tlim) {
  int nl = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    nl |= (s.fr[FR_IMIN + a] + s.fr[FR_IMAX + a] >= 0.0f ? 1 : 0) << a;
  while (sp > 0) {
    const int nd = s.stack[--sp];
    if (!frustum_hit(boxes, m, nd, s.fr, tlim)) continue;
    if (__ldg(meta + m + nd) >= 0) return nd;
    const int right = __ldg(meta + 2 * m + nd);
    const int axis = __ldg(meta + 3 * m + nd);
    const bool near_left = ((nl >> axis) & 1) != 0;
    s.stack[sp] = near_left ? right : nd + 1;
    s.stack[sp + 1] = near_left ? nd + 1 : right;
    sp += 2;
  }
  return -1;
}

// _lane_slab: this lane's ray against the leaf's box, before `limit`.
__device__ __forceinline__ bool lane_slab(const float* __restrict__ boxes,
                                          int m, int nd, const Lane& r,
                                          float limit) {
  const float t0x = (__ldg(boxes + nd) - r.ox) * r.ix;
  const float t1x = (__ldg(boxes + 3 * m + nd) - r.ox) * r.ix;
  const float t0y = (__ldg(boxes + m + nd) - r.oy) * r.iy;
  const float t1y = (__ldg(boxes + 4 * m + nd) - r.oy) * r.iy;
  const float t0z = (__ldg(boxes + 2 * m + nd) - r.oz) * r.iz;
  const float t1z = (__ldg(boxes + 5 * m + nd) - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), 0.0f));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return (tf >= tn) && (tn < limit);
}

__device__ __forceinline__ void load_tile(const float* __restrict__ bmat,
                                          int tile, Shared& s) {
  const float4* src =
      reinterpret_cast<const float4*>(bmat + static_cast<long>(tile) *
                                                 TILE_FLOATS);
  float4* dst = reinterpret_cast<float4*>(s.tile);
  for (int k = threadIdx.x; k < TILE_FLOATS / 4; k += BLOCK)
    dst[k] = __ldg(src + k);
}

// The six forms of triangle k of the tile in shared memory for one ray.
// Returns whether (t, u, v) is a hit before `limit`; t in t_out.
__device__ __forceinline__ bool tri_hit(const float* tile, int k,
                                        const Lane& r, float limit,
                                        float& t_out) {
#define C(row, blk) tile[(row) * BMAT_COLS + (blk) * LANES + k]
  const float tn = ((C(0, BLK_TN) * r.ox + C(1, BLK_TN) * r.oy) +
                    C(2, BLK_TN) * r.oz) + C(6, BLK_TN);
  const float dn = (C(3, BLK_DN) * r.dx + C(4, BLK_DN) * r.dy) +
                   C(5, BLK_DN) * r.dz;
  const float ou = ((C(0, BLK_OU) * r.ox + C(1, BLK_OU) * r.oy) +
                    C(2, BLK_OU) * r.oz) + C(6, BLK_OU);
  const float du = (C(3, BLK_DU) * r.dx + C(4, BLK_DU) * r.dy) +
                   C(5, BLK_DU) * r.dz;
  const float ov = ((C(0, BLK_OV) * r.ox + C(1, BLK_OV) * r.oy) +
                    C(2, BLK_OV) * r.oz) + C(6, BLK_OV);
  const float dv = (C(3, BLK_DV) * r.dx + C(4, BLK_DV) * r.dy) +
                   C(5, BLK_DV) * r.dz;
#undef C
  const float t = tn / dn;
  const float u = ou + t * du;
  const float v = ov + t * dv;
  t_out = t;
  return u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && t > MT_EPS &&
         t < limit;
}

__global__ void __launch_bounds__(BLOCK, 1)
cluster_closest_kernel(const float* __restrict__ boxes,
                       const int* __restrict__ meta,
                       const float* __restrict__ bmat,
                       const float* __restrict__ x, int m, int tpc, int nc,
                       int* __restrict__ out_code, float* __restrict__ out_t,
                       int* __restrict__ out_visits,
                       int* __restrict__ out_subs) {
  __shared__ __align__(16) Shared s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = tid / SUB;
  const long i = static_cast<long>(blockIdx.x) * BLOCK + tid;
  Lane r;
  if (!load_block(x, nc, s, r)) {
    out_code[i] = -1;
    out_t[i] = 0.0f;
    if (tid == 0) {
      out_visits[blockIdx.x] = 0;
      out_subs[blockIdx.x] = 0;
    }
    return;
  }
  float best = r.tmax;
  int code = -1;
  int visits = 0, subs = 0, sp = 1;
  bool first = true;
  for (;;) {
    if (tid == 0) {
      float bm = s.fr[FR_TLIM];
      if (!first) {
        bm = s.wmax[0];
        for (int w = 1; w < NWARPS; ++w) bm = fmaxf(bm, s.wmax[w]);
      }
      s.leaf = next_leaf(boxes, meta, m, s, sp, bm);
      s.bits[0] = 0u;
    }
    __syncthreads();
    const int leaf = s.leaf;
    if (leaf < 0) break;
    first = false;
    const bool cand = lane_slab(boxes, m, leaf, r, best);
    const unsigned vote = __ballot_sync(0xffffffffu, cand);
    if (lane == 0 && vote != 0u) atomicOr(&s.bits[0], 1u << sub);
    const int t0 = max(__ldg(meta + m + leaf), 0) * tpc;
    unsigned bits = 0u;
    for (int j = 0; j < tpc; ++j) {
      if (j > 0) __syncthreads();
      load_tile(bmat, t0 + j, s);
      __syncthreads();
      bits = s.bits[0];
      if ((bits >> sub) & 1u) {
        const float bs = best;
        float tb = BIG;
        int win = 0;
        for (int k = 0; k < LANES; ++k) {
          float t;
          const float tm = tri_hit(s.tile, k, r, bs, t) ? t : BIG;
          if (tm < tb) {
            tb = tm;
            win = k;
          }
        }
        if (tb < bs) {
          best = tb;
          code = (t0 + j) * LANES + win;
        }
      }
    }
    visits += tpc;
    subs += tpc * __popc(bits);
    const float wm = warp_max(r.live ? best : 0.0f);
    if (lane == 0) s.wmax[warp] = wm;
    __syncthreads();
  }
  out_code[i] = code;
  out_t[i] = best;
  if (tid == 0) {
    out_visits[blockIdx.x] = visits;
    out_subs[blockIdx.x] = subs;
  }
}

__global__ void __launch_bounds__(BLOCK, 1)
cluster_occluded_kernel(const float* __restrict__ boxes,
                        const int* __restrict__ meta,
                        const float* __restrict__ bmat,
                        const float* __restrict__ x, int m, int tpc, int nc,
                        unsigned char* __restrict__ out_occ) {
  __shared__ __align__(16) Shared s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = tid / SUB;
  const long i = static_cast<long>(blockIdx.x) * BLOCK + tid;
  Lane r;
  if (!load_block(x, nc, s, r)) {
    out_occ[i] = 0;
    return;
  }
  bool occ = !(r.tmax > 0.0f);   // occluded or dead
  int sp = 1, k = 0;
  bool first = true;
  for (;;) {
    if (tid == 0) {
      float bm = s.fr[FR_TLIM];
      if (!first) {
        bm = s.wmax[0];
        for (int w = 1; w < NWARPS; ++w) bm = fmaxf(bm, s.wmax[w]);
      }
      s.leaf = bm > 0.0f ? next_leaf(boxes, meta, m, s, sp, bm) : -1;
    }
    __syncthreads();
    const int leaf = s.leaf;
    if (leaf < 0) break;
    first = false;
    const int t0 = max(__ldg(meta + m + leaf), 0) * tpc;
    for (int j = 0; j < tpc; ++j, ++k) {
      if (j > 0) __syncthreads();
      const int par = k & 1;
      const bool cand = !occ && lane_slab(boxes, m, leaf, r, r.tmax);
      const unsigned vote = __ballot_sync(0xffffffffu, cand);
      if (lane == 0 && vote != 0u) atomicOr(&s.bits[par], 1u << sub);
      load_tile(bmat, t0 + j, s);
      __syncthreads();
      const unsigned bits = s.bits[par];
      if (tid == 0) s.bits[par ^ 1] = 0u;
      if (((bits >> sub) & 1u) && !occ) {
        for (int q = 0; q < LANES; ++q) {
          float t;
          if (tri_hit(s.tile, q, r, r.tmax, t)) {
            occ = true;
            break;
          }
        }
      }
    }
    const float wm = warp_max(occ ? 0.0f : r.tmax);
    if (lane == 0) s.wmax[warp] = wm;
    __syncthreads();
  }
  out_occ[i] = (r.tmax > 0.0f && occ) ? 1 : 0;
}

// C entry points (bound with ctypes by render/kernels/cluster.py). Each
// launches n_blocks blocks of 1024 threads on `stream` without
// synchronising and returns cudaGetLastError(). boxes [8, m] f32, meta
// [4, m] int32, bmat [CT, 8, 768] f32 (16-byte aligned), x [8, 1024 *
// n_blocks] f32, all contiguous. The wrapper checks that the top tree's
// stack needs at most MAX_STACK entries.
extern "C" int lh2_cluster_closest(const float* boxes, const int* meta,
                                   const float* bmat, const float* x, int m,
                                   int tpc, int n_blocks, int* out_code,
                                   float* out_t, int* out_visits,
                                   int* out_subs, void* stream) {
  if (n_blocks > 0) {
    cluster_closest_kernel<<<n_blocks, BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        boxes, meta, bmat, x, m, tpc, n_blocks * BLOCK, out_code, out_t,
        out_visits, out_subs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh2_cluster_occluded(const float* boxes, const int* meta,
                                    const float* bmat, const float* x, int m,
                                    int tpc, int n_blocks,
                                    unsigned char* out_occ, void* stream) {
  if (n_blocks > 0) {
    cluster_occluded_kernel<<<n_blocks, BLOCK, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        boxes, meta, bmat, x, m, tpc, n_blocks * BLOCK, out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}
