"""NavMesh building: scene triangles -> walkable heightfield -> regions.

Reference pipeline (lib/PathFinding/navmesh_builder.h:30-85 +
PathFinding/README.md config table): rasterize triangles into a voxel
heightfield, filter walkable spans by slope/height/climb, erode by agent
radius, partition into regions. recastnavigation does this span-by-span in
C++; here each pass is a vectorized numpy computation over the whole grid.

The navmesh this produces is heightfield-based: a 2D walkable mask plus a
floor-height map, partitioned into connected regions. Navigation quality is
equivalent for query purposes (find_path / find_nearest / raycast), without
the contour/polygonization machinery Detour needs for its BVH'd poly lookup.

Known limitation (documented deviation from recast): the heightfield keeps a
SINGLE span per column — the highest walkable surface. Scenes with walkable
overlaps (bridges over walkable ground, multi-storey interiors) resolve each
column to the topmost floor only; ground beneath a walkable overhang is not
navigable. recast's multi-span heightfield supports these; add spans here if
such scenes ever matter.

A copy of lighthouse2_tpu/pathfinding/builder.py (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NavMeshConfig:
    """Build configuration (reference: PathFinding/README.md config table;
    defaults follow the recast sample defaults the reference uses)."""
    cell_size: float = 0.3          # xz voxel size (world units)
    cell_height: float = 0.2        # y voxel size
    agent_height: float = 2.0       # minimum clearance above the floor
    agent_radius: float = 0.6       # erosion radius around obstructions
    agent_max_climb: float = 0.9    # max step height between adjacent cells
    agent_max_slope: float = 45.0   # degrees; steeper triangles unwalkable
    min_region_area: float = 0.5    # drop regions smaller than this (m^2)
    # AABB of the navigable world; None = fit to the input triangles
    bounds_min: "np.ndarray | None" = None
    bounds_max: "np.ndarray | None" = None


@dataclasses.dataclass
class NavMesh:
    """Built navigation data (the dtNavMesh analog, as plain arrays)."""
    config: NavMeshConfig
    origin: np.ndarray        # world xz of cell (0, 0) corner + base y
    walkable: np.ndarray      # (nx, nz) bool
    floor: np.ndarray         # (nx, nz) float32 floor height (y), nan if none
    region: np.ndarray        # (nx, nz) int32 region id, -1 where unwalkable
    n_regions: int = 0

    @property
    def nx(self):
        return self.walkable.shape[0]

    @property
    def nz(self):
        return self.walkable.shape[1]

    # --- world <-> grid -------------------------------------------------
    def world_to_cell(self, pos) -> tuple:
        pos = np.asarray(pos, np.float64)
        cs = self.config.cell_size
        ix = int(np.floor((pos[0] - self.origin[0]) / cs))
        iz = int(np.floor((pos[2] - self.origin[2]) / cs))
        return ix, iz

    def cell_to_world(self, ix, iz) -> np.ndarray:
        cs = self.config.cell_size
        x = self.origin[0] + (ix + 0.5) * cs
        z = self.origin[2] + (iz + 0.5) * cs
        y = self.floor[ix, iz] if self.in_bounds(ix, iz) else self.origin[1]
        if np.isnan(y):
            y = self.origin[1]
        return np.array([x, y, z], np.float32)

    def in_bounds(self, ix, iz) -> bool:
        return 0 <= ix < self.nx and 0 <= iz < self.nz

    def is_walkable(self, ix, iz) -> bool:
        return self.in_bounds(ix, iz) and bool(self.walkable[ix, iz])

    def height_at(self, pos) -> float:
        ix, iz = self.world_to_cell(pos)
        if self.is_walkable(ix, iz):
            return float(self.floor[ix, iz])
        return float("nan")


class NavMeshBuilder:
    """Builds a NavMesh from triangle soup or a HostScene
    (NavMeshBuilder::Build analog, navmesh_builder.h:44)."""

    def __init__(self, config: NavMeshConfig | None = None):
        self.config = config or NavMeshConfig()
        self.navmesh: NavMesh | None = None

    # -- input collection ------------------------------------------------
    @staticmethod
    def scene_triangles(scene) -> np.ndarray:
        """World-space (T, 3, 3) vertices of every instanced mesh in the
        scene (analog of the builder's input mesh extraction from
        HostScene)."""
        tris = []
        for mesh_id, world, node in scene.flatten_instances():
            posed = scene._posed_mesh(scene.meshes[mesh_id], node)
            moved = posed.transformed(world)
            tris.append(np.stack([moved.v0, moved.v1, moved.v2], 1))
        if not tris:
            return np.zeros((0, 3, 3), np.float32)
        return np.concatenate(tris, 0).astype(np.float32)

    def build_from_scene(self, scene) -> NavMesh:
        return self.build(self.scene_triangles(scene))

    # -- the pipeline ----------------------------------------------------
    def build(self, triangles: np.ndarray) -> NavMesh:
        """triangles: (T, 3, 3) world-space vertex positions (y up)."""
        cfg = self.config
        tri = np.asarray(triangles, np.float64).reshape(-1, 3, 3)
        if tri.shape[0] == 0:
            raise ValueError("navmesh build: no input triangles")

        lo = (np.asarray(cfg.bounds_min, np.float64)
              if cfg.bounds_min is not None else tri.reshape(-1, 3).min(0))
        hi = (np.asarray(cfg.bounds_max, np.float64)
              if cfg.bounds_max is not None else tri.reshape(-1, 3).max(0))
        cs = cfg.cell_size
        nx = max(1, int(np.ceil((hi[0] - lo[0]) / cs)))
        nz = max(1, int(np.ceil((hi[2] - lo[2]) / cs)))

        floor, ceil_above = self._rasterize(tri, lo, nx, nz)
        walk = self._filter_walkable(floor, ceil_above)
        walk = self._erode(walk)
        region, n_regions = self._regions(walk, floor)
        # drop the cells of culled small regions
        walk = region >= 0

        self.navmesh = NavMesh(
            config=cfg, origin=lo.astype(np.float32),
            walkable=walk, floor=floor.astype(np.float32),
            region=region, n_regions=n_regions)
        return self.navmesh

    def _raster_footprint(self, v, lo, nx, nz):
        """Conservative xz coverage of one triangle: returns (slices, inside
        mask, ylo, yhi arrays over the covered sub-grid) or None.

        Non-degenerate xz projections use barycentric tests padded by the
        true world-to-barycentric gradient magnitudes (|grad w0| =
        hypot(bz-cz, cx-bx)/|den| etc.) so thin/elongated triangles still
        cover every cell-center they touch. Vertical triangles (degenerate
        xz projection) are rasterized over their edge segments so walls
        modeled as vertical quads obstruct (recast voxelizes all triangles
        into blocking spans)."""
        cs = self.config.cell_size
        x0 = int(np.floor((v[:, 0].min() - lo[0]) / cs))
        x1 = int(np.floor((v[:, 0].max() - lo[0]) / cs))
        z0 = int(np.floor((v[:, 2].min() - lo[2]) / cs))
        z1 = int(np.floor((v[:, 2].max() - lo[2]) / cs))
        x0, x1 = max(0, x0), min(nx - 1, x1)
        z0, z1 = max(0, z0), min(nz - 1, z1)
        if x1 < x0 or z1 < z0:
            return None
        gx = lo[0] + (np.arange(x0, x1 + 1) + 0.5) * cs
        gz = lo[2] + (np.arange(z0, z1 + 1) + 0.5) * cs
        px, pz = np.meshgrid(gx, gz, indexing="ij")
        sl = (slice(x0, x1 + 1), slice(z0, z1 + 1))

        ax, az = v[0, 0], v[0, 2]
        bx, bz = v[1, 0], v[1, 2]
        cx, cz = v[2, 0], v[2, 2]
        den = (bz - cz) * (ax - cx) + (cx - bx) * (az - cz)
        y_min, y_max = v[:, 1].min(), v[:, 1].max()

        if abs(den) < 1e-9:
            # vertical / degenerate projection: cover all cells whose center
            # is within half a cell diagonal of any edge segment in xz
            inside = np.zeros(px.shape, bool)
            for (p, q) in ((v[0], v[1]), (v[1], v[2]), (v[2], v[0])):
                ex, ez = q[0] - p[0], q[2] - p[2]
                ll = ex * ex + ez * ez
                if ll < 1e-18:
                    tpar = np.zeros_like(px)
                else:
                    tpar = np.clip(((px - p[0]) * ex + (pz - p[2]) * ez) / ll,
                                   0.0, 1.0)
                dx = px - (p[0] + tpar * ex)
                dz = pz - (p[2] + tpar * ez)
                inside |= (dx * dx + dz * dz) <= (0.71 * cs) ** 2
            if not inside.any():
                return None
            ylo = np.where(inside, y_min, np.inf)
            yhi = np.where(inside, y_max, -np.inf)
            return sl, inside, ylo, yhi

        # barycentric gradients in the xz plane (units 1/length)
        g0 = np.hypot(bz - cz, cx - bx) / abs(den)
        g1 = np.hypot(cz - az, ax - cx) / abs(den)
        g2 = np.hypot(az - bz, bx - ax) / abs(den)
        w0 = ((bz - cz) * (px - cx) + (cx - bx) * (pz - cz)) / den
        w1 = ((cz - az) * (px - cx) + (ax - cx) * (pz - cz)) / den
        w2 = 1.0 - w0 - w1
        r = 0.71 * cs
        inside = (w0 >= -r * g0) & (w1 >= -r * g1) & (w2 >= -r * g2)
        if not inside.any():
            return None
        y = w0 * v[0, 1] + w1 * v[1, 1] + w2 * v[2, 1]
        # y variation across one cell from the plane's xz slope
        gyx = v[0, 1] * (bz - cz) / den + v[1, 1] * (cz - az) / den \
            + v[2, 1] * (az - bz) / den
        gyz = v[0, 1] * (cx - bx) / den + v[1, 1] * (ax - cx) / den \
            + v[2, 1] * (bx - ax) / den
        dy = r * np.hypot(gyx, gyz)
        ylo = np.where(inside, np.clip(y - dy, y_min, y_max), np.inf)
        yhi = np.where(inside, np.clip(y + dy, y_min, y_max), -np.inf)
        return sl, inside, ylo, yhi

    def _rasterize(self, tri, lo, nx, nz):
        """Heightfield rasterization in two passes over all triangles:
        pass 1 finds the floor (highest up-facing shallow-slope surface per
        column, recast's walkable rule: norm.y >= cos(maxSlope)); pass 2
        marks columns blocked where ANY triangle's span intrudes into the
        agent's clearance volume (floor+maxClimb, floor+agentHeight)."""
        cfg = self.config
        cos_max = np.cos(np.radians(cfg.agent_max_slope))
        ch = max(cfg.cell_height, 1e-6)

        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        n = np.cross(e1, e2)
        nlen = np.linalg.norm(n, axis=1)
        ok = nlen > 1e-12
        n = n[ok] / nlen[ok, None]
        tri = tri[ok]
        # walkable = up-facing AND shallow slope; down-facing or steep
        # triangles are pure obstructions (recast filterWalkableTriangles)
        walk_tri = n[:, 1] >= cos_max

        floor = np.full((nx, nz), np.nan)
        rasters = []
        for t in range(tri.shape[0]):
            fp = self._raster_footprint(tri[t], lo, nx, nz)
            rasters.append(fp)
            if fp is None or not walk_tri[t]:
                continue
            sl, inside, ylo, yhi = fp
            # surface height quantized UP to the cell_height grid
            # (recast span smax quantization)
            y = np.ceil(yhi / ch) * ch
            f = floor[sl]
            upd = inside & (np.isnan(f) | (y > f))
            floor[sl] = np.where(upd, y, f)

        blocked = np.zeros((nx, nz), bool)
        climb = cfg.agent_max_climb
        for t in range(tri.shape[0]):
            fp = rasters[t]
            if fp is None:
                continue
            sl, inside, ylo, yhi = fp
            f = floor[sl]
            b = inside & ~np.isnan(f) \
                & (yhi > f + climb) & (ylo < f + cfg.agent_height)
            if walk_tri[t]:
                # a walkable surface that IS the floor (or a step within
                # max-climb of it) does not block its own column
                b &= ylo > f + climb
            blocked[sl] |= b
        return floor, blocked

    def _filter_walkable(self, floor, blocked):
        return ~np.isnan(floor) & ~blocked

    def _erode(self, walk):
        """Erode the walkable area by agent_radius (recast erodeWalkableArea
        analog) using iterated 4-neighbour erosion."""
        r_cells = int(np.ceil(self.config.agent_radius / self.config.cell_size))
        for _ in range(r_cells):
            w = walk
            shrunk = w.copy()
            shrunk[1:, :] &= w[:-1, :]
            shrunk[:-1, :] &= w[1:, :]
            shrunk[:, 1:] &= w[:, :-1]
            shrunk[:, :-1] &= w[:, 1:]
            walk = shrunk
        return walk

    def _regions(self, walk, floor):
        """Connected-component regions with the max-climb constraint: two
        adjacent cells connect only if |dy| <= agent_max_climb (recast
        region partitioning analog). BFS flood fill."""
        cfg = self.config
        nx, nz = walk.shape
        region = np.full((nx, nz), -1, np.int32)
        climb = cfg.agent_max_climb
        min_cells = int(np.ceil(cfg.min_region_area / cfg.cell_size ** 2))
        rid = 0
        sizes = []
        for sx in range(nx):
            for sz in range(nz):
                if not walk[sx, sz] or region[sx, sz] >= 0:
                    continue
                stack = [(sx, sz)]
                region[sx, sz] = rid
                count = 0
                while stack:
                    x, z = stack.pop()
                    count += 1
                    fy = floor[x, z]
                    for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        x2, z2 = x + dx, z + dz
                        if (0 <= x2 < nx and 0 <= z2 < nz and walk[x2, z2]
                                and region[x2, z2] < 0
                                and abs(floor[x2, z2] - fy) <= climb):
                            region[x2, z2] = rid
                            stack.append((x2, z2))
                sizes.append(count)
                rid += 1
        # cull tiny regions
        keep = np.array([s >= min_cells for s in sizes], bool)
        remap = np.full(rid, -1, np.int32)
        remap[keep] = np.arange(int(keep.sum()), dtype=np.int32)
        mask = region >= 0
        region[mask] = remap[region[mask]]
        return region, int(keep.sum())
