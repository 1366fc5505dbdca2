"""NavMeshNavigator: pathfinding queries over a built NavMesh.

Reference (navmesh_navigator.h:44-89): FindPath / FindNearestPoly /
FindPointOnPoly / Raycast through dtNavMeshQuery. Here the same query surface
runs over the walkable heightfield: A* with an octile heuristic plus
line-of-sight string pulling (the funnel-algorithm analog for a grid navmesh).

A copy of lighthouse2_tpu/pathfinding/navigator.py (numpy only).
"""
from __future__ import annotations

import heapq

import numpy as np

from lighthouse2_tpu_torch.pathfinding.builder import NavMesh

_SQRT2 = 2.0 ** 0.5
# 8-connected moves (dx, dz, cost)
_MOVES = ((1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
          (1, 1, _SQRT2), (1, -1, _SQRT2), (-1, 1, _SQRT2), (-1, -1, _SQRT2))


class NoPathError(Exception):
    """Raised when no path exists (NavMeshNavigator returns NavMeshStatus
    failures through NavMeshError in the reference)."""


class NavMeshNavigator:
    def __init__(self, navmesh: NavMesh):
        self.navmesh = navmesh

    # -- queries (navmesh_navigator.h surface) ---------------------------
    def find_nearest_point(self, pos, max_radius: float = 5.0) -> np.ndarray:
        """Closest walkable point (FindNearestPoly + FindPointOnPoly
        analog)."""
        nm = self.navmesh
        p = np.asarray(pos, np.float64)
        ix, iz = nm.world_to_cell(p)
        cs = nm.config.cell_size
        r_cells = int(np.ceil(max_radius / cs))
        best, best_d = None, np.inf

        def consider(cx, cz):
            nonlocal best, best_d
            if nm.is_walkable(cx, cz):
                w = nm.cell_to_world(cx, cz)
                # 3D distance: a cell 1.2 up (a box top) must lose to a
                # ground cell one step away (dtNavMeshQuery::findNearestPoly
                # is 3D for the same reason)
                d = ((w[0] - p[0]) ** 2 + (w[2] - p[2]) ** 2
                     + (w[1] - p[1]) ** 2)
                if d < best_d:
                    best_d, best = d, (cx, cz)

        consider(ix, iz)
        for r in range(1, r_cells + 1):
            # once the best possible ring distance exceeds the best found,
            # no further ring can win
            if best is not None and ((r - 1) * cs) ** 2 > best_d:
                break
            for dx in range(-r, r + 1):
                for dz in range(-r, r + 1):
                    if max(abs(dx), abs(dz)) != r:
                        continue
                    consider(ix + dx, iz + dz)
        if best is not None:
            return nm.cell_to_world(*best)
        raise NoPathError(f"no walkable cell within {max_radius} of {pos}")

    def raycast(self, start, end) -> tuple:
        """Walkability raycast (dtNavMeshQuery::raycast analog): returns
        (hit: bool, hit_point). Steps the xz segment cell by cell; a hit is
        the first unwalkable cell or a climb-limit violation."""
        nm = self.navmesh
        cs = nm.config.cell_size
        climb = nm.config.agent_max_climb
        p0 = np.asarray(start, np.float64)
        p1 = np.asarray(end, np.float64)
        d = p1 - p0
        length = float(np.hypot(d[0], d[2]))
        n_steps = max(1, int(np.ceil(length / (cs * 0.5))))
        prev_y = None
        prev_w = p0
        for s in range(n_steps + 1):
            w = p0 + d * (s / n_steps)
            ix, iz = nm.world_to_cell(w)
            if not nm.is_walkable(ix, iz):
                return True, prev_w.astype(np.float32)
            y = float(nm.floor[ix, iz])
            if prev_y is not None and abs(y - prev_y) > climb:
                return True, prev_w.astype(np.float32)
            prev_y, prev_w = y, w
        return False, p1.astype(np.float32)

    def find_path(self, start, end, smooth: bool = True) -> np.ndarray:
        """A* path start->end; returns (K, 3) world waypoints including both
        endpoints (FindPath analog). Raises NoPathError when disconnected."""
        nm = self.navmesh
        s = self.find_nearest_point(start)
        e = self.find_nearest_point(end)
        si, sj = nm.world_to_cell(s)
        ei, ej = nm.world_to_cell(e)
        if (si, sj) == (ei, ej):
            return np.stack([s, e]).astype(np.float32)

        cells = self._astar((si, sj), (ei, ej))
        pts = [nm.cell_to_world(ix, iz) for ix, iz in cells]
        pts[0], pts[-1] = s, e
        path = np.stack(pts).astype(np.float32)
        if smooth:
            path = self._string_pull(path)
        return path

    # -- internals -------------------------------------------------------
    def _astar(self, start, goal):
        nm = self.navmesh
        floor = nm.floor
        walk = nm.walkable
        climb = nm.config.agent_max_climb
        nx, nz = walk.shape

        def h(c):
            dx, dz = abs(c[0] - goal[0]), abs(c[1] - goal[1])
            return (dx + dz) + (_SQRT2 - 2.0) * min(dx, dz)  # octile

        open_q = [(h(start), 0.0, start)]
        g = {start: 0.0}
        came = {}
        closed = set()
        while open_q:
            _, gc, cur = heapq.heappop(open_q)
            if cur == goal:
                path = [cur]
                while cur in came:
                    cur = came[cur]
                    path.append(cur)
                return path[::-1]
            if cur in closed:
                continue
            closed.add(cur)
            cy = floor[cur]
            for dx, dz, cost in _MOVES:
                nb = (cur[0] + dx, cur[1] + dz)
                if not (0 <= nb[0] < nx and 0 <= nb[1] < nz):
                    continue
                if not walk[nb] or abs(floor[nb] - cy) > climb:
                    continue
                if dx and dz:  # no diagonal corner cutting
                    if not (walk[cur[0] + dx, cur[1]]
                            and walk[cur[0], cur[1] + dz]):
                        continue
                ng = gc + cost
                if ng < g.get(nb, np.inf):
                    g[nb] = ng
                    came[nb] = cur
                    heapq.heappush(open_q, (ng + h(nb), ng, nb))
        raise NoPathError(f"no path from cell {start} to {goal}")

    def _string_pull(self, path: np.ndarray) -> np.ndarray:
        """Line-of-sight smoothing: greedily skip waypoints that the
        raycast can reach directly (funnel-algorithm analog)."""
        out = [path[0]]
        i = 0
        while i < len(path) - 1:
            j = len(path) - 1
            while j > i + 1:
                hit, _ = self.raycast(path[i], path[j])
                if not hit:
                    break
                j -= 1
            out.append(path[j])
            i = j
        return np.stack(out)
