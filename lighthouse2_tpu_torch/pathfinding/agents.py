"""Crowd agents with steering over a navmesh.

Reference (navmesh_agents.h:30-99): `Agent` wraps a dtCrowd agent with
target/path state; `NavMeshAgents::UpdateAgentMovement` ticks the crowd.
Here agent kinematics update as one vectorized numpy pass over all agents
(positions/velocities as (N,3) arrays) — the array-first analog of dtCrowd —
while per-agent path state (waypoint lists) stays host-side.

A copy of lighthouse2_tpu/pathfinding/agents.py (numpy only).
"""
from __future__ import annotations

import numpy as np

from lighthouse2_tpu_torch.pathfinding.navigator import NavMeshNavigator, NoPathError


class Agent:
    """One navigating agent (navmesh_agents.h:30-64 analog)."""

    def __init__(self, agents: "NavMeshAgents", idx: int):
        self._agents = agents
        self.idx = idx
        self.path: np.ndarray | None = None
        self.waypoint = 0
        self.alive = True

    # -- state views -----------------------------------------------------
    @property
    def position(self) -> np.ndarray:
        return self._agents.positions[self.idx]

    @property
    def velocity(self) -> np.ndarray:
        return self._agents.velocities[self.idx]

    @property
    def target(self) -> "np.ndarray | None":
        return (None if self.path is None or self.waypoint >= len(self.path)
                else self.path[self.waypoint])

    def set_target(self, target) -> bool:
        """Plan a path to `target` (Agent::SetTarget analog). Returns False
        when no path exists."""
        try:
            self.path = self._agents.navigator.find_path(self.position, target)
        except NoPathError:
            self.path = None
            return False
        self.waypoint = 1 if len(self.path) > 1 else 0
        return True

    def stop(self):
        self.path = None
        self._agents.velocities[self.idx] = 0.0

    @property
    def arrived(self) -> bool:
        return self.path is None


class NavMeshAgents:
    """Vectorized crowd (NavMeshAgents analog, navmesh_agents.h:71-99)."""

    def __init__(self, navigator: NavMeshNavigator, max_agents: int = 64,
                 max_speed: float = 3.5, max_accel: float = 8.0,
                 arrive_radius: float = 0.25, separation_radius: float = 0.8):
        self.navigator = navigator
        self.max_agents = max_agents
        self.max_speed = max_speed
        self.max_accel = max_accel
        self.arrive_radius = arrive_radius
        self.separation_radius = separation_radius
        self.positions = np.zeros((max_agents, 3), np.float32)
        self.velocities = np.zeros((max_agents, 3), np.float32)
        self.active = np.zeros(max_agents, bool)
        self.agents: list[Agent | None] = [None] * max_agents

    def add_agent(self, position) -> Agent:
        """AddAgent analog (navmesh_agents.h:77)."""
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            raise RuntimeError("agent pool full")
        idx = int(free[0])
        self.positions[idx] = self.navigator.find_nearest_point(position)
        self.velocities[idx] = 0.0
        self.active[idx] = True
        agent = Agent(self, idx)
        self.agents[idx] = agent
        return agent

    def remove_agent(self, agent: Agent):
        self.active[agent.idx] = False
        self.agents[agent.idx] = None
        agent.alive = False

    def update(self, dt: float):
        """One simulation tick (UpdateAgentMovement analog): advance
        waypoints per agent, then integrate steering for all agents in one
        vectorized pass (seek + arrive + neighbor separation)."""
        nm = self.navigator.navmesh
        idxs = np.flatnonzero(self.active)
        if len(idxs) == 0:
            return
        targets = np.zeros((len(idxs), 3), np.float32)
        has_target = np.zeros(len(idxs), bool)
        for k, i in enumerate(idxs):
            ag = self.agents[i]
            # waypoint advance
            while ag.path is not None:
                wp = ag.path[ag.waypoint]
                d = wp - self.positions[i]
                if float(np.hypot(d[0], d[2])) > self.arrive_radius:
                    break
                ag.waypoint += 1
                if ag.waypoint >= len(ag.path):
                    ag.path = None
            if ag.path is not None:
                targets[k] = ag.path[ag.waypoint]
                has_target[k] = True

        pos = self.positions[idxs]
        vel = self.velocities[idxs]

        # seek/arrive: desired velocity toward the waypoint, slowing near
        # the final target
        to_t = targets - pos
        to_t[:, 1] = 0.0
        dist = np.linalg.norm(to_t, axis=1, keepdims=True)
        desired = np.where(dist > 1e-6, to_t / np.maximum(dist, 1e-6), 0.0)
        speed = np.minimum(self.max_speed, dist[:, 0] / max(dt, 1e-6))
        desired *= (speed * has_target)[:, None]

        # separation from nearby agents (dtCrowd obstacle-avoidance analog)
        diff = pos[:, None, :] - pos[None, :, :]
        diff[:, :, 1] = 0.0
        d2 = (diff ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        near = d2 < self.separation_radius ** 2
        push = np.where(near[:, :, None],
                        diff / np.maximum(np.sqrt(d2)[:, :, None], 1e-6), 0.0)
        desired += push.sum(1) * self.max_speed * 0.5

        # accel-limited integration
        dv = desired - vel
        dv_mag = np.linalg.norm(dv, axis=1, keepdims=True)
        dv = np.where(dv_mag > self.max_accel * dt,
                      dv / np.maximum(dv_mag, 1e-6) * self.max_accel * dt, dv)
        vel = vel + dv
        new_pos = pos + vel * dt

        # clamp to the navmesh: revert cells that step off walkable ground
        for k, i in enumerate(idxs):
            ix, iz = nm.world_to_cell(new_pos[k])
            if nm.is_walkable(ix, iz):
                new_pos[k, 1] = nm.floor[ix, iz]
            else:
                new_pos[k] = pos[k]
                vel[k] = 0.0
        self.positions[idxs] = new_pos
        self.velocities[idxs] = vel
