"""Pathfinding / navmesh module (reference: lib/PathFinding).

The reference wraps recastnavigation (NavMeshBuilder voxelizes the scene into
a heightfield, builds regions/contours/polymesh; NavMeshNavigator runs Detour
queries; NavMeshAgents steers crowd agents; NavMeshShader visualizes through
RenderAPI — navmesh_builder.h:30-85, navmesh_navigator.h:44-89,
navmesh_agents.h:30-99, navmesh_shader.h:53-179).

This implementation is from scratch and array-first: voxelization and
walkability are vectorized numpy passes over the scene triangles, navigation
runs A* + line-of-sight string pulling over the walkable heightfield, and
agent steering is a vectorized update over all agents at once.

A copy of lighthouse2_tpu/pathfinding/ (numpy only): builder, navigator,
agents, shader (with the port's HostMesh) and io.
"""
from lighthouse2_tpu_torch.pathfinding.builder import (
    NavMeshConfig, NavMesh, NavMeshBuilder)
from lighthouse2_tpu_torch.pathfinding.navigator import NavMeshNavigator
from lighthouse2_tpu_torch.pathfinding.agents import Agent, NavMeshAgents
from lighthouse2_tpu_torch.pathfinding.shader import NavMeshShader
from lighthouse2_tpu_torch.pathfinding.io import save_navmesh, load_navmesh

__all__ = [
    "NavMeshConfig", "NavMesh", "NavMeshBuilder", "NavMeshNavigator",
    "Agent", "NavMeshAgents", "NavMeshShader", "save_navmesh",
    "load_navmesh",
]
