"""Navmesh build/debug CLI: the ai_debugger app analog, headless.

The reference's ai_debugger (apps/ai_debugger/main.cpp:29-144) builds a
navmesh from the HostScene, places/steers agents, draws the navmesh +
paths through RenderAPI (NavMeshShader), and uses the pixel probe for 3-D
mouse picking. This CLI does the same end-to-end, scriptably:

    python -m lighthouse2_tpu_torch.apps.ai_debugger_cli cornell \\
        --start -0.8 0 -0.8 --goal 0.8 0 0.8 --steps 20 -o navdebug.png

  1. builds the heightfield navmesh from the scene (NavMeshBuilder);
  2. finds + string-pulls a path start->goal (NavMeshNavigator);
  3. steers an agent along it (NavMeshAgents) for --steps ticks;
  4. overlays navmesh tiles / path ribbon / agent marker into the scene
     (NavMeshShader) and renders the annotated frame;
  5. optionally serializes the navmesh (--save-navmesh, navmesh_io.h
     analog).

Counterpart of lighthouse2_tpu/apps/ai_debugger_cli.py, with its flags plus
`--device` (default: the card, raising without one; "cpu" renders through
the plain versions on the host). It renders through the port's RenderAPI
and builds with the port's copy of the pathfinding modules. Difference: an
OBJ scene is placed in the scene (add_instance), where the JAX CLI adds its
mesh but no instance of it.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="navmesh debugger (headless)")
    ap.add_argument("scene", help="'cornell' or an .obj/.gltf path")
    ap.add_argument("--start", type=float, nargs=3, default=[-0.7, 0.0, -0.7])
    ap.add_argument("--goal", type=float, nargs=3, default=[0.75, 0.0, 0.75])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--cell", type=float, default=0.1)
    ap.add_argument("--agent-height", type=float, default=1.0)
    ap.add_argument("--agent-radius", type=float, default=0.2)
    ap.add_argument("--agent-climb", type=float, default=0.35)
    ap.add_argument("-o", "--output", default="navdebug.png")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--save-navmesh", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.pathfinding.builder import (
        NavMeshBuilder, NavMeshConfig)
    from lighthouse2_tpu_torch.pathfinding.navigator import NavMeshNavigator
    from lighthouse2_tpu_torch.pathfinding.agents import NavMeshAgents
    from lighthouse2_tpu_torch.pathfinding.shader import NavMeshShader
    from lighthouse2_tpu_torch.utils.image import write_png

    cfg = RenderConfig(width=args.size, height=args.size,
                       spp_per_pass=args.spp, max_path_length=5)
    api = RenderAPI.create("wavefront", cfg, device=args.device)
    if args.scene == "cornell":
        from lighthouse2_tpu_torch.scene.presets import cornell_box
        api.scene, api.camera = cornell_box(args.size, args.size)
    elif args.scene.lower().endswith((".gltf", ".glb")):
        api.scene.load_gltf(args.scene)
    else:
        api.scene.add_instance(api.scene.load_obj(args.scene))

    # 1. build (NavMeshBuilder, navmesh_builder.h:30-85 analog)
    nm = NavMeshBuilder(NavMeshConfig(
        cell_size=args.cell, agent_height=args.agent_height,
        agent_radius=args.agent_radius,
        agent_max_climb=args.agent_climb)).build_from_scene(api.scene)
    n_walk = int(nm.walkable.sum())
    print(f"navmesh: {nm.nx}x{nm.nz} cells, {n_walk} walkable, "
          f"{int(nm.region.max()) + 1} regions")
    if args.save_navmesh:
        from lighthouse2_tpu_torch.pathfinding.io import save_navmesh
        save_navmesh(args.save_navmesh, nm)
        print("saved navmesh:", args.save_navmesh)

    # 2. path (NavMeshNavigator)
    nav = NavMeshNavigator(nm)
    path = nav.find_path(args.start, args.goal)
    print(f"path: {len(path)} waypoints, length "
          f"{np.linalg.norm(np.diff(path, axis=0), axis=1).sum():.3f}")

    # 3. steer an agent along it (NavMeshAgents)
    agents = NavMeshAgents(nav)
    ag = agents.add_agent(args.start)
    ag.set_target(args.goal)
    for _ in range(args.steps):
        agents.update(args.dt)
    print(f"agent at {np.round(ag.position, 3)} after {args.steps} ticks, "
          f"arrived={ag.arrived}")

    # 4. overlay + render (NavMeshShader via RenderAPI)
    shader = NavMeshShader(api.scene)
    shader.add_navmesh(nm)
    shader.add_path(path)
    shader.add_agent(ag.position)
    api.render(converge=False)
    write_png(args.output, api.get_ldr_image())
    print("wrote", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
