#!/usr/bin/env python
"""Visualize a robot model / trajectory / measurements file.

CLI counterpart of the reference's visualizer.py (pyglet/OpenGL viewer)
rendering with matplotlib 3D instead: a static pose snapshot (PNG) or a
trajectory playback (self-contained animated HTML with a scrubber).
Collision-model capsules and world boxes are drawn, with violating
pairs highlighted.
"""

from __future__ import annotations

import numpy as np

from flobaroid_tpu.utils.cli import base_parser, load_cli_config, setup_jax


def main():
    # visualization has no accelerator content: pin to the host backend
    # (per-frame FK dispatches, and no card memory reserved)
    setup_jax(prefer_cpu=True)
    p = base_parser("Visualize robot model and trajectories")
    p.add_argument("--trajectory", help="trajectory/measurements npz to play back")
    p.add_argument("--world", help="world URDF with obstacles")
    p.add_argument("--out", default=None, help="output file (png or html)")
    p.add_argument("--pose", default=None,
                   help="comma-separated joint angles for a static snapshot")
    p.add_argument("--step", type=int, default=10, help="animation frame step")
    p.add_argument("--webgl", action="store_true",
                   help="interactive 3D WebGL viewer (orbit camera, "
                        "playback, collision highlighting) instead of "
                        "the PNG-frame scrubber")
    p.add_argument("--no_meshes", action="store_true",
                   help="skip visual STL meshes (wireframe capsules only)")
    p.add_argument("--margin", type=float, default=0.0,
                   help="extra clearance margin for collision highlighting")
    args = p.parse_args()
    config = load_cli_config(args)

    from flobaroid_tpu.collision import CollisionModel
    from flobaroid_tpu.dynamics.engine import DynamicsEngine
    from flobaroid_tpu.models.urdf import load_urdf
    from flobaroid_tpu.visualizer import Visualizer

    tree = load_urdf(config["urdf"])
    eng = DynamicsEngine(tree)
    world = load_urdf(args.world) if args.world else None
    cm = CollisionModel(tree, eng, config, world_tree=world)
    lims = tree.joint_limits()
    tau_limits = np.array([lims[j]["torque"] for j in tree.dof_names])
    viz = Visualizer(
        tree, eng, collision_model=cm,
        urdf_path=config["urdf"],
        mesh_base_dir=str(config.get("meshBaseDir", "meshes")),
        draw_meshes=not args.no_meshes,
        tau_limits=tau_limits, collision_margin=args.margin,
    )

    if args.trajectory:
        with np.load(args.trajectory, allow_pickle=True, encoding="latin1") as f:
            Q = f["positions"]
            base_rpy = f["base_rpy"] if "base_rpy" in f.files else None
            base_pos = f["base_position"] if "base_position" in f.files else None
            torques = f["torques"] if "torques" in f.files else None
        if args.webgl:
            from flobaroid_tpu.webgl_viewer import export_webgl

            out = args.out or "trajectory_3d.html"
            export_webgl(viz, Q, out, base_rpy=base_rpy, base_pos=base_pos,
                         step=args.step, torques=torques)
        else:
            out = args.out or "trajectory.html"
            viz.animate(Q, out, base_rpy=base_rpy, base_pos=base_pos,
                        step=args.step, torques=torques)
        print(f"wrote {out} ({len(Q)} samples)")
    else:
        q = (
            np.array([float(v) for v in args.pose.split(",")])
            if args.pose
            else np.zeros(tree.num_dofs)
        )
        out = args.out or "robot.png"
        viz.snapshot(q, out)
        ok, viols = cm.check(q)
        print(f"wrote {out}; collisions at this pose: {len(viols)}")


if __name__ == "__main__":
    main()
