"""Command-line front end of the port — the counterpart of
``water_sandbox_tpu/cli.py``, with the same seven subcommands:

    python -m water_sandbox_tpu_torch.cli scenes
    python -m water_sandbox_tpu_torch.cli run --scene dam-break-2d-4k \
        --steps 500 --export traj.npz --checkpoint end.npz --preview
    python -m water_sandbox_tpu_torch.cli resume --checkpoint end.npz \
        --steps 100
    python -m water_sandbox_tpu_torch.cli bench --scene sort-stress-64k \
        --steps 30

Everything runs on the card (``cuda:0``) and fails where no CUDA device is
present; with the environment variable ``WST_FORCE_CPU`` set, everything
runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _cmd_scenes(args):
    from .models import scenes
    for name in scenes.names():
        print(f"{name:26s} {scenes.get(name).description}")


def _make_sim(args):
    from .runtime.runner import Simulation
    overrides = {}
    if args.neighbor_mode:
        overrides["neighbor_mode"] = args.neighbor_mode
    return Simulation.from_scene(args.scene, device=args.device, **overrides)


def _cmd_run(args):
    from .io.export import TrajectoryWriter
    from .runtime import checkpoint
    from .viz import raster

    sim = _make_sim(args)
    writer = None
    if args.export:
        writer = TrajectoryWriter(args.export, {"scene": args.scene})
        writer.add_frame(sim.positions(), 0.0)

    done = 0
    while done < args.steps:
        chunk = min(args.record_every, args.steps - done)
        sim.run(chunk)
        done += chunk
        if writer:
            writer.add_frame(sim.positions(), float(sim.state.time))
        if args.preview:
            img = raster.density_image(sim.state, sim.params, 96, 28)
            print(f"\n--- step {int(sim.state.step_count)} ---")
            print(raster.ascii_preview(img))
    print(json.dumps(sim.stats(), default=float))

    if writer:
        print(f"trajectory -> {writer.write()}")
    if args.checkpoint:
        checkpoint.save(args.checkpoint, sim.state, sim.params, sim.cfg)
        print(f"checkpoint -> {args.checkpoint}")


def _cmd_resume(args):
    from .runtime import checkpoint
    from .runtime.runner import Simulation

    state, params, cfg = checkpoint.load(args.checkpoint, device=args.device)
    sim = Simulation(cfg, params, state, name="resumed")
    sim.run(args.steps)
    print(json.dumps(sim.stats(), default=float))
    if args.out:
        checkpoint.save(args.out, sim.state, sim.params, sim.cfg)
        print(f"checkpoint -> {args.out}")


def _cmd_bench(args):
    # Simulation.run ends in torch.cuda.synchronize on the card
    sim = _make_sim(args)
    sim.run(1)
    t0 = time.perf_counter()
    sim.run(args.steps)
    wall = time.perf_counter() - t0
    rate = args.steps * sim.cfg.n / wall
    print(json.dumps({
        "scene": args.scene, "n": sim.cfg.n, "steps": args.steps,
        "wall_s": round(wall, 3), "particle_steps_per_s": rate,
        "ms_per_step": 1000 * wall / args.steps,
    }))


def _cmd_live(args):
    from .viz import live

    sim = _make_sim(args)
    live.run_live(sim, width=args.width, height=args.height,
                  steps_per_frame=args.steps_per_frame,
                  max_frames=args.max_frames, color=not args.no_color)
    print(json.dumps(sim.stats(), default=float))


def _cmd_serve(args):
    from .viz.server import ViewerServer

    sim = _make_sim(args)
    server = ViewerServer(sim, host=args.host, port=args.port,
                          steps_per_frame=args.steps_per_frame,
                          render=args.render)
    server.serve(max_seconds=args.max_seconds)
    print(json.dumps(sim.stats(), default=float))


def _cmd_render(args):
    from .io.export import load_trajectory
    from .models import scenes
    from .viz import render

    _, _, meta = load_trajectory(args.trajectory)
    scene = meta.get("scene", args.scene)
    _, params, _ = scenes.build(scene, device=args.device)
    out = render.render_trajectory_gif(args.trajectory, args.out, params,
                                       fps=args.fps)
    print(f"gif -> {out}")


def main(argv=None):
    from .core import device as device_mod

    p = argparse.ArgumentParser(prog="water-sandbox-tpu-torch",
                                description=__doc__)
    p.set_defaults(device="cpu" if os.environ.get("WST_FORCE_CPU")
                   else device_mod.DEFAULT)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("scenes", help="list registered scenes")

    run = sub.add_parser("run", help="run a scene")
    run.add_argument("--scene", default="dam-break-2d-4k")
    run.add_argument("--steps", type=int, default=100)
    run.add_argument("--record-every", type=int, default=50)
    run.add_argument("--neighbor-mode", default=None)
    run.add_argument("--export", default=None, help="trajectory .npz path")
    run.add_argument("--checkpoint", default=None, help="final-state .npz")
    run.add_argument("--preview", action="store_true",
                     help="ASCII density heat map during the run")

    res = sub.add_parser("resume", help="resume from a checkpoint")
    res.add_argument("--checkpoint", required=True)
    res.add_argument("--steps", type=int, default=100)
    res.add_argument("--out", default=None)

    ben = sub.add_parser("bench", help="measure step throughput")
    ben.add_argument("--scene", default="sort-stress-64k")
    ben.add_argument("--steps", type=int, default=20)
    ben.add_argument("--neighbor-mode", default=None)

    liv = sub.add_parser(
        "live", help="interactive terminal session: watch the fluid, tune "
        "params with the reference HUD keymap (hud.rs:130-165)")
    liv.add_argument("--scene", default="dam-break-2d-4k")
    liv.add_argument("--neighbor-mode", default=None)
    liv.add_argument("--width", type=int, default=96)
    liv.add_argument("--height", type=int, default=28)
    liv.add_argument("--steps-per-frame", type=int, default=4)
    liv.add_argument("--max-frames", type=int, default=None)
    liv.add_argument("--no-color", action="store_true")

    srv = sub.add_parser(
        "serve", help="browser viewer: 3-D orbit point cloud, velocity "
        "colors, live keyboard tuning")
    srv.add_argument("--scene", default="dam-break-2d-4k")
    srv.add_argument("--neighbor-mode", default=None)
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8787)
    srv.add_argument("--steps-per-frame", type=int, default=4)
    srv.add_argument("--max-seconds", type=float, default=None)
    srv.add_argument("--render", default="auto",
                     choices=("auto", "points", "raster"),
                     help="auto: raster density streaming for 100k+ scenes "
                     "(full fluid visible), point cloud otherwise")

    ren = sub.add_parser("render", help="render an exported trajectory to GIF")
    ren.add_argument("--trajectory", required=True)
    ren.add_argument("--out", default="out.gif")
    ren.add_argument("--scene", default="dam-break-2d-4k",
                     help="fallback scene for container bounds")
    ren.add_argument("--fps", type=int, default=20)

    args = p.parse_args(argv)
    {"scenes": _cmd_scenes, "run": _cmd_run, "resume": _cmd_resume,
     "bench": _cmd_bench, "render": _cmd_render, "live": _cmd_live,
     "serve": _cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    main()
