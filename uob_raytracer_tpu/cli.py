"""Command-line driver — the application layer replacing the reference's
SDL event loop (``Source/skeleton.cpp:93-144``). No window: frames go to
BMP/PPM files; the light animation reproduces the reference's oscillation
(``skeleton.cpp:290-298``) and camera parameters are flags instead of
mouse/keyboard events.

Usage:
    python -m uob_raytracer_tpu.cli render   [--config full_1024] [-o out.bmp]
    python -m uob_raytracer_tpu.cli animate  [--frames 60] [-o frames/]
    python -m uob_raytracer_tpu.cli fit      [--steps 50]
    python -m uob_raytracer_tpu.cli configs
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def _build(args):
    import jax.numpy as jnp
    from . import RenderConfig, ShadingModel, baseline_configs, cornell_box

    configs = baseline_configs()
    if args.config in configs:
        cfg = configs[args.config]
    else:
        cfg = RenderConfig()
    if args.width:
        cfg = dataclasses.replace(cfg, width=args.width,
                                  height=args.height or args.width)
    scene = cornell_box(
        spheres=not cfg.cpu_ref,
        shading=cfg.shading if cfg.cpu_ref else ShadingModel.DEVICE)
    if args.obj:
        from . import add_triangles, load_obj
        scene = add_triangles(scene, *load_obj(args.obj))
    if args.yaw or args.pitch:
        scene = dataclasses.replace(scene, yaw=jnp.float32(args.yaw),
                                    pitch=jnp.float32(args.pitch))
    return scene, cfg


def cmd_render(args):
    from .ops.image import save_bmp, save_ppm
    from .render import render

    scene, cfg = _build(args)
    t0 = time.time()
    out = render(scene, cfg, backend=args.backend)
    out.image.block_until_ready()
    dt = time.time() - t0
    # reference prints per-frame time + FPS (skeleton.cpp:131-132)
    print(f"Rendertime: {dt*1e6:.0f} microseconds (includes compile)")
    t0 = time.time()
    out = render(scene, cfg, backend=args.backend)
    out.image.block_until_ready()
    dt = time.time() - t0
    print(f"Rendertime: {dt*1e6:.0f} microseconds")
    print(f"Frame Rate: {1.0/dt:.1f} FPS")
    path = args.out or "screenshot.bmp"
    if path.endswith(".ppm"):
        save_ppm(path, np.asarray(out.image))
    else:
        save_bmp(path, np.asarray(out.packed))
    print(f"saved {path}")


def cmd_animate(args):
    import jax.numpy as jnp
    from .ops.image import save_bmp
    from .render import render
    from .scene import animate_light

    scene, cfg = _build(args)
    outdir = args.out or "frames"
    os.makedirs(outdir, exist_ok=True)
    light_x, lor = float(np.asarray(scene.light_pos)[0]), True
    t_total = 0.0
    for f in range(args.frames):
        light_x, lor = animate_light(light_x, lor)
        s = dataclasses.replace(
            scene, light_pos=scene.light_pos.at[0].set(light_x))
        t0 = time.time()
        out = render(s, cfg, backend=args.backend)
        out.packed.block_until_ready()
        if f > 0:
            t_total += time.time() - t0
        save_bmp(os.path.join(outdir, f"frame_{f:04d}.bmp"),
                 np.asarray(out.packed))
    if args.frames > 1:
        dt = t_total / (args.frames - 1)
        print(f"{args.frames} frames; steady-state {dt*1e3:.2f} ms/frame "
              f"= {1.0/dt:.1f} FPS")


def cmd_fit(args):
    """Differentiable-rendering demo (the capability the reference never
    had): recover light position, a wall color, AND a vertex block from a
    target image with per-leaf Adam — the BASELINE config-5 parameter set —
    through the sharded renderer."""
    import jax.numpy as jnp
    from .parallel import fit, make_mesh, render_image_sharded

    scene, cfg = _build(args)
    cfg = dataclasses.replace(cfg, width=min(cfg.width, 256),
                              height=min(cfg.height, 256))
    mesh = make_mesh(tp=1)
    backend = args.backend
    # --lr scales every per-leaf Adam rate (1.0 = the tuned defaults).
    s_lr = args.lr

    # Round 1: light position + left-wall color, jointly.
    t1 = dataclasses.replace(
        scene,
        light_pos=jnp.array([0.25, -0.5, -0.7]),
        tri_rgb=scene.tri_rgb.at[2:4].set(jnp.float32([0.9, 0.5, 0.2])))
    target1 = render_image_sharded(t1, cfg, mesh, backend=backend)
    s1, l1 = fit(scene, target1, cfg, mesh, steps=args.steps,
                 lrs={"light_pos": 2e-2 * s_lr, "tri_rgb": 2e-2 * s_lr},
                 backend=backend, log_every=max(args.steps // 5, 1))
    print(f"[light+color] loss {l1[0]:.6f} -> {l1[-1]:.6f}")
    print(f"  light fitted {np.asarray(s1.light_pos).round(4)} "
          f"(target {np.asarray(t1.light_pos).round(4)})")
    print(f"  left wall rgb fitted {np.asarray(s1.tri_rgb[2]).round(3)} "
          f"(target {np.asarray(t1.tri_rgb[2]).round(3)})")

    # Round 2: vertex recovery — back wall pushed along z (shading-coupled,
    # so the interior gradient identifies it; pure silhouette slides are
    # invisible under frozen-visibility gradients — SURVEY.md §7).
    dv = jnp.zeros_like(scene.tri_v0).at[8:10].add(
        jnp.float32([0.0, 0.0, 0.15]))
    t2 = dataclasses.replace(scene, tri_v0=scene.tri_v0 + dv,
                             tri_v1=scene.tri_v1 + dv,
                             tri_v2=scene.tri_v2 + dv)
    target2 = render_image_sharded(t2, cfg, mesh, backend=backend)
    s2, l2 = fit(scene, target2, cfg, mesh, steps=args.steps,
                 lrs={"tri_v0": 5e-3 * s_lr, "tri_v1": 5e-3 * s_lr,
                      "tri_v2": 5e-3 * s_lr},
                 backend=backend, log_every=max(args.steps // 5, 1))
    dz = float((s2.tri_v0[8:10, 2] - scene.tri_v0[8:10, 2]).mean())
    print(f"[vertices]    loss {l2[0]:.6f} -> {l2[-1]:.6f}")
    print(f"  back wall z-shift fitted {dz:+.4f} (target +0.15)")


def cmd_sweep(args):
    """Parameter-sweep driver: render a grid of light x positions (the axis
    the reference's update loop animates) and report per-frame stats."""
    import jax.numpy as jnp
    from .ops.image import save_bmp
    from .render import render

    scene, cfg = _build(args)
    outdir = args.out or "sweep"
    os.makedirs(outdir, exist_ok=True)
    xs = np.linspace(-0.5, 0.5, args.frames, dtype=np.float32)
    for i, x in enumerate(xs):
        s = dataclasses.replace(scene,
                                light_pos=scene.light_pos.at[0].set(float(x)))
        out = render(s, cfg, backend=args.backend)
        img = np.asarray(out.image)
        save_bmp(os.path.join(outdir, f"light_{i:03d}.bmp"),
                 np.asarray(out.packed))
        print(f"light_x={x:+.3f} mean={img.mean():.4f} max={img.max():.4f}")


def cmd_configs(_args):
    from . import baseline_configs
    for name, cfg in baseline_configs().items():
        print(f"{name}: {cfg}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="uob_raytracer_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("render", cmd_render), ("animate", cmd_animate),
                     ("fit", cmd_fit), ("sweep", cmd_sweep),
                     ("configs", cmd_configs)]:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--config", default="full_1024")
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--backend", default="auto",
                        help="pallas | jnp; auto picks pallas "
                             "on a GPU and jnp on the CPU")
        sp.add_argument("--obj", default=None)
        sp.add_argument("--yaw", type=float, default=0.0)
        sp.add_argument("--pitch", type=float, default=0.0)
        sp.add_argument("--devices", default=None, metavar="IDX[,IDX...]",
                        help="device indices to use (default: all; also "
                             "settable via RAYTPU_DEVICES — the OCL_DEVICE "
                             "analogue, skeleton.cpp:549-558)")
        sp.add_argument("-o", "--out", default=None)
        if name in ("animate", "sweep"):
            sp.add_argument("--frames", type=int, default=60)
        if name == "fit":
            sp.add_argument("--steps", type=int, default=30)
            sp.add_argument("--lr", type=float, default=1.0,
                            help="scale factor on the per-leaf Adam rates")
    args = p.parse_args(argv)
    if args.devices is not None:
        # stash in the env so every make_mesh() call in the command path
        # (and any worker subprocess) sees the same selection
        import os
        os.environ["RAYTPU_DEVICES"] = args.devices
    args.fn(args)


if __name__ == "__main__":
    from .cache import enable_compilation_cache
    enable_compilation_cache()
    main()
