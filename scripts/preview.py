#!/usr/bin/env python
"""Local preview — the optional presentation fallback promised in SURVEY §2d.

The reference presents frames in a live SDL window with vsync
(``Source/SDLauxiliary.h:73-147``) and animates the light in its event loop
(``Source/skeleton.cpp:282-361``). On a headless GPU host there is no SDL;
this script renders the same light animation and either

* assembles an animated GIF (default, viewable anywhere), and/or
* plays the frames in a local Tk window (``--show``, needs a display).

Usage:
    python scripts/preview.py                       # preview.gif, 48 frames
    python scripts/preview.py --width 512 --frames 90 -o cornell.gif
    python scripts/preview.py --show                # live window (if DISPLAY)
    python scripts/preview.py --obj assets/ico.obj  # with a loaded OBJ mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def render_frames(args):
    """Render the light-oscillation sequence (skeleton.cpp:290-298)."""
    from uob_raytracer_tpu import RenderConfig, cornell_box
    from uob_raytracer_tpu.render import render
    from uob_raytracer_tpu.scene import add_triangles, animate_light, load_obj

    cfg = RenderConfig(width=args.width, height=args.width, aa_x=2, aa_y=2,
                       shadow_samples=args.samples, bounces=args.bounces)
    scene = cornell_box()
    if args.obj:
        scene = add_triangles(scene, *load_obj(args.obj))
    light_x, lor = float(np.asarray(scene.light_pos)[0]), True
    frames, t_total = [], 0.0
    for f in range(args.frames):
        light_x, lor = animate_light(light_x, lor)
        s = dataclasses.replace(
            scene, light_pos=scene.light_pos.at[0].set(light_x))
        t0 = time.time()
        out = render(s, cfg)
        img = np.asarray(out.image)  # device fetch = the SDL present
        if f > 0:
            t_total += time.time() - t0
        u8 = np.clip(255.0 * img, 0, 255).astype(np.uint8)
        frames.append(u8)
        print(f"\rframe {f + 1}/{args.frames}", end="", flush=True)
    if args.frames > 1:
        dt = t_total / (args.frames - 1)
        print(f"\nsteady-state {dt * 1e3:.2f} ms/frame = {1 / dt:.1f} FPS")
    return frames


def save_gif(frames, path: str, fps: float) -> bool:
    try:
        from PIL import Image
    except ImportError:
        print("Pillow not available — writing PPM frames instead "
              "(view with any image tool)", file=sys.stderr)
        base = os.path.splitext(path)[0]
        os.makedirs(base, exist_ok=True)
        from uob_raytracer_tpu.ops.image import save_ppm
        for i, f in enumerate(frames):
            save_ppm(os.path.join(base, f"frame_{i:04d}.ppm"),
                     f.astype(np.float32) / 255.0)
        print(f"wrote {len(frames)} frames to {base}/")
        return False
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 20), loop=0)
    print(f"wrote {path} ({len(frames)} frames)")
    return True


def show_window(frames, fps: float) -> None:
    """Best-effort live playback in a Tk window (the SDL-window analogue)."""
    try:
        import tkinter as tk

        from PIL import Image, ImageTk
    except ImportError as e:
        print(f"--show needs tkinter + Pillow ({e}); falling back to GIF "
              f"only", file=sys.stderr)
        return
    try:
        root = tk.Tk()
    except tk.TclError as e:
        print(f"--show: no display available ({e}); view the GIF instead",
              file=sys.stderr)
        return
    root.title("uob_raytracer_tpu preview (Esc to quit)")
    label = tk.Label(root)
    label.pack()
    photos = [ImageTk.PhotoImage(Image.fromarray(f)) for f in frames]
    state = {"i": 0}

    def tick():
        label.configure(image=photos[state["i"]])
        state["i"] = (state["i"] + 1) % len(photos)
        root.after(max(int(1000 / fps), 20), tick)

    root.bind("<Escape>", lambda e: root.destroy())
    tick()
    root.mainloop()


def interactive_window(args) -> None:
    """Live render-as-you-watch loop — the reference's SDL event loop
    (skeleton.cpp:282-361) on Tk: mouse motion and arrows drive yaw/pitch,
    i/o/k/j translate the camera (exact reference increments, see
    uob_raytracer_tpu.interactive), the light keeps oscillating, and every
    frame is a fresh render of the current state."""
    try:
        import tkinter as tk

        from PIL import Image, ImageTk
    except ImportError as e:
        print(f"--interactive needs tkinter + Pillow ({e})", file=sys.stderr)
        return
    import jax

    from uob_raytracer_tpu import RenderConfig, cornell_box
    from uob_raytracer_tpu.interactive import CameraController
    from uob_raytracer_tpu.render import render
    from uob_raytracer_tpu.scene import add_triangles, animate_light, load_obj

    cfg = RenderConfig(width=args.width, height=args.width, aa_x=2, aa_y=2,
                       shadow_samples=args.samples, bounces=args.bounces)
    scene = cornell_box()
    if args.obj:
        scene = add_triangles(scene, *load_obj(args.obj))
    ctl = CameraController(yaw=0.0, pitch=0.0,
                           cam_z=float(np.asarray(scene.camera_pos)[2]))
    light = {"x": float(np.asarray(scene.light_pos)[0]), "lor": True}

    try:
        root = tk.Tk()
    except tk.TclError as e:
        print(f"--interactive: no display available ({e})", file=sys.stderr)
        return
    root.title("uob_raytracer_tpu live (arrows/mouse rotate, iokj move, "
               "Esc quits)")
    label = tk.Label(root)
    label.pack()
    last = {"xy": None, "photo": None, "t": time.time(), "n": 0}

    def on_motion(e):
        # Tk reports absolute coords; SDL's xrel/yrel is the frame delta
        if last["xy"] is not None:
            ctl.mouse_motion(e.x - last["xy"][0], e.y - last["xy"][1])
        last["xy"] = (e.x, e.y)

    def on_key(e):
        ctl.key(e.keysym)
        if ctl.quit:
            root.destroy()

    root.bind("<B1-Motion>", on_motion)
    root.bind("<ButtonRelease-1>", lambda e: last.update(xy=None))
    root.bind("<KeyPress>", on_key)

    def tick():
        light["x"], light["lor"] = animate_light(light["x"], light["lor"])
        s = ctl.apply(scene)
        s = dataclasses.replace(
            s, light_pos=s.light_pos.at[0].set(light["x"]))
        img = np.asarray(render(s, cfg).image)
        u8 = np.clip(255.0 * img, 0, 255).astype(np.uint8)
        last["photo"] = ImageTk.PhotoImage(Image.fromarray(u8))
        label.configure(image=last["photo"])
        last["n"] += 1
        if last["n"] % 30 == 0:
            dt = (time.time() - last["t"]) / 30
            root.title(f"uob_raytracer_tpu live — {1 / dt:.1f} FPS "
                       f"(yaw {ctl.yaw:+.2f} pitch {ctl.pitch:+.2f})")
            last["t"] = time.time()
        root.after(1, tick)

    jax.block_until_ready(render(ctl.apply(scene), cfg).image)  # compile
    tick()
    root.mainloop()


def latency_bench(args) -> dict:
    """Measured interactive-loop latency: drive the CameraController
    headlessly through the exact per-frame path of ``interactive_window`` —
    key event -> controller update -> light animation -> render -> host
    fetch of the frame — and time each keypress-to-updated-frame round trip
    on the default backend.

    This is the reference's live loop (``skeleton.cpp:117-138``: update()
    then offload_rendering() then SDL_Renderframe per frame) minus the
    window present itself; the host fetch plays the SDL present's role
    exactly as the reference's blocking readback does."""
    import time as _time

    import jax

    from uob_raytracer_tpu import RenderConfig, cornell_box
    from uob_raytracer_tpu.cache import enable_compilation_cache
    from uob_raytracer_tpu.interactive import CameraController
    from uob_raytracer_tpu.render import render
    from uob_raytracer_tpu.scene import animate_light

    enable_compilation_cache()
    cfg = RenderConfig(width=args.width, height=args.width, aa_x=2, aa_y=2,
                       shadow_samples=args.samples, bounces=args.bounces)
    scene = cornell_box()
    ctl = CameraController(cam_z=float(np.asarray(scene.camera_pos)[2]))
    light = {"x": float(np.asarray(scene.light_pos)[0]), "lor": True}

    def frame():
        """One tick of the interactive loop (same steps as tick() above)."""
        light["x"], light["lor"] = animate_light(light["x"], light["lor"])
        s = ctl.apply(scene)
        s = dataclasses.replace(
            s, light_pos=s.light_pos.at[0].set(light["x"]))
        return np.asarray(render(s, cfg).image)   # fetch = the present

    frame()   # compile + warm
    dev = jax.devices()[0]
    keys = ["Left", "Right", "Up", "Down", "i", "o", "k", "j"] * 4
    lats = []
    for name in keys:
        t0 = _time.perf_counter()
        ctl.key(name)                 # the keypress
        img = frame()                 # re-render + fetch
        lats.append(_time.perf_counter() - t0)
    lats_ms = sorted(x * 1e3 for x in lats)
    n = len(lats_ms)
    out = {
        "width": cfg.width, "config": f"aa{cfg.aa_rays} "
        f"s{cfg.shadow_samples} b{cfg.bounces}",
        "n_events": n,
        "keypress_to_frame_ms": {
            "p50": round(lats_ms[n // 2], 2),
            "p95": round(lats_ms[int(n * 0.95)], 2),
            "min": round(lats_ms[0], 2)},
        "fps_at_p50": round(1e3 / lats_ms[n // 2], 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(f"latency {cfg.width}^2: p50 "
          f"{out['keypress_to_frame_ms']['p50']} ms "
          f"(p95 {out['keypress_to_frame_ms']['p95']}, "
          f"{out['fps_at_p50']} FPS); image checksum "
          f"{float(img.sum()):.3f}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--bounces", type=int, default=10)
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--obj", default=None)
    p.add_argument("--show", action="store_true",
                   help="play in a local window (needs a display)")
    p.add_argument("--interactive", action="store_true",
                   help="live window with mouse/keyboard camera control "
                        "(the reference's event loop; needs a display)")
    p.add_argument("--latency-bench", action="store_true",
                   help="headless keypress->frame latency measurement of "
                        "the interactive loop on the real backend")
    p.add_argument("-o", "--out", default="preview.gif")
    args = p.parse_args(argv)
    if args.latency_bench:
        import json
        print(json.dumps(latency_bench(args)))
        return
    if args.interactive:
        interactive_window(args)
        return
    frames = render_frames(args)
    save_gif(frames, args.out, args.fps)
    if args.show:
        show_window(frames, args.fps)


if __name__ == "__main__":
    main()
