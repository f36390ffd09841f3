#!/usr/bin/env python
"""On-card smoke check of the renderer's main path on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --timing   # ... plus the kernel-decision timings
    python chip_smoke.py --four     # four GPUs: the dp=4 and tp=4 checks only

Phases (one process drives the card; nothing falls back to the CPU):

1. device: JAX's platform must be ``gpu``; prints the card's name and power
   limit as nvidia-smi reports them.
2. kernel: the compiled Triton forward against the NumPy oracle at 256^2
   (full_1024's settings otherwise), and against the plain XLA forward,
   images and decision residuals: on the card at full_1024, and at
   streamed_8192 both on the card and on the host CPU.
3. gradients: the path-replay gradients of all 15 Scene leaves against jnp
   autodiff on the host CPU; every leaf finite at the headline config and
   at full_1024.
4. main path: ``cli render --config full_1024`` and ``parallel.fit`` for 3
   Adam steps at 256^2, the loss falling.
5. compile and memory: compile times and ``memory_analysis()`` of the
   fwd+bwd step at full_1024.
6. the ``gpu``-marked tests, in this process.

Image tolerance (``reference.parity.assert_images_match``): at most 0.5 %
of pixels over 3e-4 and none over 0.45. Residuals: at most 0.5 % of
entries differ. Both allow rare boundary flips: a marginal hit or shadow
test that an ulp decides. The kernel divides and takes square roots with
IEEE rounding, as NumPy does; XLA's GPU code does not (its forward is
0.7 % of pixels off the oracle at 256^2 and 1.4 % off its own host-CPU
run at streamed_8192 on an H100, PERF.md). So the on-card XLA comparison
at streamed_8192, the one cell where those flips exceed 0.5 %, is held to
2 % with the same 0.45 single-flip bound, and the same cell is also held
to 0.5 % against XLA on the host CPU. Gradients: 1e-2 relative to each
leaf's largest magnitude, the tolerance for two separately compiled
programs. A failing phase makes the script exit 1 and print no result; the
last line of a passing run is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np


def _host_cpu():
    """The host CPU device, whose XLA divides and takes square roots with
    IEEE rounding like the kernel."""
    import jax
    return jax.devices("cpu")[0]


def _device_check(count: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    if len(devs) < count:
        print(f"needs {count} GPUs, JAX sees {len(devs)}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"# device: {devs[0].device_kind} x{len(devs)}", flush=True)
    print(f"# nvidia-smi: {smi}", flush=True)
    return devs, smi


def _timed(what: str, fn, *args):
    """Call fn once (compile + run), print the wall time, return the result."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    print(f"# compile+run {what}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def _residuals_match(res_a, res_b, what: str, limit: float = 0.005):
    shares = {}
    for f in res_a._fields:
        a, b = np.asarray(getattr(res_a, f)), np.asarray(getattr(res_b, f))
        assert a.shape == b.shape, f"{what} {f}: {a.shape} vs {b.shape}"
        shares[f] = float((a != b).mean()) if a.size else 0.0
        print(f"# {what} residual {f}: {shares[f]:.5f} differ "
              f"(limit {limit})", flush=True)
    bad = {f: s for f, s in shares.items() if s > limit}
    assert not bad, f"{what}: residual shares over {limit}: {bad}"


def _rel_errs(g, ref):
    """Per leaf: max |g - ref| relative to the leaf's largest |ref|."""
    return {f.name: float(np.abs(np.asarray(getattr(g, f.name))
                                 - np.asarray(getattr(ref, f.name))).max()
                          / (np.abs(np.asarray(getattr(ref, f.name))).max()
                             + 1e-12))
            for f in dataclasses.fields(ref)}


def _worst_rel(g, ref) -> float:
    return max(_rel_errs(g, ref).values())


def _grads_match(g, ref, what: str, rel: float = 1e-2):
    _all_finite(g, what)
    bad = {k: e for k, e in _rel_errs(g, ref).items() if not e <= rel}
    assert not bad, f"{what}: rel err over {rel}: {bad}"
    print(f"# {what}: 15 leaves, worst rel err {_worst_rel(g, ref):.3e} "
          f"(limit {rel})", flush=True)


def _all_finite(g, what: str):
    import jax
    bad = [i for i, x in enumerate(jax.tree_util.tree_leaves(g))
           if not np.isfinite(np.asarray(x)).all()]
    assert not bad, f"{what}: non-finite gradient leaves {bad}"
    print(f"# {what}: all 15 gradient leaves finite", flush=True)


def _grad_fn(cfg, backend):
    import jax
    import jax.numpy as jnp
    from uob_raytracer_tpu.render import render_image
    return jax.jit(jax.grad(
        lambda s: jnp.mean(render_image(s, cfg, backend=backend))))


def phase_kernel():
    import jax
    import uob_raytracer_tpu as rt
    from bench import STREAMED_BENCH_TRIS, dense_scene, streamed_bench_cfg
    from uob_raytracer_tpu.kernels.render_fwd import render_fused_res
    from uob_raytracer_tpu.ops.quads import detect_shadow_quads
    from uob_raytracer_tpu.reference.oracle import render_oracle
    from uob_raytracer_tpu.reference.parity import assert_images_match
    from uob_raytracer_tpu.render import render_flat_res

    full = rt.baseline_configs()["full_1024"]
    cfg = dataclasses.replace(full, width=256, height=256)
    img = rt.render(rt.cornell_box(), cfg).image
    ref = render_oracle(rt.cornell_box(as_numpy=True), cfg)
    frac, worst = assert_images_match(img, ref, what="triton vs oracle")
    print(f"# triton vs numpy oracle 256^2: {frac:.5f} of pixels over 3e-4 "
          f"(limit 0.005), worst {worst:.4f}", flush=True)

    streamed = f"streamed_{STREAMED_BENCH_TRIS}"
    big = dense_scene(STREAMED_BENCH_TRIS)
    cells = [("full_1024", full, rt.cornell_box(), [(None, 0.005)]),
             (streamed, streamed_bench_cfg(), big,
              [(None, 0.02), (_host_cpu(), 0.005)])]
    for name, cfg, scene, refs in cells:
        quads = detect_shadow_quads(scene)
        img_k, res_k = _timed(
            f"triton fwd {name}",
            jax.jit(lambda s: render_fused_res(s, cfg, quads=quads)), scene)
        for ref_device, limit in refs:
            where = "host cpu" if ref_device else "gpu"
            xla = jax.jit(lambda s: render_flat_res(s, cfg))
            img_x, res_x = _timed(f"xla fwd {name} on {where}", xla,
                                  jax.device_put(scene, ref_device))
            what = f"triton vs xla on {where} {name}"
            _residuals_match(res_k, res_x, what, limit)
            frac, worst = assert_images_match(img_k, img_x,
                                              outlier_frac=limit, what=what)
            print(f"# {what}: {frac:.5f} of pixels over 3e-4 (limit "
                  f"{limit}), worst {worst:.4f}", flush=True)
    mem = jax.jit(lambda s: render_flat_res(s, streamed_bench_cfg())).lower(
        big).compile().memory_analysis()
    print(f"# xla fwd {streamed} on gpu: temp "
          f"{mem.temp_size_in_bytes} B", flush=True)


def phase_gradients():
    """The replay backward on the card against jnp autodiff on the host,
    both differentiating the host jnp forward's decisions; then the main
    path (kernel forward, replay backward) at three sizes, every leaf
    finite. The kernel's own decisions differ from the host's on a few
    edge rays (phase_kernel holds their share to 0.5 %), and a flipped ray
    moves its whole gradient between triangles, so the main path's
    deviation from autodiff at 128^2 is printed, not held to 1e-2."""
    import jax
    import jax.numpy as jnp
    import uob_raytracer_tpu as rt
    from uob_raytracer_tpu.ops.replay import replay_forward
    from uob_raytracer_tpu.render import render_flat_res
    scene = rt.cornell_box()
    cfg = rt.RenderConfig(width=128, height=128, shadow_samples=10,
                          bounces=2)
    host = jax.device_put(scene, _host_cpu())
    _, res = jax.jit(lambda s: render_flat_res(s, cfg))(host)
    g_r = _timed("replay grad 128 on gpu", jax.jit(jax.grad(
        lambda s, r: jnp.mean(replay_forward(s, cfg, r)))), scene,
        jax.device_put(res, jax.devices()[0]))
    g_j = _timed("autodiff grad 128 on host cpu", _grad_fn(cfg, "jnp"),
                 host)
    _grads_match(g_r, g_j, "replay on gpu vs autodiff 128^2 aa4 s10 b2")
    headline = rt.RenderConfig(width=512, height=512, shadow_samples=10,
                               bounces=1)
    for name, c in [("128^2", cfg), ("headline", headline),
                    ("full_1024", rt.baseline_configs()["full_1024"])]:
        g = _timed(f"main-path grad {name}", _grad_fn(c, "pallas"), scene)
        _all_finite(g, f"main-path grad {name}")
        if c is cfg:
            print(f"# main-path grad 128^2 vs autodiff: worst rel err "
                  f"{_worst_rel(g, g_j):.3e}", flush=True)


def phase_main_path(out_dir: str):
    import uob_raytracer_tpu as rt
    from uob_raytracer_tpu.cli import main as cli_main
    from uob_raytracer_tpu.parallel import fit, make_mesh, render_image_sharded
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "smoke_full_1024.bmp")
    cli_main(["render", "--config", "full_1024", "-o", path])
    full = rt.baseline_configs()["full_1024"]
    assert os.path.getsize(path) == 54 + full.width * full.height * 4, path

    scene = rt.cornell_box()
    cfg = rt.RenderConfig(width=256, height=256, shadow_samples=10,
                          bounces=2)
    mesh = make_mesh(dp=1, tp=1)
    target_scene = dataclasses.replace(
        scene, light_pos=scene.light_pos.at[0].set(0.25))
    target = render_image_sharded(target_scene, cfg, mesh)
    _, losses = fit(scene, target, cfg, mesh, steps=3,
                    lrs={"light_pos": 2e-2})
    print(f"# fit 3 Adam steps 256^2: losses {losses}", flush=True)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def phase_compile_memory():
    import jax
    import uob_raytracer_tpu as rt
    scene = rt.cornell_box()
    cfg = rt.baseline_configs()["full_1024"]
    t0 = time.perf_counter()
    lowered = _grad_fn(cfg, "pallas").lower(scene)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    print(f"# fwd+bwd full_1024: trace+lower {t1 - t0:.1f} s, compile "
          f"{t2 - t1:.1f} s", flush=True)
    print(f"# fwd+bwd full_1024 memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)
    jax.block_until_ready(compiled(scene))
    stats = jax.devices()[0].memory_stats() or {}
    print(f"# peak_bytes_in_use: {stats.get('peak_bytes_in_use')}",
          flush=True)


def phase_gpu_tests():
    import pytest
    os.environ["RAYTPU_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(os.path.abspath(
                          __file__)), "tests")])
    assert rc == 0, f"gpu-marked tests: pytest exit code {rc}"


def _median_ms(fn, scene, reps: int = 7) -> float:
    import jax
    jax.block_until_ready(fn(scene))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(scene))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_timing(smi: str):
    """Forward ms/frame and fwd+bwd ms/step through the Triton forward and
    the plain XLA forward (both with the replay backward), median of
    block_until_ready windows, at the three kernel-decision sizes."""
    import jax
    import jax.numpy as jnp
    import uob_raytracer_tpu as rt
    from bench import STREAMED_BENCH_TRIS, dense_scene, streamed_bench_cfg
    from uob_raytracer_tpu.ops.quads import detect_shadow_quads
    from uob_raytracer_tpu.render import _render_replay

    cells = [("headline", rt.RenderConfig(width=512, height=512,
                                          shadow_samples=10, bounces=1),
              rt.cornell_box()),
             ("full_1024", rt.baseline_configs()["full_1024"],
              rt.cornell_box()),
             (f"streamed_{STREAMED_BENCH_TRIS}", streamed_bench_cfg(),
              dense_scene(STREAMED_BENCH_TRIS))]
    for name, cfg, scene in cells:
        for route in ("triton", "xla"):
            quads = detect_shadow_quads(scene) if route == "triton" else None

            def img(s):
                return _render_replay(s, cfg, jnp.int32(0), cfg.height,
                                      route, quads)
            fwd = jax.jit(img)
            step = jax.jit(jax.value_and_grad(lambda s: jnp.mean(img(s))))
            print(f"# timing [{smi}] {name} {route} forward: fwd "
                  f"{_median_ms(fwd, scene):.3f} ms/frame, fwd+bwd "
                  f"{_median_ms(step, scene):.3f} ms/step", flush=True)


def phase_four():
    """dp=4 full_1024 fwd+bwd through the kernel per row band vs one card;
    tp=4 streamed_8192 forward on the jnp path vs replicated on one card."""
    import jax
    import jax.numpy as jnp
    import uob_raytracer_tpu as rt
    from bench import STREAMED_BENCH_TRIS, dense_scene, streamed_bench_cfg
    from uob_raytracer_tpu.parallel import (image_loss, make_mesh,
                                            pad_triangles,
                                            render_image_sharded)
    from uob_raytracer_tpu.reference.parity import assert_images_match
    from uob_raytracer_tpu.render import render_image

    scene = rt.cornell_box()
    cfg = rt.baseline_configs()["full_1024"]
    mesh = make_mesh(dp=4, tp=1)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    img4 = _timed("dp=4 pallas fwd full_1024", jax.jit(
        lambda s: render_image_sharded(s, cfg, mesh, backend="pallas")),
        scene)
    img1 = _timed("1-card pallas fwd full_1024", jax.jit(
        lambda s: render_image(s, cfg, backend="pallas")), scene)
    frac, worst = assert_images_match(img4, img1, tight=1e-6,
                                      what="dp=4 vs 1 card")
    print(f"# dp=4 vs 1-card image: {frac:.5f} over 1e-6, worst {worst:.2e}",
          flush=True)
    g4 = _timed("dp=4 pallas fwd+bwd full_1024", jax.jit(jax.grad(
        lambda s: image_loss(s, target, cfg, mesh, backend="pallas"))),
        scene)
    g1 = _timed("1-card pallas fwd+bwd full_1024", jax.jit(jax.grad(
        lambda s: jnp.mean(jnp.square(render_image(s, cfg, backend="pallas")
                                      - target)))), scene)
    _grads_match(g4, g1, "dp=4 psum'd grads vs 1 card", rel=1e-4)

    big = dense_scene(STREAMED_BENCH_TRIS)
    scfg = streamed_bench_cfg()
    tp_mesh = make_mesh(dp=1, tp=4)
    img_tp = _timed("tp=4 jnp fwd streamed", jax.jit(
        lambda s: render_image_sharded(pad_triangles(s, 4), scfg, tp_mesh,
                                       backend="jnp")), big)
    img_rep = _timed("replicated jnp fwd streamed", jax.jit(
        lambda s: render_image(s, scfg, backend="jnp")), big)
    frac, worst = assert_images_match(img_tp, img_rep, tight=1e-5,
                                      outlier_frac=0.01,
                                      what="tp=4 vs replicated")
    print(f"# tp=4 vs replicated: {frac:.5f} over 1e-5, worst {worst:.2e}",
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU dp and tp checks")
    p.add_argument("--timing", action="store_true",
                   help="also time the Triton and XLA forwards")
    args = p.parse_args(argv)
    count = 4 if args.four else 1
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # keep the host CPU reachable for references; the GPU stays default
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    devs, smi = _device_check(count)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from uob_raytracer_tpu.cache import enable_compilation_cache
    print(f"# compile cache: {enable_compilation_cache()}", flush=True)

    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [("kernel", phase_kernel), ("gradients", phase_gradients),
                  ("main_path", lambda: phase_main_path("chiprun_out")),
                  ("compile_memory", phase_compile_memory),
                  ("gpu_tests", phase_gpu_tests)]
        if args.timing:
            phases.append(("timing", lambda: phase_timing(smi)))
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:          # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        status = "FAILED" if name in failed else "ok"
        print(f"# phase {name}: {status} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(f"# nvidia-smi: {smi}", flush=True)
    if failed:
        print(f"# failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
