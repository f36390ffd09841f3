#!/usr/bin/env python
"""Benchmark harness. Prints ONE JSON line with the headline metric:

    rays/s/device fwd+bwd (Cornell Box 512^2, 1 bounce)

(the BASELINE.json metric), with per-BASELINE-config numbers embedded under
"configs". Rays are *logical* reference-semantics ray-scene queries: primary
rays + per-shaded-ray shadow samples + bounce re-intersects, counted from an
instrumented forward pass — not padded/wavefront lanes. Human-readable
breakdowns go to stderr.

Usage:
    python bench.py                     # headline + all five BASELINE configs
    python bench.py --headline-only     # just the headline metric
    python bench.py --config full_1024  # one named BASELINE config
    python bench.py --scaling           # dp-sharded scaling efficiency sweep
    python bench.py --profile DIR       # jax.profiler trace of one step
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp

import uob_raytracer_tpu as rt
from uob_raytracer_tpu.config import baseline_configs
from uob_raytracer_tpu.ops.camera import gen_primary_rays
from uob_raytracer_tpu.ops.intersect import intersect, prepare_scene
from uob_raytracer_tpu.ops.shading import trace_specular
from uob_raytracer_tpu.render import render_image, resolve_backend

@functools.partial(jax.jit, static_argnames=("cfg",))
def _ray_count_stats(scene, cfg):
    # Chunk the [rays, tris] instrumented pass like render_flat does:
    # unchunked, a 1024x1024 aa4 frame's [rays, tris] arrays outgrow device
    # memory.
    from uob_raytracer_tpu.render import _pick_chunk_rows
    ds = prepare_scene(scene)
    dirs, gid = gen_primary_rays(cfg, scene.yaw, scene.pitch)
    A = dirs.shape[2]
    chunk_rows = _pick_chunk_rows(cfg)
    # large-scene guard: the instrumented jnp pass materializes [rays,
    # n_tri] intermediates — cap chunks at ~2^27 elements (0.5 GB f32)
    n_tri = scene.tri_v0.shape[0]
    while (chunk_rows > 8 and cfg.height % (chunk_rows // 2) == 0
           and chunk_rows * cfg.width * A * n_tri > 2 ** 27):
        chunk_rows //= 2
    n_chunks = cfg.height // chunk_rows
    d_flat = dirs.reshape(n_chunks, chunk_rows * cfg.width * A, 3)

    def per_chunk(d):
        start = jnp.broadcast_to(ds.camera_pos, (d.shape[0], 3))
        h = intersect(ds, start, d)
        prim_diffuse = h.hit & (h.mat > 0)
        if cfg.bounces > 0:
            term = trace_specular(ds, cfg, h, d)
            n_bounce = term["bounce_rays"]
            shaded = prim_diffuse | term["term_valid"]
        else:
            n_bounce = jnp.int32(0)
            shaded = prim_diffuse
        return n_bounce, jnp.sum(shaded.astype(jnp.int32))

    if n_chunks == 1:
        return per_chunk(d_flat[0])
    nb, ns = jax.lax.map(per_chunk, d_flat)
    return jnp.sum(nb), jnp.sum(ns)


def logical_ray_count(scene, cfg) -> int:
    """Reference-semantics ray-query count for one frame: primary rays,
    shadow samples for every shaded ray (primary-diffuse or bounce-terminal,
    kernels.cl:313-340), and one re-intersect per live bounce iteration."""
    n_bounce, n_shaded = _ray_count_stats(scene, cfg)
    n_primary = cfg.width * cfg.height * cfg.aa_rays
    return n_primary + int(n_shaded) * cfg.shadow_samples + int(n_bounce)


# A slope is resolvable only when each timing point holds enough device
# work to stand clear of host burst noise: the flag is on the per-POINT
# window (iters x per-call time), not the per-call time itself.
RESOLUTION_WINDOW_S = 8e-3


class Timing(float):
    """A p50 per-call time (seconds) carrying its run-to-run spread.

    Subclasses float so existing arithmetic (slope differences, rays/s)
    keeps working. ``spread`` is (max - min) / p50 over the slope
    estimates that survive outlier rejection; ``n_rejected`` counts the
    rejected ones and ``below_resolution`` marks measurements whose
    timed window was under the harness floor (RESOLUTION_WINDOW_S)."""

    def __new__(cls, p50: float, spread: float, window_s: float = 1.0,
                n_rejected: int = 0):
        self = super().__new__(cls, p50)
        self.spread = spread
        self.n_rejected = n_rejected
        self.below_resolution = window_s < RESOLUTION_WINDOW_S
        return self

    def ms_dict(self) -> dict:
        d = {"p50": round(self * 1e3, 4), "spread": round(self.spread, 4)}
        if self.n_rejected:
            d["outliers_rejected"] = self.n_rejected
        if self.below_resolution:
            d["below_resolution"] = True
        return d


def time_scalar_fn(scalar_fn, scene, iters: int,
                   n_estimates: int = 7) -> Timing:
    """Time ``scalar_fn(scene) -> f32 scalar`` per call, robustly.

    The per-iteration work is chained inside ONE jitted fori_loop — each
    iteration perturbs the scene by a value depending on the previous
    result, so XLA cannot hoist or deduplicate it — and the final scalar is
    fetched to the host, which forces completion.

    The host fetch and dispatch cost a FIXED latency independent of the
    work inside the loop, so the per-iteration time is estimated as the
    SLOPE between an N-iteration and a 2N-iteration run:
    (T(2N) - T(N)) / N cancels every per-fetch constant and measures pure
    device throughput. ``n_estimates`` independent slope
    estimates are taken, each from an adjacent interleaved (N, 2N) pair of
    min-of-2 timings so host drift hits both points of a pair alike.

    Robustness (r4 verdict: driver-host captures showed 16-30% spreads
    while quiet-host runs sat at <=8%): a non-quiet host injects occasional
    multi-ms bursts into single timing points, which shows up as a few
    wild slope estimates among tight ones. Estimates farther than
    3 x MAD-sigma (or 5% of the median, whichever is larger) from the
    median are rejected as burst-contaminated, and the reported p50/spread
    come from the surviving set (the rejection count is carried on the
    result — a capture that rejects most of its estimates is suspect and
    says so). The trip count is a traced argument, so every point shares
    one compiled program."""
    import dataclasses
    import statistics

    @jax.jit
    def run(s, n):
        def body(_, carry):
            acc, s2 = carry
            s3 = dataclasses.replace(
                s2, light_pos=s2.light_pos + acc * 1e-12 + 1e-6)
            return acc + scalar_fn(s3), s3
        acc, _ = jax.lax.fori_loop(0, n, body, (jnp.float32(0.0), s))
        return acc

    def once(n):
        t0 = time.perf_counter()
        float(run(scene, n))
        return time.perf_counter() - t0

    float(run(scene, iters))       # compile + warm (same program for 2N)
    float(run(scene, 2 * iters))
    slopes = []
    for _ in range(n_estimates):
        t1 = min(once(iters) for _ in range(2))
        t2 = min(once(2 * iters) for _ in range(2))
        slopes.append(max(t2 - t1, 1e-9) / iters)
    p50, spread, n_rejected = robust_slope_stats(slopes)
    return Timing(p50, spread, window_s=p50 * iters,
                  n_rejected=n_rejected)


def robust_slope_stats(slopes) -> tuple:
    """(p50, spread, n_rejected) of a set of slope estimates under
    MAD-based burst rejection — the pure math of ``time_scalar_fn``,
    factored out so the rejection contract is unit-testable without a
    device (tests/test_bench_stats.py).

    Estimates farther than 3 MAD-sigma from the median are rejected as
    burst-contaminated; the 5%-of-median floor keeps legitimate
    few-percent scatter from being trimmed into a fake-tight spread. If
    rejection leaves fewer than 3 estimates (degenerate MAD, e.g. a
    bimodal set), the min and max are dropped instead and the rest kept —
    a capture that rejects most of its estimates is suspect, and says so
    through ``n_rejected``."""
    import statistics

    med = statistics.median(slopes)
    mad_sigma = 1.4826 * statistics.median(abs(s - med) for s in slopes)
    bound = max(3.0 * mad_sigma, 0.05 * med)
    kept = [s for s in slopes if abs(s - med) <= bound]
    if len(kept) < 3:              # degenerate MAD: keep the central
        kept = sorted(slopes)[1:-1] or list(slopes)   # estimates instead
    p50 = statistics.median(kept)
    spread = (max(kept) - min(kept)) / p50
    return p50, spread, len(slopes) - len(kept)


def _quads_for(scene, backend):
    """Quad-merged occlusion pairing (production default on the pallas
    path: halves the shadow scan on Cornell — see ops/quads.py)."""
    if backend == "jnp":
        return None
    from uob_raytracer_tpu.ops.quads import detect_shadow_quads
    return detect_shadow_quads(scene)


def _fwd_scalar(cfg, backend, quads=None):
    return lambda s: jnp.mean(render_image(s, cfg, backend=backend,
                                           shadow_quads=quads))


def _step_scalar(cfg, backend, quads=None):
    """Forward+backward: gradient of a scalar image loss w.r.t. every scene
    parameter (vertices, colors, light, camera); a bit of every gradient
    leaf is folded into the timed scalar so the whole backward stays live."""
    def loss_grad(s):
        v, g = jax.value_and_grad(
            lambda ss: jnp.mean(render_image(ss, cfg, backend=backend,
                                             shadow_quads=quads)))(s)
        return v + sum(jnp.sum(x) * 1e-12
                       for x in jax.tree_util.tree_leaves(g))
    return loss_grad


def assert_finite_grads(cfg, backend, quads, scene) -> None:
    """Evaluate the gradient once and require every leaf finite BEFORE any
    fwd+bwd timing is trusted: NaN-poisoned gradients make the chained
    bench silently CHEAPER (the scene perturbation goes NaN and later
    frames short-circuit) — the failure mode that corrupted the round-2
    numbers via the tangent-ray NaN bug."""
    import numpy as np
    g = jax.grad(lambda ss: jnp.mean(render_image(ss, cfg, backend=backend,
                                                  shadow_quads=quads)))(scene)
    bad = [f"Scene.{name}"
           for name, leaf in vars(g).items()
           if not bool(np.isfinite(np.asarray(leaf)).all())]
    if bad:
        raise AssertionError(
            f"non-finite gradient leaves {bad} — fwd+bwd timings would be "
            f"meaningless (NaN scenes render cheaper); refusing to bench")


def _rate(rays: int, dt: Timing):
    """rays/s from a Timing, or None when under the measurement floor."""
    return None if dt.below_resolution else round(rays / dt)


def _adaptive_iters(scalar_fn, scene, lo: int = 8, hi: int = 400,
                    target_s: float = 0.03) -> int:
    """Pick a chained-loop trip count so each timing point holds ~30 ms of
    device work: sub-ms frames at a fixed 7 iterations leave the slope
    inside host burst noise."""
    rough = time_scalar_fn(scalar_fn, scene, lo, n_estimates=2)
    return max(lo, min(hi, int(target_s / max(float(rough), 2e-5))))


def bench_config(name: str, cfg, scene, iters: int, backend: str) -> dict:
    rays = logical_ray_count(scene, cfg)
    quads = None if cfg.cpu_ref else _quads_for(scene, backend)
    assert_finite_grads(cfg, backend, quads, scene)
    fwd_fn = _fwd_scalar(cfg, backend, quads)
    step_fn = _step_scalar(cfg, backend, quads)
    # 9 slope estimates per reported config number (headline uses 7): the
    # per-config table is the BENCH contract, so give the MAD rejection
    # two more samples of headroom toward the <=10% spread budget
    dt_fwd = time_scalar_fn(fwd_fn, scene,
                            _adaptive_iters(fwd_fn, scene, lo=iters),
                            n_estimates=9)
    dt_step = time_scalar_fn(step_fn, scene,
                             _adaptive_iters(step_fn, scene,
                                             lo=max(4, iters // 2)),
                             n_estimates=9)
    out = {
        "rays_per_frame": rays,
        "grads_finite": True,
        "fwd_ms": dt_fwd.ms_dict(),
        "fwd_rays_s": _rate(rays, dt_fwd),
        "fwd_bwd_ms": dt_step.ms_dict(),
        "fwd_bwd_rays_s": _rate(rays, dt_step),
    }

    def _g(r):
        return "below measurement floor" if r is None else f"{r/1e9:.2f} G rays/s"
    print(f"# {name}: {cfg.width}x{cfg.height} aa{cfg.aa_rays} "
          f"s{cfg.shadow_samples} b{cfg.bounces} | {rays:,} rays | "
          f"fwd {out['fwd_ms']['p50']} ms ±{dt_fwd.spread:.0%} "
          f"({_g(out['fwd_rays_s'])}) | "
          f"fwd+bwd {out['fwd_bwd_ms']['p50']} ms ±{dt_step.spread:.0%} "
          f"({_g(out['fwd_bwd_rays_s'])})", file=sys.stderr)
    return out


def dense_scene(n_tri: int, seed: int = 1):
    """Cornell box + random small diffuse triangles inside it — the
    large-scene workload (the kernel's looped, non-unrolled scans); same
    recipe as tests/test_pallas.py::_dense_scene."""
    import numpy as np

    from uob_raytracer_tpu.scene import add_triangles
    base = rt.cornell_box()
    rng = np.random.RandomState(seed)
    extra = n_tri - int(base.tri_v0.shape[0])
    c = (rng.uniform(-0.9, 0.9, (extra, 3)).astype(np.float32)
         * np.float32([1, 1, 0.3]))
    c[:, 2] -= 0.2
    verts = np.stack(
        [c, c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32),
         c + rng.uniform(0.01, 0.05, (extra, 3)).astype(np.float32)], axis=1)
    return add_triangles(base, verts, np.full((extra, 3), 0.6, np.float32),
                         np.ones((extra,), np.float32))


# the large-scene benchmark config: 8k brute-force triangles at 128^2 aa4
STREAMED_BENCH_TRIS = 8192


def streamed_bench_cfg():
    return rt.RenderConfig(width=128, height=128, aa_x=2, aa_y=2,
                           shadow_samples=3, bounces=2)


def bench_scaling(scene, iters: int) -> dict:
    """dp-sharded fwd+bwd over 1..n_devices devices: per-device scaling
    efficiency eff(N) = T(1) / (N * T(N)) at fixed total work (one frame).
    With a single device this exercises plumbing only (dp=1)."""
    from uob_raytracer_tpu.parallel import make_mesh, image_loss

    n_dev = len(jax.devices())
    dps = sorted({1, 2, n_dev} & set(range(1, n_dev + 1))) if n_dev > 1 else [1]
    backend = resolve_backend("auto")
    h = 512 if 512 % (8 * n_dev) == 0 else 8 * n_dev * (512 // (8 * n_dev) + 1)
    cfg = rt.RenderConfig(width=512, height=h, aa_x=2, aa_y=2,
                          shadow_samples=10, bounces=1)
    rays = logical_ray_count(scene, cfg)
    quads = _quads_for(scene, backend)   # per-shard headline kernel
    results = {}
    t1 = None
    for dp in dps:
        mesh = make_mesh(dp=dp, tp=1, devices=jax.devices()[:dp])

        def loss_grad(s, mesh=mesh):
            v, g = jax.value_and_grad(image_loss)(
                s, jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
                cfg, mesh, backend, quads)
            return v + sum(jnp.sum(x) * 1e-12
                           for x in jax.tree_util.tree_leaves(g))

        dt = time_scalar_fn(loss_grad, scene, iters)
        if t1 is None:
            t1 = dt
        eff = t1 / (dp * dt)
        results[f"dp{dp}"] = {"fwd_bwd_ms": round(dt * 1e3, 3),
                              "rays_s": round(rays / dt),
                              "efficiency": round(eff, 4)}
        print(f"# scaling dp={dp}: {dt*1e3:.2f} ms/step "
              f"({rays/dt:.3e} rays/s, efficiency {eff:.1%})",
              file=sys.stderr)
    return results


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--bounces", type=int, default=1)
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--backend", default="auto")
    p.add_argument("--headline-only", action="store_true",
                   help="skip the per-BASELINE-config sweep")
    p.add_argument("--config", default=None, metavar="NAME",
                   help="bench one named BASELINE config and exit "
                        f"(one of: {', '.join(baseline_configs())})")
    p.add_argument("--scaling", action="store_true",
                   help="dp-sharded scaling sweep over available devices")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of one fwd+bwd step "
                        "into DIR (view in TensorBoard/Perfetto)")
    args = p.parse_args()

    args.backend = resolve_backend(args.backend)
    scene = rt.cornell_box()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    from uob_raytracer_tpu.cache import enable_compilation_cache
    cache = enable_compilation_cache()   # warm benches skip recompiles
    print(f"# device: {device}, compile_cache: {cache}", file=sys.stderr)

    if args.config:
        if args.config.startswith("streamed"):
            cfg = streamed_bench_cfg()
            scene = dense_scene(STREAMED_BENCH_TRIS)
        else:
            cfg = baseline_configs()[args.config]
        out = bench_config(args.config, cfg, scene, args.iters, args.backend)
        print(json.dumps({
            "metric": f"rays/s/device fwd+bwd ({args.config})",
            "value": out["fwd_bwd_rays_s"], "unit": "rays/s",
            "device": device}))
        return

    if args.scaling:
        res = bench_scaling(scene, max(4, args.iters // 4))
        last = list(res)[-1]
        print(json.dumps({
            "metric": f"dp scaling efficiency ({last})",
            "value": res[last]["efficiency"], "unit": "fraction",
            "device": device, "scaling": res}))
        return

    # --- headline: Cornell Box 512^2, AA4, 10 shadow samples, 1 bounce ---
    h = args.height or args.width
    cfg = rt.RenderConfig(width=args.width, height=h, aa_x=2, aa_y=2,
                          shadow_samples=args.samples, bounces=args.bounces)
    rays = logical_ray_count(scene, cfg)
    print(f"# logical rays/frame: {rays:,} "
          f"({cfg.width}x{cfg.height} aa{cfg.aa_rays} "
          f"s{cfg.shadow_samples} b{cfg.bounces})", file=sys.stderr)

    quads = _quads_for(scene, args.backend)
    assert_finite_grads(cfg, args.backend, quads, scene)
    dt_fwd = time_scalar_fn(_fwd_scalar(cfg, args.backend, quads), scene,
                            args.iters)
    print(f"# forward: {dt_fwd*1e3:.2f} ms/frame ±{dt_fwd.spread:.0%} = "
          f"{rays/dt_fwd:.3e} rays/s", file=sys.stderr)
    dt_step = time_scalar_fn(_step_scalar(cfg, args.backend, quads), scene,
                             max(5, args.iters // 2))
    print(f"# fwd+bwd: {dt_step*1e3:.2f} ms/step ±{dt_step.spread:.0%} = "
          f"{rays/dt_step:.3e} rays/s", file=sys.stderr)

    if args.profile:
        with jax.profiler.trace(args.profile):
            jax.block_until_ready(jax.jit(
                _step_scalar(cfg, args.backend))(scene))
        print(f"# profiler trace written to {args.profile}", file=sys.stderr)

    configs = {}
    if not args.headline_only:
        sweep = list(baseline_configs().items())
        sweep.append((f"streamed_{STREAMED_BENCH_TRIS}", streamed_bench_cfg()))
        for name, ccfg in sweep:
            cscene = (dense_scene(STREAMED_BENCH_TRIS)
                      if name.startswith("streamed_") else scene)
            configs[name] = bench_config(name, ccfg, cscene,
                                         max(4, args.iters // 4),
                                         args.backend)

    value = rays / dt_step
    out = {
        "metric": f"rays/s/device fwd+bwd (Cornell Box {cfg.width}^2, "
                  f"{cfg.bounces} bounce)",
        "value": value,
        "unit": "rays/s",
        "device": device,
        "fwd_ms": dt_fwd.ms_dict(),
        "fwd_bwd_ms": dt_step.ms_dict(),
        "grads_finite": True,
    }
    if configs:
        out["configs"] = configs
    print(json.dumps(out))


if __name__ == "__main__":
    main()
