"""Top-level render API: one jitted call per frame.

Replaces the reference's per-frame host choreography — rotation-matrix upload,
kernel-arg writes, NDRange enqueue, blocking readback
(``Source/skeleton.cpp:146-182``) — with a single traced function:
ray generation, primary intersection, shading and the wavefront bounce loop
all fuse under ``jax.jit``. The float image stays on device and is
differentiable w.r.t. every Scene leaf; the packed ARGB image reproduces the
reference's screen buffer.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import RenderConfig
from .ops.camera import gen_primary_rays
from .ops.image import pack_argb
from .ops.intersect import prepare_scene
from .ops.shading import shade, shade_cpu_ref
from .scene import Scene


class RenderResult(NamedTuple):
    image: jax.Array   # float32 [H, W, 3]
    packed: jax.Array  # uint32 [H, W] ARGB8888


def _pick_chunk_rows(cfg: RenderConfig, rows: int | None = None,
                     n_tri: int = 1, target_rays: int = 1 << 18,
                     max_elems: int = 1 << 27) -> int:
    """Largest divisor of ``rows`` (default: the image height) keeping
    rows*W*A near the target ray count per chunk, and rays*n_tri under
    max_elems: bounds the peak memory of the [rays, triangles] broadcast
    (0.5 GB per f32 array), which large scenes would otherwise blow up."""
    rows = cfg.height if rows is None else rows
    rays = min(target_rays, max(1, max_elems // max(n_tri, 1)))
    want = max(1, rays // (cfg.width * cfg.aa_rays))
    return max(d for d in range(1, rows + 1) if rows % d == 0 and d <= want)


def _shade_rows(scene: Scene, cfg: RenderConfig, dirs, gid, chunk_rows,
                record: bool):
    """Shade primary rays dirs [rows, W, A, 3] in row chunks. Returns the
    per-ray colors [rows, W, A, 3], with ``record`` also the decisions
    (prim_id, lit_cnt [rows, W, A], bounce_id [B, rows, W, A])."""
    ds = prepare_scene(scene)
    rows, W, A = dirs.shape[:3]
    if chunk_rows is None:
        chunk_rows = _pick_chunk_rows(cfg, rows, scene.tri_v0.shape[0])
    if rows % chunk_rows:
        raise ValueError(
            f"chunk_rows={chunk_rows} must divide the image height {rows}")
    n_chunks = rows // chunk_rows
    rays_per_chunk = chunk_rows * W * A

    d_flat = dirs.reshape(n_chunks, rays_per_chunk, 3)
    gid_flat = jnp.repeat(gid.reshape(-1), A).reshape(n_chunks, rays_per_chunk)
    start = jnp.broadcast_to(ds.camera_pos, (rays_per_chunk, 3))

    def per_chunk(args):
        d_c, gid_c = args
        if cfg.cpu_ref:
            return shade_cpu_ref(ds, cfg, start, d_c, record=record)
        return shade(ds, cfg, start, d_c, gid_c, record=record)

    if n_chunks == 1:
        out = jax.tree_util.tree_map(lambda x: x[None],
                                     per_chunk((d_flat[0], gid_flat[0])))
    else:
        out = jax.lax.map(per_chunk, (d_flat, gid_flat))
    if not record:
        return out.reshape(rows, W, A, 3)
    colors, prim_id, lit, bounce_id = out
    bounce_id = jnp.moveaxis(bounce_id, 1, 0)        # [B, chunks, rays]
    return (colors.reshape(rows, W, A, 3), prim_id.reshape(rows, W, A),
            lit.reshape(rows, W, A),
            bounce_id.reshape(bounce_id.shape[0], rows, W, A))


def render_flat(scene: Scene, cfg: RenderConfig, chunk_rows: int | None = None):
    """Float radiance per AA ray, shaped [H, W, A, 3]. Traceable/differentiable."""
    dirs, gid = gen_primary_rays(cfg, scene.yaw, scene.pitch)
    return _shade_rows(scene, cfg, dirs, gid, chunk_rows, record=False)


def render_flat_res(scene: Scene, cfg: RenderConfig, row0=None,
                    rows: int | None = None, chunk_rows: int | None = None):
    """Plain XLA forward that also records the fused kernel's decision
    residuals: (image [rows, W, 3], ``ops.replay.Residuals``), for the row
    band [row0, row0+rows) of the logical image. The residuals equal the
    kernel's up to boundary flips: it is the kernel's test reference, and
    the forward of the path-replay custom_vjp's "xla" route, which tests
    and the on-card timing use to compare the two forwards."""
    from .ops.replay import Residuals
    dirs, gid = gen_primary_rays(cfg, scene.yaw, scene.pitch)
    rows = cfg.height if rows is None else rows
    if row0 is not None or rows != cfg.height:
        r0 = jnp.asarray(0 if row0 is None else row0, jnp.int32)
        dirs = jax.lax.dynamic_slice_in_dim(dirs, r0, rows, axis=0)
        gid = jax.lax.dynamic_slice_in_dim(gid, r0, rows, axis=0)
    colors, prim_id, lit, bounce_id = _shade_rows(scene, cfg, dirs, gid,
                                                  chunk_rows, record=True)
    img = colors.sum(axis=2) / jnp.float32(colors.shape[2])
    res = Residuals(prim_id=jnp.moveaxis(prim_id, 2, 0),
                    lit_cnt=jnp.moveaxis(lit, 2, 0),
                    bounce_id=jnp.moveaxis(bounce_id, 3, 1))
    return img, res


def _render_image_jnp(scene: Scene, cfg: RenderConfig,
                      chunk_rows: int | None = None) -> jax.Array:
    """Float image [H, W, 3]: AA rays averaged (``kernels.cl:427``)."""
    colors = render_flat(scene, cfg, chunk_rows)
    return colors.sum(axis=2) / jnp.float32(colors.shape[2])


# --------------------------------------------------------------------------
# Path replay: a forward that records each ray's discrete decisions (hit
# object ids per bounce, shadow lit counts) and a backward that
# differentiates the lean replay reconstruction (ops/replay.py) of the
# radiance with those decisions frozen: exact under the framework's
# piecewise-constant-visibility gradient semantics (SURVEY.md §7) and
# O(rays) instead of O(rays x triangles). The forward is the fused kernel
# (route "triton", or "interpret" in the Pallas interpreter) or the plain
# XLA forward (route "xla"). row0 is a traced int32 scalar (a mesh
# axis_index on the dp-sharded path) with a symbolic-zero (float0)
# cotangent; quads is a static pairing that affects only the forward
# occlusion scan (the backward replays with the lit counts frozen).
# --------------------------------------------------------------------------

def _residual_forward(scene, cfg, row0, rows, route, quads):
    if route == "xla":
        return render_flat_res(scene, cfg, row0=row0, rows=rows)
    from .kernels.render_fwd import render_fused_res
    return render_fused_res(scene, cfg, row0=row0, rows=rows, quads=quads,
                            interpret=route == "interpret")


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 3, 4, 5))
def _render_replay(scene: Scene, cfg: RenderConfig, row0, rows: int,
                   route: str, quads=None) -> jax.Array:
    if route == "xla":
        return render_flat_res(scene, cfg, row0=row0, rows=rows)[0]
    from .kernels.render_fwd import render_fused
    return render_fused(scene, cfg, row0=row0, rows=rows, quads=quads,
                        interpret=route == "interpret")


def _replay_fwd(scene, cfg, row0, rows, route, quads):
    img, res = _residual_forward(scene, cfg, row0, rows, route, quads)
    return img, (scene, row0, res)


def _replay_bwd(cfg, rows, route, quads, saved, g):
    from .ops.replay import replay_forward
    scene, row0, res = saved
    _, vjp = jax.vjp(
        lambda s: replay_forward(s, cfg, res, row0=row0, rows=rows), scene)
    (scene_bar,) = vjp(g)
    return scene_bar, np.zeros(np.shape(row0), dtype=jax.dtypes.float0)


_render_replay.defvjp(_replay_fwd, _replay_bwd)

BACKENDS = ("pallas", "jnp")


def resolve_backend(backend: str = "auto") -> str:
    """The render backend for the default platform: the fused kernel on a
    GPU, the plain jnp pipeline on the CPU. Any other platform has no
    backend and raises; an explicit backend is validated and kept."""
    if backend != "auto":
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected 'auto' "
                             f"or one of {BACKENDS}")
        return backend
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "jnp"
    raise ValueError(f"no render backend for platform {platform!r} "
                     f"(supported: gpu, cpu)")


def render_image_rows(scene: Scene, cfg: RenderConfig, row0, rows: int,
                      backend: str, shadow_quads=None,
                      interpret: bool = False) -> jax.Array:
    """Differentiable float image of the row band [row0, row0+rows) through
    the fused kernel and the path-replay backward (backend 'pallas'). row0
    may be traced (the dp-sharded path passes the shard's first row)."""
    if backend != "pallas":
        raise ValueError(f"backend {backend!r} has no path-replay route")
    return _render_replay(scene, cfg, jnp.asarray(row0, jnp.int32), rows,
                          "interpret" if interpret else "triton",
                          shadow_quads)


def render_image(scene: Scene, cfg: RenderConfig,
                 chunk_rows: int | None = None,
                 backend: str = "auto", shadow_quads=None,
                 interpret: bool = False) -> jax.Array:
    """Differentiable float image [H, W, 3].

    backend: 'pallas' (fused Triton kernel forward, path-replay backward),
    'jnp' (plain jnp pipeline, autodiff backward), or 'auto'
    (``resolve_backend``: pallas on a GPU, jnp on the CPU). Every cfg mode,
    cpu_ref included, runs on each backend. interpret=True runs the pallas
    kernel in the Pallas interpreter (tests on the CPU).

    shadow_quads: optional static pairing from
    ``ops.quads.detect_shadow_quads``: merges paired triangles into
    parallelogram rows for the pallas occlusion scan (the dominant cost;
    ~2x fewer shadow rows on Cornell). Affects only boundary-epsilon
    sample rays vs the per-triangle scan (see ops/quads.py docstring)."""
    backend = resolve_backend(backend)
    if backend == "jnp":
        return _render_image_jnp(scene, cfg, chunk_rows)
    return render_image_rows(scene, cfg, 0, cfg.height, backend,
                             shadow_quads, interpret)


@functools.partial(jax.jit, static_argnames=("cfg", "chunk_rows", "backend",
                                             "shadow_quads", "interpret"))
def _render_jit(scene: Scene, cfg: RenderConfig, chunk_rows, backend,
                shadow_quads=None, interpret=False):
    img = render_image(scene, cfg, chunk_rows, backend, shadow_quads,
                       interpret)
    return RenderResult(image=img, packed=pack_argb(img))


def render(scene: Scene, cfg: RenderConfig,
           chunk_rows: int | None = None,
           backend: str = "auto",
           shadow_quads="auto", interpret: bool = False) -> RenderResult:
    """Render a frame (jitted). Returns the float image and the packed
    ARGB8888 screen buffer.

    shadow_quads: "auto" detects parallelogram pairs on the concrete scene
    and uses the quad-merged occlusion scan (pallas backend only); None
    disables; or pass a pairing from ``ops.quads.detect_shadow_quads``.
    An explicitly passed pairing is re-validated against the scene's
    current vertices (``ops.quads.validate_shadow_quads``): a stale pairing
    on moved geometry raises instead of silently corrupting shadows."""
    backend = resolve_backend(backend)
    if shadow_quads == "auto":
        if backend == "pallas" and not cfg.cpu_ref:
            from .ops.quads import detect_shadow_quads
            shadow_quads = detect_shadow_quads(scene)
        else:
            shadow_quads = None
    elif shadow_quads is not None:
        from .ops.quads import validate_shadow_quads
        validate_shadow_quads(scene, shadow_quads)
    return _render_jit(scene, cfg, chunk_rows, backend, shadow_quads,
                       interpret)


def render_packed(scene: Scene, cfg: RenderConfig) -> jax.Array:
    return render(scene, cfg).packed
