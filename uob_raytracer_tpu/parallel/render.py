"""Sharded rendering: pixel rows over 'dp', optionally triangles over 'tp'.

One ``shard_map`` wraps the whole per-shard pipeline (ray gen slice ->
intersect -> shade -> bounce loop), so a frame is a single XLA program per
device with collectives only where the triangle axis is sharded. The image
comes back sharded over rows; gathering it to the host is the analogue of
the reference's blocking screen-buffer readback (``skeleton.cpp:179-181``)
and stays off the hot loop in benchmarks.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..ops.camera import gen_primary_rays
from ..ops.intersect import prepare_scene
from ..ops.shading import shade, shade_cpu_ref
from ..render import render_image_rows, resolve_backend
from ..scene import Scene


def _scene_specs(scene: Scene, tp: bool) -> Scene:
    """PartitionSpec pytree for a Scene: triangles sharded over 'tp' (when
    enabled), everything else replicated."""
    tri = P("tp") if tp else P()
    return Scene(
        tri_v0=tri, tri_v1=tri, tri_v2=tri, tri_rgb=tri, tri_mat=tri,
        sph_center=P(), sph_r2=P(), sph_rgb=P(), sph_mat=P(),
        light_pos=P(), light_color=P(), indirect_light=P(),
        camera_pos=P(), yaw=P(), pitch=P(),
    )


def render_image_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                         chunk_rows: int | None = None,
                         backend: str = "auto",
                         shadow_quads=None,
                         interpret: bool = False) -> jax.Array:
    """Render the float image [H, W, 3] sharded over ``mesh``.

    Rows are split over 'dp'; if the mesh's 'tp' axis is larger than 1 the
    triangle arrays are sharded over it (pad first with
    ``mesh.pad_triangles``) and nearest-hit/occlusion results are combined
    with collectives. Differentiable: gradients of replicated scene leaves
    are psum'd automatically by the shard_map transpose.

    backend: as in ``render.render_image`` ('auto' resolves by platform).
    With tp == 1 the 'pallas' backend renders each shard's row band through
    the same path-replay custom_vjp as the single-device path. tp > 1 runs the jnp pipeline only ('auto' picks it; asking for
    another backend raises).

    shadow_quads: static quad pairing for the pallas occlusion scan, as in
    ``render.render_image`` ("auto" detects on a concrete scene; traced
    scenes need an explicit pairing or None).
    """
    tp = mesh.shape["tp"] > 1
    backend = "jnp" if tp and backend == "auto" else resolve_backend(backend)
    if tp and backend != "jnp":
        raise ValueError(f"tp > 1 runs the jnp pipeline only, not {backend!r}")
    if backend == "pallas" and shadow_quads == "auto":
        from ..ops.quads import detect_shadow_quads
        shadow_quads = detect_shadow_quads(scene)
    elif shadow_quads == "auto":
        shadow_quads = None
    if shadow_quads is not None:
        from ..ops.quads import validate_shadow_quads
        validate_shadow_quads(scene, shadow_quads)
    tri_axis = "tp" if tp else None
    n_dp = mesh.shape["dp"]
    H, W = cfg.height, cfg.width
    if H % n_dp:
        raise ValueError(f"height {H} not divisible by dp={n_dp}")
    if tp and scene.tri_v0.shape[0] % mesh.shape["tp"]:
        raise ValueError("triangle count not divisible by tp; use pad_triangles")
    rows_per_shard = H // n_dp
    if backend != "jnp":
        def body_replay(scene_rep):
            row0 = jax.lax.axis_index("dp") * rows_per_shard
            return render_image_rows(scene_rep, cfg, row0, rows_per_shard,
                                     backend, shadow_quads, interpret)

        fn = shard_map(body_replay, mesh=mesh,
                       in_specs=(_scene_specs(scene, False),),
                       out_specs=P("dp"), check_vma=False)
        return fn(scene)

    dirs, gid = gen_primary_rays(cfg, scene.yaw, scene.pitch)
    A = dirs.shape[2]

    def body(scene_shard, dirs_s, gid_s):
        ds = prepare_scene(scene_shard)
        if tp:
            t_local = scene_shard.tri_v0.shape[0]
            ds = ds._replace(
                tri_offset=(jax.lax.axis_index("tp") * t_local).astype(jnp.int32))
        d_flat = dirs_s.reshape(-1, 3)
        gid_flat = jnp.repeat(gid_s.reshape(-1), A)
        start = jnp.broadcast_to(ds.camera_pos, (d_flat.shape[0], 3))
        if cfg.cpu_ref:
            colors = shade_cpu_ref(ds, cfg, start, d_flat)
        else:
            colors = shade(ds, cfg, start, d_flat, gid_flat, tri_axis)
        img = colors.reshape(rows_per_shard, W, A, 3)
        return img.sum(axis=2) / jnp.float32(A)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(_scene_specs(scene, tp), P("dp"), P("dp")),
        out_specs=P("dp"),
        check_vma=False,
    )
    return fn(scene, dirs, gid)
