"""Ray-scene intersection (triangles + analytic spheres), differentiable.

Semantics follow ``single_ray_intersections`` / ``batch_ray_intersections``
(``Source/kernels.cl:92-241``): Cramer's-rule Moller-Trumbore over all
triangles with strict nearest-t (ties keep the lowest index), then spheres
via the catastrophic-cancellation-stable quadratic (q/a, c/q root pairing,
``kernels.cl:140-143``) with strict < against the triangle best. Brute force
over the triangle axis — no BVH — so every lane does identical work.

Tensor-parallel mode: when ``tri_axis`` names a mesh axis (inside
``shard_map``), each shard holds a slice of the triangle arrays plus its
global index offset (``DeviceScene.tri_offset``); the local nearest hits are
combined across shards with a pmin on t, a lowest-global-index tie-break
(matching the reference's first-triangle-wins scan order), and a masked psum
to gather the winning shard's hit attributes. Spheres are replicated on every
shard, so the sphere merge needs no communication.

All denominators are routed through double-where guards so reverse-mode
gradients stay NaN-free; forward values on valid lanes are unchanged
(degenerate lanes are rejected by the same comparisons that reject them in
the reference, where 1/0 produced inf/NaN).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene import Scene
from .math3 import det3, dot3, normalize3

# np scalars, not jnp: module-level jnp scalars commit a device array at
# import time, which initializes the XLA backend and breaks anything that
# must run first (jax.distributed.initialize in multi-host workers).
_INF = np.float32(np.inf)
_IMAX = np.int32(2**31 - 1)


class DeviceScene(NamedTuple):
    """Derived, render-ready scene arrays (a pytree; fully differentiable).
    Normals are recomputed from vertices here — inside the traced graph — so
    vertex gradients flow through shading."""

    v0: jnp.ndarray    # [T,3]
    e1: jnp.ndarray    # [T,3]
    e2: jnp.ndarray    # [T,3]
    n: jnp.ndarray     # [T,3] unit normals, normalize(cross(e2,e1))
    rgb: jnp.ndarray   # [T,3]
    mat: jnp.ndarray   # [T]
    sph_c: jnp.ndarray   # [S,3]
    sph_r2: jnp.ndarray  # [S]
    sph_rgb: jnp.ndarray  # [S,3]
    sph_mat: jnp.ndarray  # [S]
    light_pos: jnp.ndarray
    light_color: jnp.ndarray
    indirect: jnp.ndarray
    camera_pos: jnp.ndarray
    # Global index of this shard's first triangle (0 unless triangle-sharded).
    tri_offset: jnp.ndarray | int = 0

    @property
    def num_spheres(self) -> int:
        return self.sph_c.shape[0]


class Hit(NamedTuple):
    hit: jnp.ndarray      # bool [N]
    pos: jnp.ndarray      # [N,3]
    normal: jnp.ndarray   # [N,3]
    rgb: jnp.ndarray      # [N,3]
    mat: jnp.ndarray      # [N]
    t: jnp.ndarray        # [N]
    obj_id: jnp.ndarray   # [N] int32: triangle i, T + sphere s, -1 miss


def prepare_scene(scene: Scene) -> DeviceScene:
    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    n = jnp.cross(e2, e1)
    nn = dot3(n, n)
    n = n / jnp.sqrt(jnp.where(nn == 0, 1.0, nn))[..., None]  # safe for padding
    return DeviceScene(
        v0=scene.tri_v0, e1=e1, e2=e2, n=n,
        rgb=scene.tri_rgb, mat=scene.tri_mat,
        sph_c=scene.sph_center, sph_r2=scene.sph_r2,
        sph_rgb=scene.sph_rgb, sph_mat=scene.sph_mat,
        light_pos=scene.light_pos, light_color=scene.light_color,
        indirect=scene.indirect_light, camera_pos=scene.camera_pos,
    )


def _materialize(x):
    """Keep the [rays, triangles] tests out of the reduction's fusion. Fused
    into the reduce over an 8,192-triangle scene, XLA's GPU compile of the
    jnp forward did not finish in 20 minutes; materialized, it compiles in
    about 6 s on an H100."""
    return jax.lax.optimization_barrier(x)


def _tri_tuv(ds: DeviceScene, start, d):
    """Per-triangle (t, u, v, degenerate) arrays of shape [N, T]."""
    dN = d[:, None, :]
    b = start[:, None, :] - ds.v0[None]
    e1, e2 = ds.e1[None], ds.e2[None]
    detA = det3(-dN, e1, e2)
    degenerate = detA == 0
    recip = jnp.float32(1.0) / jnp.where(degenerate, jnp.float32(1.0), detA)
    t = det3(b, e1, e2) * recip
    u = det3(-dN, b, e2) * recip
    v = det3(-dN, e1, b) * recip
    return t, u, v, degenerate


def _sphere_roots(ds: DeviceScene, start, d):
    """Stable quadratic roots (x_min, x_max, no_solution) of shape [N, S]."""
    L = start[:, None, :] - ds.sph_c[None]
    a = dot3(d, d)[:, None]
    b = jnp.float32(2.0) * dot3(d[:, None, :], L)
    c = dot3(L, L) - ds.sph_r2[None]
    disc = b * b - jnp.float32(4.0) * a * c
    no_sol = disc < 0
    # Route miss lanes through sqrt(1): sqrt(max(disc,0)) would be exact too,
    # but its backward at clamped lanes is inf * 0 = NaN. Valid lanes see the
    # exact sqrt(disc). disc == 0 (exact tangent — reachable at f32, e.g.
    # axis-aligned grazing rays) also short-circuits: sqrt'(0) = inf would
    # poison every sphere-quadratic input's gradient; the framework's
    # piecewise convention takes the zero one-sided derivative instead.
    sq_zero = disc == 0
    sq = jnp.sqrt(jnp.where(no_sol | sq_zero, jnp.float32(1.0), disc))
    sq = jnp.where(sq_zero, jnp.float32(0.0), sq)
    q = jnp.where(b > 0, jnp.float32(-0.5) * (b + sq), jnp.float32(-0.5) * (b - sq))
    q_zero = q == 0
    q_s = jnp.where(q_zero, jnp.float32(1.0), q)
    x0 = q / jnp.where(a == 0, jnp.float32(1.0), a)  # a = |d|^2 > 0 in practice
    # q == 0 implies c == 0 (ray origin on the sphere): the reference's
    # c/q = 0/0 NaN root collapses to the x0 = 0 candidate; substituting x0
    # keeps the forward result identical while avoiding an inf that would
    # leak NaN into reverse-mode (0 * inf) cotangents.
    x1 = jnp.where(q_zero, x0, c / q_s)
    xmin = jnp.minimum(x0, x1)
    xmax = jnp.maximum(x0, x1)
    return xmin, xmax, no_sol


class _TriBest(NamedTuple):
    t: jnp.ndarray       # [N] nearest accepted t (inf if none)
    idx: jnp.ndarray     # [N] int32 global triangle index (IMAX if none)
    pos: jnp.ndarray     # [N,3]
    normal: jnp.ndarray  # [N,3]
    rgb: jnp.ndarray     # [N,3]
    mat: jnp.ndarray     # [N]


def _best_triangle(ds: DeviceScene, start, d) -> _TriBest:
    n_rays = d.shape[0]
    t, u, v, degenerate = _tri_tuv(ds, start, d)
    valid = ((t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)) & ~degenerate
    t_m = jnp.where(valid, t, _INF)
    t_m = jnp.where(jnp.isnan(t_m), _INF, t_m)
    li = jnp.argmin(_materialize(t_m), axis=1)
    ar = jnp.arange(n_rays)
    tb = t_m[ar, li]
    hit = jnp.isfinite(tb)
    u_b = jnp.where(hit, u[ar, li], 0.0)
    v_b = jnp.where(hit, v[ar, li], 0.0)
    pos = ds.v0[li] + u_b[:, None] * ds.e1[li] + v_b[:, None] * ds.e2[li]
    return _TriBest(
        t=tb,
        idx=jnp.where(hit, li.astype(jnp.int32) + ds.tri_offset, _IMAX),
        pos=jnp.where(hit[:, None], pos, 0.0),
        normal=jnp.where(hit[:, None], ds.n[li], 0.0),
        rgb=jnp.where(hit[:, None], ds.rgb[li], 0.0),
        mat=jnp.where(hit, ds.mat[li], jnp.float32(1.0)),
    )


def _combine_tri_best(best: _TriBest, tri_axis: str) -> _TriBest:
    """Cross-shard nearest-hit reduction: min t, ties to the lowest global
    triangle index (the reference's scan order), attributes gathered from the
    winning shard by masked psum.

    t is wrapped in stop_gradient before the pmin: jax has no pmin
    differentiation rule, and none is needed — downstream t only feeds
    comparisons (zero gradient); the differentiable hit attributes travel
    through the psum, which transposes fine."""
    t_g = jax.lax.pmin(jax.lax.stop_gradient(best.t), tri_axis)
    at_min = best.t == t_g
    cand = jnp.where(at_min, best.idx, _IMAX)
    idx_g = jax.lax.pmin(cand, tri_axis)
    win = at_min & (best.idx == idx_g) & (best.idx != _IMAX)
    pick = lambda x: jax.lax.psum(
        jnp.where(win[..., None] if x.ndim == 2 else win, x, 0), tri_axis)
    hit_any = jnp.isfinite(t_g)
    return _TriBest(
        t=t_g,
        idx=idx_g,
        pos=pick(best.pos),
        normal=pick(best.normal),
        rgb=pick(best.rgb),
        mat=jnp.where(hit_any, pick(best.mat), jnp.float32(1.0)),
    )


def intersect(ds: DeviceScene, start, d, tri_axis: str | None = None) -> Hit:
    """Nearest hit for rays (start [N,3], d [N,3]). ``obj_id`` uses the
    fused kernel's encoding: -1 miss, i for (global) triangle i, T + s for
    sphere s, with T the global triangle count."""
    best = _best_triangle(ds, start, d)
    n_tri = ds.v0.shape[0]
    if tri_axis is not None:
        n_tri *= jax.lax.axis_size(tri_axis)
        best = _combine_tri_best(best, tri_axis)
    tri_t = best.t

    if ds.num_spheres:
        n_rays = d.shape[0]
        ar = jnp.arange(n_rays)
        xmin, xmax, no_sol = _sphere_roots(ds, start, d)
        cand = jnp.where(xmin >= 0, xmin, xmax)
        ok = ~no_sol & (cand >= 0)
        st = jnp.where(ok, cand, _INF)
        st = jnp.where(jnp.isnan(st), _INF, st)
        sph_idx = jnp.argmin(st, axis=1)
        sph_t = st[ar, sph_idx]
        sphere_wins = sph_t < tri_t
        sph_t_safe = jnp.where(jnp.isfinite(sph_t), sph_t, 0.0)
        sph_pos = start + d * sph_t_safe[:, None]
        sph_n = normalize3(sph_pos - ds.sph_c[sph_idx], jnp.isfinite(sph_t))
        pos = jnp.where(sphere_wins[:, None], sph_pos, best.pos)
        normal = jnp.where(sphere_wins[:, None], sph_n, best.normal)
        rgb = jnp.where(sphere_wins[:, None], ds.sph_rgb[sph_idx], best.rgb)
        mat = jnp.where(sphere_wins, ds.sph_mat[sph_idx], best.mat)
        t_best = jnp.where(sphere_wins, sph_t, tri_t)
        obj = jnp.where(sphere_wins, sph_idx.astype(jnp.int32) + n_tri,
                        best.idx)
    else:
        pos, normal = best.pos, best.normal
        rgb, mat = best.rgb, best.mat
        t_best, obj = tri_t, best.idx

    hit_any = jnp.isfinite(t_best)
    obj = jnp.where(hit_any, obj, jnp.int32(-1))
    return Hit(hit=hit_any, pos=pos, normal=normal, rgb=rgb, mat=mat,
               t=t_best, obj_id=obj)


def in_shadow(ds: DeviceScene, start, d, radius_sq,
              tri_axis: str | None = None) -> jnp.ndarray:
    """Occlusion toward the light (``kernels.cl:243-311``): glass (mat == -1)
    casts no shadow; an occluder counts at t >= 0 with |t*d|^2 < radius_sq.
    No early exit: the masked any() over all objects is one fused
    reduction over the [rays, triangles] tests."""
    t, u, v, degenerate = _tri_tuv(ds, start, d)
    dist = t * t * dot3(d, d)[:, None]
    occ = ((t >= 0) & (dist < radius_sq[:, None])
           & (u >= 0) & (v >= 0) & ((u + v) <= 1) & ~degenerate
           & (ds.mat[None] != jnp.float32(-1.0)))
    occluded = jnp.any(_materialize(occ), axis=1)
    if ds.num_spheres:
        xmin, xmax, no_sol = _sphere_roots(ds, start, d)
        dd = dot3(d, d)[:, None]
        occ_s = (~no_sol & (ds.sph_mat[None] != jnp.float32(-1.0))
                 & (((xmin >= 0) & (xmin * xmin * dd < radius_sq[:, None]))
                    | ((xmax >= 0) & (xmax * xmax * dd < radius_sq[:, None]))))
        occluded = occluded | jnp.any(occ_s, axis=1)
    if tri_axis is not None:
        occluded = jax.lax.pmax(occluded.astype(jnp.int32), tri_axis) > 0
    return occluded
