"""Gradient tests (BASELINE config 5 semantics): autodiff through the
renderer vs central finite differences. Visibility (nearest-hit argmin,
shadow masks, accept tests) is piecewise-constant, so the defined gradient is
the interior/shading gradient — correct almost everywhere; finite-difference
comparisons use small epsilons and mean-pooled losses so boundary flips stay
in the noise (SURVEY.md §7 'gradients through discontinuities')."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uob_raytracer_tpu import RenderConfig, cornell_box
from uob_raytracer_tpu.render import render_image

CFG = RenderConfig(width=24, height=24, aa_x=1, aa_y=1, shadow_samples=2,
                   bounces=2)


@pytest.fixture(scope="module")
def scene():
    return cornell_box()


def _loss(scene):
    img = render_image(scene, CFG, chunk_rows=CFG.height)
    # Mean-pooled scalar; weights break symmetry so gradients are generic.
    w = jnp.linspace(0.5, 1.5, img.size).reshape(img.shape)
    return jnp.mean(img * w)


def _fd(scene, field, idx, eps):
    def set_at(s, val):
        arr = getattr(s, field)
        return dataclasses.replace(s, **{field: arr.at[idx].set(val)})
    base = getattr(scene, field)[idx]
    lp = _loss(set_at(scene, base + eps))
    lm = _loss(set_at(scene, base - eps))
    return (float(lp) - float(lm)) / (2 * eps)


@pytest.mark.parametrize("field,idx,eps,rtol", [
    ("light_pos", (0,), 1e-3, 0.08),
    ("light_pos", (1,), 1e-3, 0.08),
    ("light_color", (1,), 1e-2, 0.02),
    ("tri_rgb", (9, 2), 1e-2, 0.02),       # back wall blue channel: linear
    ("indirect_light", (0,), 1e-2, 0.02),
    ("tri_v0", (9, 0), 1e-3, 0.25),        # vertex: shading grad only
])
def test_autodiff_matches_fd(scene, field, idx, eps, rtol):
    g = jax.grad(_loss)(scene)
    auto = float(getattr(g, field)[idx])
    fd = _fd(scene, field, idx, eps)
    assert np.isfinite(auto)
    if abs(fd) < 1e-7 and abs(auto) < 1e-7:
        return
    assert auto == pytest.approx(fd, rel=rtol, abs=1e-6), (field, idx)


def test_camera_grad_matches_fd_on_stable_pixels(scene):
    # Moving the camera shifts every visibility boundary, so a plain FD of
    # the mean image is dominated by edge flips (its sign flips with eps).
    # The framework's gradient semantics are the interior/shading gradient,
    # so the FD comparison masks to pixels whose primary hit object is
    # stable under the perturbation (SURVEY.md §7).
    import jax
    from uob_raytracer_tpu.ops.camera import gen_primary_rays
    from uob_raytracer_tpu.ops.intersect import prepare_scene, intersect, in_shadow
    from uob_raytracer_tpu.ops.math3 import dot3
    from uob_raytracer_tpu.ops.rng import shadow_seed, xorshift, crush

    cfg = RenderConfig(width=24, height=24, aa_x=1, aa_y=1,
                       shadow_samples=1, bounces=0)
    eps = 1e-3

    def state_at(dz):
        """(obj ids, shadow-sample occlusion) at a camera z offset — the two
        discrete decisions whose flips make plain FD meaningless."""
        s = dataclasses.replace(
            scene, camera_pos=scene.camera_pos + jnp.array([0, 0, dz]))
        ds = prepare_scene(s)
        dirs, gid = gen_primary_rays(cfg, s.yaw, s.pitch)
        d = dirs.reshape(-1, 3)
        start = jnp.broadcast_to(ds.camera_pos, (d.shape[0], 3))
        h = intersect(ds, start, d)
        sdir = ds.light_pos[None] - h.pos
        sstart = h.pos + jnp.float32(cfg.bias) * sdir
        r2 = dot3(sdir, sdir)
        st = xorshift(shadow_seed(gid.reshape(-1)))
        occ = in_shadow(ds, sstart, sdir + crush(st, cfg.light_spread), r2)
        return np.asarray(h.obj_id), np.asarray(occ)

    # Stability must hold at the FD evaluation points themselves: if the
    # discrete state agrees at -eps, 0, +eps then f(+-eps) lie on the same
    # smooth branch and the FD equals the interior derivative.
    i_m, o_m = state_at(-eps)
    i_0, o_0 = state_at(0.0)
    i_p, o_p = state_at(eps)
    stable = (i_m == i_0) & (i_0 == i_p) & (o_m == o_0) & (o_0 == o_p)
    mask = jnp.asarray(stable)

    from uob_raytracer_tpu.ops.shading import direct_light

    def masked_loss(s):
        ds = prepare_scene(s)
        dirs, gid = gen_primary_rays(cfg, s.yaw, s.pitch)
        d = dirs.reshape(-1, 3)
        start = jnp.broadcast_to(ds.camera_pos, (d.shape[0], 3))
        gidf = jnp.repeat(gid.reshape(-1), 1)
        h = intersect(ds, start, d)
        dl = direct_light(ds, cfg, h.pos, h.normal, gidf)
        col = h.rgb * (ds.indirect[None] + dl)
        col = jnp.where((h.hit & (h.mat > 0) & mask)[:, None], col, 0.0)
        return jnp.mean(col)

    auto = float(jax.grad(lambda s: masked_loss(s))(scene).camera_pos[2])

    def at(dz):
        s = dataclasses.replace(
            scene, camera_pos=scene.camera_pos + jnp.array([0, 0, dz]))
        return float(masked_loss(s))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert auto == pytest.approx(fd, rel=0.1, abs=1e-6)


def test_grads_finite_everywhere(scene):
    # Full-feature config incl. spheres, bounces, fresnel: no NaN/inf grads.
    cfg = RenderConfig(width=16, height=16, shadow_samples=3, bounces=4,
                       fresnel=True)
    def loss(s):
        return jnp.mean(render_image(s, cfg, chunk_rows=16))
    g = jax.grad(loss)(scene)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_quirk_mode_grads_finite(scene):
    cfg = RenderConfig(width=16, height=16, shadow_samples=2, bounces=3,
                       quirk_nan_tir=True)
    def loss(s):
        return jnp.mean(render_image(s, cfg, chunk_rows=16))
    g = jax.grad(loss)(scene)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_tangent_ray_sphere_grads_finite():
    """Exact-tangent sphere hits (disc == 0 — representable at f32, and
    observed in the wild at 1024^2) must not leak sqrt'(0) = inf into the
    sphere-quadratic gradients (regression: ops/intersect._sphere_roots,
    replay._hit_from_row)."""
    from uob_raytracer_tpu.ops.intersect import _sphere_roots, prepare_scene

    scene = cornell_box()
    # start=(0,0,-2), d=(0,0,1), center=(1,0,0), r2=1: disc = 16-16 = 0
    sc = dataclasses.replace(
        scene,
        sph_center=jnp.array([[1.0, 0.0, 0.0]], jnp.float32),
        sph_r2=jnp.array([1.0], jnp.float32),
        sph_rgb=jnp.ones((1, 3), jnp.float32),
        sph_mat=jnp.ones((1,), jnp.float32))
    start = jnp.array([[0.0, 0.0, -2.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)

    def root(r2):
        ds = prepare_scene(dataclasses.replace(
            sc, sph_r2=jnp.array([r2], jnp.float32)))
        xmin, xmax, no_sol = _sphere_roots(ds, start, d)
        return jnp.sum(jnp.where(no_sol, 0.0, xmin))

    v, g = jax.value_and_grad(root)(jnp.float32(1.0))
    assert np.isfinite(float(v)) and np.isfinite(float(g)), (v, g)


def test_vertex_grad_flows_through_normals(scene):
    # Moving a wall vertex changes its normal and thus the Lambert term:
    # with hard geometry but soft shading the vertex gradient must be
    # nonzero even for rays that keep hitting the same triangle.
    g = jax.grad(_loss)(scene)
    assert np.abs(np.asarray(g.tri_v0)).max() > 1e-6
    assert np.abs(np.asarray(g.tri_v1)).max() > 1e-6
