"""Distributed tests on the 8-virtual-CPU-device mesh (SURVEY.md §4):
sharded render == single-device render; triangle (tp) sharding == replicated;
gradients through shard_map match unsharded gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uob_raytracer_tpu import RenderConfig, cornell_box, render
from uob_raytracer_tpu.parallel import (
    make_mesh, pad_triangles, render_image_sharded, train_step, image_loss,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

CFG = RenderConfig(width=64, height=64, aa_x=2, aa_y=2, shadow_samples=4,
                   bounces=3)


@pytest.fixture(scope="module")
def scene():
    return cornell_box()


def test_dp_sharded_matches_single(scene):
    # Sharded and single-device renders are separately compiled XLA programs:
    # different fusion choices mean different FMA contraction, which can flip
    # marginal visibility comparisons — so boundary-aware comparison, exactly
    # as against the NumPy oracle.
    from conftest import assert_images_match
    mesh = make_mesh(dp=8, tp=1)
    img_s = np.asarray(jax.jit(render_image_sharded,
                               static_argnames=("cfg", "mesh"))(scene, CFG, mesh))
    img_1 = np.asarray(render(scene, CFG, chunk_rows=CFG.height).image)
    assert_images_match(img_s, img_1, tight=1e-6, outlier_frac=0.01,
                        what="dp-sharded vs single")


def test_dp_sharded_pallas_matches_single(scene):
    """The production multi-device path: fused kernel per dp shard
    (row-band launch, Pallas interpreter on the CPU mesh) == the
    single-device fused kernel."""
    from conftest import assert_images_match
    mesh = make_mesh(dp=8, tp=1)    # 64 rows / 8 shards = 8-row bands
    img_s = np.asarray(jax.jit(
        render_image_sharded,
        static_argnames=("cfg", "mesh", "backend", "interpret"))(
            scene, CFG, mesh, backend="pallas", interpret=True))
    img_1 = np.asarray(render(scene, CFG, backend="pallas",
                              interpret=True).image)
    # same kernel, same math, different launch geometry: exact equality up
    # to boundary flips from the padded-canvas crop
    assert_images_match(img_s, img_1, tight=1e-6, outlier_frac=0.01,
                        what="dp-sharded pallas vs single pallas")


def test_dp_sharded_pallas_quads_matches_single(scene):
    """The dp-sharded launch with the quad-merged occlusion table — the
    headline-kernel configuration — matches the single-device quad-merged
    render: the multi-device path runs the same kernel."""
    from conftest import assert_images_match
    from uob_raytracer_tpu.ops.quads import detect_shadow_quads
    q = detect_shadow_quads(scene)
    assert q is not None
    mesh = make_mesh(dp=8, tp=1)
    img_s = np.asarray(jax.jit(
        render_image_sharded,
        static_argnames=("cfg", "mesh", "backend", "shadow_quads",
                         "interpret"))(
            scene, CFG, mesh, backend="pallas", shadow_quads=q,
            interpret=True))
    img_1 = np.asarray(render(scene, CFG, backend="pallas",
                              shadow_quads=q, interpret=True).image)
    assert_images_match(img_s, img_1, tight=1e-6, outlier_frac=0.01,
                        what="dp-sharded pallas+quads vs single")


def test_sharded_pallas_quads_grads_match(scene):
    """Gradients through the dp-sharded quad-merged path == no-quads path
    (the pairing only changes the frozen occlusion counts' computation)."""
    cfg = RenderConfig(width=32, height=32, aa_x=1, aa_y=1,
                       shadow_samples=2, bounces=1)
    from uob_raytracer_tpu.ops.quads import detect_shadow_quads
    q = detect_shadow_quads(scene)
    mesh = make_mesh(dp=4, tp=1)
    target = jnp.zeros((32, 32, 3), jnp.float32)
    run = jax.jit(jax.grad(image_loss),
                  static_argnames=("cfg", "mesh", "backend", "shadow_quads",
                                   "interpret"))
    g_q = run(scene, target, cfg, mesh, backend="pallas", shadow_quads=q,
              interpret=True)
    g_n = run(scene, target, cfg, mesh, backend="pallas", shadow_quads=None,
              interpret=True)
    for name in ("light_pos", "light_color", "tri_v0", "tri_rgb", "yaw"):
        np.testing.assert_allclose(
            np.asarray(getattr(g_q, name)), np.asarray(getattr(g_n, name)),
            rtol=1e-4, atol=1e-6, err_msg=name)


def test_sharded_pallas_grads_match_unsharded(scene):
    """Gradients through the sharded pallas path (fused fwd kernel + replay
    VJP + shard_map-transpose psum) == the unsharded pallas-path gradients."""
    from uob_raytracer_tpu.render import render_image
    cfg = RenderConfig(width=32, height=32, aa_x=1, aa_y=1,
                       shadow_samples=2, bounces=1)
    mesh = make_mesh(dp=4, tp=1)    # 8 rows per shard
    target = jnp.zeros((32, 32, 3), jnp.float32)

    def loss_single(s):
        img = render_image(s, cfg, backend="pallas", interpret=True)
        return jnp.mean(jnp.square(img - target))

    g_sharded = jax.jit(
        jax.grad(image_loss),
        static_argnames=("cfg", "mesh", "backend", "interpret"))(
            scene, target, cfg, mesh, backend="pallas", interpret=True)
    g_single = jax.grad(loss_single)(scene)
    for name in ("light_pos", "light_color", "tri_v0", "tri_rgb",
                 "camera_pos", "yaw"):
        np.testing.assert_allclose(
            np.asarray(getattr(g_sharded, name)),
            np.asarray(getattr(g_single, name)),
            rtol=1e-4, atol=1e-6, err_msg=name)
    assert np.abs(np.asarray(g_sharded.light_pos)).max() > 0
    assert np.abs(np.asarray(g_sharded.tri_v0)).max() > 0


def test_tp_sharded_matches_replicated(scene):
    from conftest import assert_images_match
    mesh = make_mesh(dp=2, tp=4)
    padded = pad_triangles(scene, 4)          # 26 -> 28 triangles
    img_tp = np.asarray(jax.jit(render_image_sharded,
                                static_argnames=("cfg", "mesh"))(padded, CFG, mesh))
    img_1 = np.asarray(render(scene, CFG, chunk_rows=CFG.height).image)
    assert_images_match(img_tp, img_1, tight=1e-5, outlier_frac=0.01,
                        what="tp-sharded vs replicated")


def test_padding_is_invisible(scene):
    padded = pad_triangles(scene, 16)         # 26 -> 32, degenerate pad
    img_p = np.asarray(render(padded, CFG).image)
    img = np.asarray(render(scene, CFG).image)
    np.testing.assert_allclose(img_p, img, atol=1e-6)


def test_sharded_grads_match_unsharded(scene):
    cfg = RenderConfig(width=32, height=32, aa_x=1, aa_y=1,
                       shadow_samples=2, bounces=1)
    mesh = make_mesh(dp=8, tp=1)
    target = jnp.zeros((32, 32, 3), jnp.float32)

    def loss_unsharded(s):
        img = render(s, cfg, chunk_rows=32).image
        return jnp.mean(jnp.square(img - target))

    g_sharded = jax.jit(jax.grad(image_loss),
                        static_argnames=("cfg", "mesh"))(scene, target, cfg, mesh)
    g_single = jax.grad(loss_unsharded)(scene)
    for name in ("light_pos", "tri_v0", "tri_rgb", "camera_pos"):
        np.testing.assert_allclose(
            np.asarray(getattr(g_sharded, name)),
            np.asarray(getattr(g_single, name)),
            atol=1e-5, err_msg=name)
    # Gradients are nonzero where they should be
    assert np.abs(np.asarray(g_sharded.light_pos)).max() > 0
    assert np.abs(np.asarray(g_sharded.tri_rgb)).max() > 0


def test_train_step_reduces_loss(scene):
    cfg = RenderConfig(width=32, height=32, aa_x=1, aa_y=1,
                       shadow_samples=2, bounces=0)
    mesh = make_mesh(dp=8, tp=1)
    # Target: the same scene with the light moved; fitting should reduce loss.
    target_scene = dataclasses.replace(
        scene, light_pos=jnp.array([0.3, -0.5, -0.7]))
    target = render_image_sharded(target_scene, cfg, mesh)
    s, losses = scene, []
    for _ in range(5):
        s, loss = train_step(s, target, cfg, mesh, lr=0.5,
                             trainable=("light_pos",))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    # the light should have moved toward the target x=0.3
    assert float(s.light_pos[0]) > 0.02


@pytest.mark.slow   # optimizer demo (~2 min); scripts/test.sh runs slow
def test_fit_recovers_multi_parameter_scene(scene):
    """BASELINE config-5 fit: per-leaf Adam recovers all three parameter
    types through the sharded renderer — light position + a wall color
    jointly, and a vertex perturbation (back wall moved along z, a
    shading-coupled change the interior gradient identifies).

    The limits are deliberate and documented: pure silhouette moves (e.g. a
    block slide) are invisible to frozen-visibility gradients (SURVEY.md
    §7), and a one-image joint fit of color AND geometry of the same
    surface is degenerate (either explains the brightness residual), so
    geometry is recovered in its own fit."""
    from uob_raytracer_tpu.parallel import fit
    cfg = RenderConfig(width=48, height=48, aa_x=1, aa_y=1,
                       shadow_samples=2, bounces=0)
    mesh = make_mesh(dp=8, tp=1)

    # --- light position + left-wall color, jointly ---
    t1 = dataclasses.replace(
        scene,
        light_pos=jnp.array([0.25, -0.5, -0.7]),
        tri_rgb=scene.tri_rgb.at[2:4].set(jnp.float32([0.9, 0.5, 0.2])))
    target1 = render_image_sharded(t1, cfg, mesh)
    f1, losses1 = fit(scene, target1, cfg, mesh, steps=40,
                      lrs={"light_pos": 2e-2, "tri_rgb": 2e-2})
    assert losses1[-1] < 0.35 * losses1[0], losses1[::10]
    assert float(f1.light_pos[0]) > 0.1               # from 0.0 toward 0.25
    d0 = float(jnp.abs(scene.tri_rgb[2] - t1.tri_rgb[2]).sum())
    d1 = float(jnp.abs(f1.tri_rgb[2] - t1.tri_rgb[2]).sum())
    assert d1 < 0.3 * d0

    # --- back-wall z shift (vertex recovery) ---
    dv = jnp.zeros_like(scene.tri_v0).at[8:10].add(
        jnp.float32([0.0, 0.0, 0.15]))
    t2 = dataclasses.replace(scene, tri_v0=scene.tri_v0 + dv,
                             tri_v1=scene.tri_v1 + dv,
                             tri_v2=scene.tri_v2 + dv)
    target2 = render_image_sharded(t2, cfg, mesh)
    f2, losses2 = fit(scene, target2, cfg, mesh, steps=60,
                      lrs={"tri_v0": 5e-3, "tri_v1": 5e-3, "tri_v2": 5e-3})
    assert losses2[-1] < 0.35 * losses2[0], losses2[::10]
    dz = float((f2.tri_v0[8:10, 2] - scene.tri_v0[8:10, 2]).mean())
    assert dz > 0.05                                  # toward +0.15


def test_multihost_single_process_noop(monkeypatch):
    from uob_raytracer_tpu.parallel import initialize_multihost
    monkeypatch.delenv("RAYTPU_COORDINATOR", raising=False)
    assert initialize_multihost() is False
