"""Fused-kernel tests: Pallas-interpreter equivalence against the jnp
pipeline (the kernel's semantic twin), pad/crop behaviour, feature flags,
large scenes, and the platform rule that picks the backend. The compiled
kernel runs in the ``gpu``-marked test on the card."""
import jax
import numpy as np
import pytest

from uob_raytracer_tpu import RenderConfig, cornell_box
from uob_raytracer_tpu.kernels import render_fused
from uob_raytracer_tpu.render import _render_image_jnp


@pytest.fixture(scope="module")
def scene():
    return cornell_box()


def _compare(scene, cfg, tol=2e-5, frac=0.002, interpret=True, quads=None):
    img = render_fused(scene, cfg, interpret=interpret, quads=quads)
    ref = _render_image_jnp(scene, cfg, chunk_rows=cfg.height)
    d = np.abs(np.asarray(img) - np.asarray(ref)).max(-1)
    assert (d > tol).mean() <= frac, (
        f"{(d > tol).mean():.4%} pixels differ (max {d.max():.5f})")
    return np.asarray(img)


def test_full_pipeline_small(scene):
    img = _compare(scene, RenderConfig(width=128, height=16))
    assert img.shape == (16, 128, 3)
    assert img.max() > 0.3


def test_pad_and_crop(scene):
    # 96 wide: the kernel pads to whole blocks and crops; RNG pixel ids use
    # the logical width so the shadow noise matches the jnp path exactly.
    img = _compare(scene, RenderConfig(width=96, height=20,
                                       shadow_samples=6, bounces=3))
    assert img.shape == (20, 96, 3)


def test_no_bounces(scene):
    _compare(scene, RenderConfig(width=128, height=16, bounces=0))


def test_quirk_tir(scene):
    _compare(scene, RenderConfig(width=128, height=16, quirk_nan_tir=True))


def test_fresnel(scene):
    # Glass-path pixels accumulate sub-1e-4 rounding differences through the
    # refraction chain (compilation-order effects), so the tight threshold
    # flags a few extra pixels; bound them by magnitude instead.
    cfg = RenderConfig(width=128, height=16, fresnel=True, bounces=4)
    img = render_fused(scene, cfg, interpret=True)
    ref = _render_image_jnp(scene, cfg, chunk_rows=16)
    d = np.abs(np.asarray(img) - np.asarray(ref)).max(-1)
    assert (d > 5e-4).mean() <= 0.002, f"max {d.max():.5f}"


def test_no_spheres():
    sc = cornell_box(spheres=False)
    _compare(sc, RenderConfig(width=128, height=16, bounces=0))


def test_cpu_ref_fused(scene):
    """cpu_ref through the fused kernel == the jnp cpu_ref pipeline — on a
    scene WITH spheres, which cpu_ref must ignore (the vestigial CPU path
    predates them, skeleton.cpp:184-279)."""
    _compare(scene, RenderConfig(width=128, height=16, cpu_ref=True))


def test_aa_count_not_power_of_two(scene):
    """3x1 AA: the kernel pads the AA axis to 4 rays per pixel and masks
    the padding ray out of the average."""
    _compare(scene, RenderConfig(width=64, height=8, aa_x=3, aa_y=1,
                                 shadow_samples=2, bounces=2))


def test_backend_dispatch(scene):
    # On the CPU test backend, auto resolves to jnp; explicit pallas with
    # interpret is exercised above. Just check the public API runs.
    from uob_raytracer_tpu.render import render
    out = render(scene, RenderConfig(width=128, height=16, bounces=1,
                                     shadow_samples=2))
    assert np.asarray(out.image).shape == (16, 128, 3)


@pytest.mark.parametrize("platform,expected", [
    ("gpu", "pallas"), ("cpu", "jnp"), ("tpu", None)])
def test_backend_follows_platform(monkeypatch, platform, expected):
    """'auto' picks the compiled kernel on a GPU and jnp on the CPU; any
    other platform has no backend and raises, naming it."""
    from uob_raytracer_tpu.render import resolve_backend
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expected is None:
        with pytest.raises(ValueError, match=platform):
            resolve_backend("auto")
    else:
        assert resolve_backend("auto") == expected
        assert resolve_backend("jnp") == "jnp"     # explicit choice kept


def test_pallas_off_gpu_needs_interpret(scene):
    """The kernel is never interpreted unless the caller asks: on the CPU a
    compiled launch raises instead of falling back."""
    from uob_raytracer_tpu.render import render_image
    cfg = RenderConfig(width=16, height=8, aa_x=1, aa_y=1,
                       shadow_samples=1, bounces=0)
    with pytest.raises(ValueError, match="interpret"):
        render_image(scene, cfg, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        render_image(scene, cfg, backend="mosaic")


def test_compiled_kernel_divides_with_ieee_rounding(monkeypatch, scene):
    """The kernel as lowered for the GPU divides and takes square roots
    with IEEE rounding (PTX div.rn / sqrt.rn), never through Triton's
    approximate f32 ``/`` and sqrt, which flip marginal hit and shadow
    tests against the oracle on the card."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = RenderConfig(width=64, height=8, shadow_samples=2, bounces=2,
                       fresnel=True)
    text = jax.jit(lambda s: render_fused(s, cfg)).trace(scene).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "div.rn.f32" in text and "sqrt.rn.f32" in text
    assert "divf" not in text and "__nv_sqrtf" not in text


# --------------------------------------------------------------------------
# Large scenes: the same looped scans over a table padded to a power-of-two
# row count
# --------------------------------------------------------------------------

def _dense_scene(n_tri: int, seed: int = 1):
    """Cornell box + random small diffuse triangles inside it."""
    from uob_raytracer_tpu.scene import add_triangles
    base = cornell_box()
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


def test_streamed_large_scene():
    # 600 triangles: the scans must match the jnp pipeline like the
    # Cornell-sized cases do.
    sc = _dense_scene(600)
    assert sc.tri_v0.shape[0] == 600
    _compare(sc, RenderConfig(width=128, height=16, shadow_samples=2,
                              bounces=2))


def test_streamed_occlusion_with_quads():
    """The quad/triangle occlusion scan with a pairing on a large scene:
    the dense scene's Cornell walls pair, so both accept tests run — must
    match the jnp pipeline."""
    from uob_raytracer_tpu.ops.quads import detect_shadow_quads

    sc = _dense_scene(600)
    q = detect_shadow_quads(sc)
    assert q is not None and len(q[0]) > 0     # walls pair
    cfg = RenderConfig(width=128, height=16, aa_x=1, aa_y=1,
                       shadow_samples=3, bounces=1)
    _compare(sc, cfg, quads=q)


def test_streamed_pad_rows_inert():
    # 600 triangles pad to a 1024-row table: the zero pad rows must never
    # win a hit or occlude — the image equals the jnp render's.
    from uob_raytracer_tpu.kernels.render_fwd import _pow2
    sc = _dense_scene(600)
    assert _pow2(int(sc.tri_v0.shape[0])) != int(sc.tri_v0.shape[0])
    _compare(sc, RenderConfig(width=128, height=8, shadow_samples=1,
                              bounces=0))


def test_streamed_replay_gradient():
    # Residuals from the large-scene kernel drive the same path-replay
    # backward; check against autodiff of the jnp pipeline.
    import jax.numpy as jnp
    from uob_raytracer_tpu.kernels.render_fwd import render_fused_res
    from uob_raytracer_tpu.ops.replay import replay_forward

    sc = _dense_scene(600)
    # aa1: the AA axis is covered by the Cornell cases; at 600 triangles the
    # jnp-autodiff reference is the cost driver (O(rays x tris))
    cfg = RenderConfig(width=128, height=8, aa_x=1, aa_y=1,
                       shadow_samples=2, bounces=2)
    _, res = render_fused_res(sc, cfg, interpret=True)
    g_replay = jax.grad(
        lambda s: jnp.mean(replay_forward(s, cfg, res)))(sc)
    g_auto = jax.grad(lambda s: jnp.mean(_render_image_jnp(s, cfg)))(sc)
    for name in ("light_pos", "light_color", "tri_rgb", "sph_center"):
        a = np.asarray(getattr(g_replay, name))
        b = np.asarray(getattr(g_auto, name))
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-4, err_msg=name)


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp(scene):
    """The kernel as Triton compiles it, against the jnp pipeline on the
    host CPU, with and without the quad table. The host's XLA divides and
    takes square roots with IEEE rounding like the kernel (the card's XLA
    does not). Boundary-aware tolerance: FMA contraction on the host still
    flips marginal visibility tests on a few edge pixels."""
    from conftest import assert_images_match
    from uob_raytracer_tpu.ops.quads import detect_shadow_quads
    cfg = RenderConfig(width=256, height=64)
    ref = jax.jit(lambda s: _render_image_jnp(s, cfg))(
        jax.device_put(scene, jax.devices("cpu")[0]))
    for quads in (None, detect_shadow_quads(scene)):
        img = render_fused(scene, cfg, quads=quads)
        assert_images_match(img, ref, what=f"compiled kernel quads={quads}")
