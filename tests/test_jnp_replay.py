"""The plain jnp forward that records the fused kernel's decisions
(``render.render_flat_res``, the path-replay custom_vjp's "xla" route): its
residuals equal the kernel's, and the replay VJP driven by them equals jnp
autodiff."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uob_raytracer_tpu import RenderConfig, cornell_box
from uob_raytracer_tpu.kernels.render_fwd import render_fused_res
from uob_raytracer_tpu.render import (_render_replay, render_flat_res,
                                      render_image)


@pytest.fixture(scope="module")
def scene():
    return cornell_box()


_RES_CFGS = {
    "b0": RenderConfig(width=64, height=8, shadow_samples=3, bounces=0),
    "b2": RenderConfig(width=64, height=8, shadow_samples=3, bounces=2),
    "fresnel": RenderConfig(width=64, height=8, shadow_samples=3, bounces=4,
                            fresnel=True),
    "cpu_ref": RenderConfig(width=64, height=8, cpu_ref=True),
}


@pytest.mark.parametrize("name", list(_RES_CFGS))
def test_jnp_residuals_match_kernel(scene, name):
    """The plain jnp forward records the kernel's decisions: the same
    object ids per bounce (-1 once a ray has ended), the same lit counts
    (0 where a ray has no shading point), and the same image."""
    cfg = _RES_CFGS[name]
    img_k, res_k = render_fused_res(scene, cfg, interpret=True)
    img_j, res_j = render_flat_res(scene, cfg)
    for f in res_k._fields:
        a = np.asarray(getattr(res_k, f))
        b = np.asarray(getattr(res_j, f))
        assert a.shape == b.shape, f
        assert a.size == 0 or (a != b).mean() <= 0.005, f
    np.testing.assert_allclose(np.asarray(img_j), np.asarray(img_k),
                               atol=2e-4)


@pytest.mark.parametrize("cfg", [
    RenderConfig(width=32, height=8, shadow_samples=3, bounces=2),
    RenderConfig(width=32, height=8, shadow_samples=3, bounces=4,
                 fresnel=True),
    RenderConfig(width=32, height=8, aa_x=1, aa_y=1, shadow_samples=2,
                 bounces=3, quirk_nan_tir=True),
], ids=["b2", "fresnel", "quirk_tir"])
def test_jnp_replay_grads_match_autodiff(scene, cfg):
    """The "xla" replay route (jnp forward recording the decisions, the
    replay VJP) == autodiff of the jnp pipeline, on every Scene leaf."""
    g_r = jax.grad(lambda s: jnp.mean(_render_replay(
        s, cfg, jnp.int32(0), cfg.height, "xla")))(scene)
    g_f = jax.grad(lambda s: jnp.mean(render_image(s, cfg, backend="jnp")))(
        scene)
    for f in dataclasses.fields(g_r):
        a = np.asarray(getattr(g_r, f.name))
        b = np.asarray(getattr(g_f, f.name))
        scale = np.abs(b).max() + 1e-12
        assert np.abs(a - b).max() / scale < 2e-3, f.name
        assert np.isfinite(a).all(), f.name
