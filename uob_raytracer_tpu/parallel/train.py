"""Differentiable rendering as a training loop: the piece the reference
never had. Fits scene parameters (vertices, materials, light, camera) to a
target image by gradient descent through the sharded renderer.

Pixel rows are sharded over devices and the scene is replicated; the
backward pass's parameter gradients are all-reduced by the psum that the
shard_map transpose inserts.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..config import RenderConfig
from ..scene import Scene
from .render import render_image_sharded

# Scene leaves that may receive gradient updates in the demo optimizer.
# (Vertices, materials, light and camera — the BASELINE config-5 parameter
# set. Pass a subset to train_step for well-conditioned fits: a single SGD
# learning rate across parameter types is rarely appropriate.)
TRAINABLE = ("tri_v0", "tri_v1", "tri_v2", "tri_rgb", "light_pos",
             "light_color", "camera_pos", "yaw", "pitch")


def image_loss(scene: Scene, target: jax.Array, cfg: RenderConfig,
               mesh: Mesh, backend: str = "auto",
               shadow_quads=None, interpret: bool = False) -> jax.Array:
    """MSE against a target image through the sharded renderer.

    shadow_quads: static quad pairing for the pallas occlusion scan.
    Training paths that move vertices must NOT pass a pairing detected on
    the pre-update geometry (render_image_sharded validates and raises on
    stale pairings when the scene is concrete; traced scenes cannot be
    checked) — light/material-only fits may pass one safely."""
    img = render_image_sharded(scene, cfg, mesh, backend=backend,
                               shadow_quads=shadow_quads, interpret=interpret)
    return jnp.mean(jnp.square(img - target))


class TrainOut(NamedTuple):
    scene: Scene
    loss: jax.Array


@functools.partial(jax.jit,
                   static_argnames=("cfg", "mesh", "lr", "trainable",
                                    "backend"))
def train_step(scene: Scene, target: jax.Array, cfg: RenderConfig,
               mesh: Mesh, lr: float = 1e-2,
               trainable: tuple[str, ...] = TRAINABLE,
               backend: str = "auto") -> TrainOut:
    """One SGD step on the selected scene leaves."""
    loss, grads = jax.value_and_grad(image_loss)(scene, target, cfg, mesh,
                                                 backend)

    def update(path, p, g):
        name = path[0].name if hasattr(path[0], "name") else str(path[0])
        if name in trainable:
            return p - jnp.float32(lr) * g
        return p

    new_scene = jax.tree_util.tree_map_with_path(update, scene, grads)
    return TrainOut(scene=new_scene, loss=loss)


# The BASELINE config-5 parameter set with per-leaf Adam learning rates:
# a single global SGD rate cannot fit vertices (grads ~1e-3), materials
# (~1e-1) and light intensity (~1e-3, scale 16) at once.
DEFAULT_LRS = {
    "light_pos": 2e-2,
    "tri_rgb": 2e-2,
    "tri_v0": 5e-3,
    "tri_v1": 5e-3,
    "tri_v2": 5e-3,
}


def fit(scene: Scene, target: jax.Array, cfg: RenderConfig, mesh: Mesh,
        steps: int = 60, lrs: dict[str, float] | None = None,
        backend: str = "auto", log_every: int = 0, eps: float = 1e-3):
    """Multi-parameter scene recovery: per-leaf Adam on the selected Scene
    leaves through the sharded differentiable renderer (gradients psum'd by
    the shard_map transpose). Returns (fitted scene, loss history).

    ``lrs`` maps leaf name -> Adam learning rate; leaves not named are
    frozen. The default set is the BASELINE config-5 parameters (vertices +
    materials + light). ``eps`` is deliberately large (1e-3, not Adam's
    1e-8): leaves with near-zero gradients (e.g. vertices of triangles the
    loss barely sees) would otherwise get full-size normalized steps in
    noise directions and walk the geometry apart."""
    try:
        import optax
    except ImportError as e:   # declared as the [fit] extra, not core
        raise ImportError(
            "fit() needs optax — install with `pip install "
            "uob-raytracer-tpu[fit]` (or `pip install optax`)") from e

    lrs = dict(DEFAULT_LRS if lrs is None else lrs)

    def label(path, _):
        name = path[0].name if hasattr(path[0], "name") else str(path[0])
        return name if name in lrs else "_frozen"

    labels = jax.tree_util.tree_map_with_path(label, scene)
    tx = optax.multi_transform(
        {**{k: optax.adam(v, eps=eps) for k, v in lrs.items()},
         "_frozen": optax.set_to_zero()}, labels)
    opt_state = tx.init(scene)

    @functools.partial(jax.jit, static_argnames=("cfg", "mesh", "backend"))
    def step(scene, opt_state, target, cfg, mesh, backend):
        loss, grads = jax.value_and_grad(image_loss)(scene, target, cfg,
                                                     mesh, backend)
        updates, opt_state = tx.update(grads, opt_state, scene)
        return optax.apply_updates(scene, updates), opt_state, loss

    losses = []
    for i in range(steps):
        scene, opt_state, loss = step(scene, opt_state, target, cfg, mesh,
                                      backend)
        losses.append(float(loss))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"fit step {i:3d}  loss {losses[-1]:.6f}")
    return scene, losses
