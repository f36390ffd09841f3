"""Camera model: yaw/pitch rotation and supersampled primary-ray generation.

The rotation matrix is built *inside* the traced graph from the scene's
yaw/pitch scalars (differentiable), unlike the reference which rebuilds it on
the host every frame and uploads it (``Source/skeleton.cpp:149-157``).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import RenderConfig
from .math3 import normalize3


def rotation_matrix(yaw, pitch):
    """Row-major yaw*pitch rotation, rows r0..r2 as ``skeleton.cpp:149-151``;
    a direction d maps to (r0.d, r1.d, r2.d) (``kernels.cl:398-400``)."""
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    z = jnp.zeros_like(cy)
    return jnp.stack([
        jnp.stack([cy, sp * sy, sy * cp]),
        jnp.stack([z, cp, -sp]),
        jnp.stack([-sy, cy * sp, cp * cy]),
    ])


def gen_primary_rays(cfg: RenderConfig, yaw, pitch):
    """Primary ray directions [H, W, A, 3] (normalized unless cpu_ref) and
    pixel ids [H, W] (uint32).

    GPU path (``kernels.cl:384-407``): the pixel grid is virtually
    supersampled by the AA grid — base = (x*ax - W*ax/2, y*ay - H*ay/2,
    focal), AA ray (dx, dy) adds (dx, dy, 0) — then rotated and normalized.
    CPU-ref mode (``skeleton.cpp:259``): one ray (x - W/2, y - H/2, focal),
    rotated, left unnormalized.
    """
    W, H = cfg.width, cfg.height
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    focal = jnp.float32(cfg.effective_focal)
    if cfg.cpu_ref:
        bx = xs - jnp.float32(W / 2.0)
        by = ys - jnp.float32(H / 2.0)
        offs = jnp.zeros((1, 2), dtype=jnp.float32)
    else:
        ax, ay = cfg.aa_x, cfg.aa_y
        bx = xs * jnp.float32(ax) - jnp.float32(W * ax / 2.0)
        by = ys * jnp.float32(ay) - jnp.float32(H * ay / 2.0)
        offs = jnp.array([[dx, dy] for dy in range(ay) for dx in range(ax)],
                         dtype=jnp.float32)
    # [H, W, A, 3] before rotation
    a = offs.shape[0]
    dirs = jnp.stack([
        jnp.broadcast_to(bx[:, :, None], (H, W, a)) + offs[None, None, :, 0],
        jnp.broadcast_to(by[:, :, None], (H, W, a)) + offs[None, None, :, 1],
        jnp.full((H, W, a), focal),
    ], axis=-1)
    R = rotation_matrix(yaw, pitch)
    # Rotate with explicit multiply-adds — NOT einsum/matmul, which XLA
    # may run on reduced-precision matrix units (TF32 on the GPU),
    # losing the f32 precision the intersection tests depend on.
    dirs = jnp.stack([
        jnp.sum(R[0] * dirs, axis=-1),
        jnp.sum(R[1] * dirs, axis=-1),
        jnp.sum(R[2] * dirs, axis=-1),
    ], axis=-1)
    if not cfg.cpu_ref:
        dirs = normalize3(dirs)
    gid = (jnp.arange(H, dtype=jnp.uint32)[:, None] * jnp.uint32(W)
           + jnp.arange(W, dtype=jnp.uint32)[None, :])
    return dirs, gid
