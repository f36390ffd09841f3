"""Device meshes for the ray tracer.

The reference is single-device: its only parallelism is SPMD over pixels on
one GPU (``Source/skeleton.cpp:170-172``, 1024x1024 NDRange in 128x4 groups),
and its only "communication" is host<->device buffer traffic. Here scaling is
expressed as a ``jax.sharding.Mesh`` plus ``shard_map``:

* ``dp`` (data parallel): pixel rows sharded across devices; the scene is
  replicated, mirroring the reference's per-work-group local-memory copy of
  the whole scene (``kernels.cl:374-376``).
* ``tp`` (tensor parallel): the triangle axis sharded across devices for
  scenes too large to replicate; nearest-hit results are combined with
  pmin/psum collectives (see ops/intersect.py).

The devices of one host are joined all to all, so the mesh follows the
algorithm alone: every selected device on dp unless tp is asked for.

PP/SP/EP have no analogue in a per-pixel ray tracer and are deliberately
absent (SURVEY.md §2f): the bounce chain is the only sequential dimension and
it stays local to each ray.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh

from ..scene import Scene


def select_devices(spec: str | None = None, verbose: bool = False):
    """Device selection — the ``OCL_DEVICE`` analogue
    (``Source/skeleton.cpp:549-558``): ``spec`` (or the ``RAYTPU_DEVICES``
    env var) is a comma-separated list of device indices into
    ``jax.devices()``; unset selects all. ``verbose`` prints the enumerated
    device list like the reference's ``selectOpenCLDevice``
    (``skeleton.cpp:541-547``)."""
    import os
    devices = jax.devices()
    if verbose:
        for i, d in enumerate(devices):
            print(f"  device {i}: {d}")
    spec = spec if spec is not None else os.environ.get("RAYTPU_DEVICES")
    if not spec:
        return devices
    idx = [int(s) for s in spec.split(",") if s.strip() != ""]
    bad = [i for i in idx if not 0 <= i < len(devices)]
    if bad:   # fail fast, as the reference's device-index validation does
        raise ValueError(f"device indices {bad} out of range "
                         f"(have {len(devices)} devices)")
    if len(set(idx)) != len(idx):
        # a repeated index would otherwise surface as an obscure Mesh
        # construction failure far from the user's typo
        dup = sorted({i for i in idx if idx.count(i) > 1})
        raise ValueError(f"duplicate device indices {dup} in spec {spec!r}")
    return [devices[i] for i in idx]


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """Build a ('dp', 'tp') mesh. Defaults: every selected device on dp
    (``select_devices`` honors the RAYTPU_DEVICES env var)."""
    if devices is None:
        devices = select_devices()
    if dp is None:
        dp = len(devices) // tp
    n = dp * tp
    if n > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def pad_triangles(scene: Scene, multiple: int) -> Scene:
    """Pad the triangle axis to a multiple (for even tp sharding) with
    degenerate triangles: zero-area (all vertices coincident) so every
    intersection test rejects them (detA == 0), diffuse material so the
    glass-skip shadow rule is unaffected."""
    t = scene.tri_v0.shape[0]
    pad = (-t) % multiple
    if pad == 0:
        return scene
    import jax.numpy as jnp
    zpad3 = jnp.zeros((pad, 3), scene.tri_v0.dtype)
    return dataclasses.replace(
        scene,
        tri_v0=jnp.concatenate([scene.tri_v0, zpad3]),
        tri_v1=jnp.concatenate([scene.tri_v1, zpad3]),
        tri_v2=jnp.concatenate([scene.tri_v2, zpad3]),
        tri_rgb=jnp.concatenate([scene.tri_rgb, zpad3]),
        tri_mat=jnp.concatenate([scene.tri_mat,
                                 jnp.ones((pad,), scene.tri_mat.dtype)]),
    )
