"""Shading: soft-shadowed direct light, reflection/refraction, and the
wavefront bounce loop.

The reference's per-ray recursion-style bounce loop (``Source/kernels.cl:
342-365``) becomes a masked ``lax.scan`` over the whole ray batch: every
iteration reflects/refracts the still-active rays, re-intersects, shades rays
that landed on a diffuse surface, and retires rays that escaped. No
divergence, no recursion — each bounce is one fused intersect+shade step, and
``lax.scan`` keeps the graph size independent of the bounce budget while
remaining reverse-mode differentiable (unlike ``lax.while_loop``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from .intersect import DeviceScene, Hit, intersect, in_shadow, _tri_tuv
from .math3 import dot3, normalize3
from .rng import crush, shadow_seed, xorshift

# np scalar (not jnp): avoid backend init at import (see ops/intersect.py)
_PI4 = np.float32(4.0 * 3.14159265358979323846)


def direct_light(ds: DeviceScene, cfg: RenderConfig, pos, normal, gid,
                 tri_axis: str | None = None, record: bool = False):
    """Soft-shadowed inverse-square Lambert (``kernels.cl:313-340``).

    Reference quirks kept verbatim: the per-sample jitter perturbs only the
    occlusion ray; the Lambert term uses the unperturbed *unnormalized*
    shadow direction in both the cosine and the 1/(4 pi r^2) falloff; the
    RNG stream restarts from the pixel-id seed on every call. With
    ``record`` also returns the unoccluded-sample count per ray."""
    sdir = ds.light_pos[None] - pos
    start = pos + jnp.float32(cfg.bias) * sdir
    radius_sq = dot3(sdir, sdir)
    rs_safe = jnp.where(radius_sq == 0, jnp.float32(1.0), radius_sq)
    lamb = (ds.light_color[None] * jnp.maximum(dot3(sdir, normal), 0.0)[:, None]
            / (_PI4 * rs_safe)[:, None])
    lamb = jnp.where((radius_sq == 0)[:, None], 0.0, lamb)

    def sample(carry, _):
        state, acc, cnt = carry
        state = xorshift(state)
        jitter = crush(state, cfg.light_spread)
        lit = ~in_shadow(ds, start, sdir + jitter, radius_sq, tri_axis)
        acc = acc + lit[:, None].astype(jnp.float32) * lamb
        return (state, acc, cnt + lit.astype(jnp.float32)), None

    state0 = shadow_seed(gid)
    (_, total, cnt), _ = jax.lax.scan(
        sample, (state0, jnp.zeros_like(pos), jnp.zeros_like(radius_sq)),
        None, length=cfg.shadow_samples)
    dl = total / jnp.float32(cfg.shadow_samples)
    return (dl, cnt) if record else dl


def _reflect_dir(d, n):
    """Mirror direction d - 2(d.n)n (``kernels.cl:54-65``); unnormalized."""
    return d - jnp.float32(2.0) * dot3(d, n)[:, None] * n


def _refract_dir(cfg: RenderConfig, d, n, medium):
    """Snell refraction with medium tracking (``kernels.cl:67-88``).
    Returns (direction (unnormalized), exit medium, tir mask, cos_in, n1, n2).
    The TIR case is signalled by the mask; the direction for TIR lanes is
    computed with a clamped sqrt so no NaN enters the graph."""
    c1 = dot3(n, d)
    nrm = jnp.where(c1[:, None] < 0, -n, n)
    c1a = jnp.abs(c1)
    in_air = medium == jnp.float32(cfg.ior_air)
    n1 = jnp.where(in_air, jnp.float32(cfg.ior_air), jnp.float32(cfg.ior_glass))
    n2 = jnp.where(in_air, jnp.float32(cfg.ior_glass), jnp.float32(cfg.ior_air))
    nr = n1 / n2
    k = jnp.float32(1.0) - nr * nr * (jnp.float32(1.0) - c1a * c1a)
    tir = k < 0
    # TIR lanes go through sqrt(1) (their refracted direction is discarded);
    # a clamped sqrt would leak NaN into the backward pass via inf * 0.
    # k == 0 (grazing TIR boundary) short-circuits too: sqrt'(0) = inf.
    kz = k == 0
    c2 = jnp.sqrt(jnp.where(tir | kz, jnp.float32(1.0), k))
    c2 = jnp.where(kz, jnp.float32(0.0), c2)
    out = nr[:, None] * d + (nr * c1a - c2)[:, None] * (-nrm)
    return out, n2, tir, c1a, n1, n2


def _schlick(c1, n1, n2):
    r0 = jnp.square((n1 - n2) / (n1 + n2))
    return r0 + (1 - r0) * (1 - c1) ** 5


def trace_specular(ds: DeviceScene, cfg: RenderConfig, primary: Hit, d,
                   tri_axis: str | None = None):
    """Wavefront specular bounce loop (``kernels.cl:342-365``) — geometry
    only. A ray stays active while its last hit is specular (mat <= 0); the
    loop records the *terminal* diffuse hit (position, normal, color,
    Fresnel throughput) and leaves shading to the caller, so the expensive
    soft-shadow sampling runs once per ray instead of once per bounce.
    Escape / exhausted budget / quirk-TIR death leave term_valid False
    (black, as in the reference). With ``cfg.quirk_nan_tir`` a
    total-internal-reflection event kills the ray (the reference's NaN
    direction renders black); otherwise TIR reflects. With ``cfg.fresnel``
    refraction is attenuated by Schlick transmittance (extension). The
    result also holds ``bounce_id`` [bounces, N]: the object each live ray
    hit at each step, -1 once it is no longer alive (the residual the
    path-replay backward keys on)."""
    n_rays = d.shape[0]
    state0 = dict(
        active=primary.hit & (primary.mat <= 0),
        term_valid=jnp.zeros((n_rays,), bool),
        term_pos=jnp.zeros((n_rays, 3), jnp.float32),
        term_normal=jnp.zeros((n_rays, 3), jnp.float32),
        term_rgb=jnp.zeros((n_rays, 3), jnp.float32),
        weight=jnp.ones((n_rays,), jnp.float32),
        d=d,
        pos=primary.pos,
        normal=primary.normal,
        mat=primary.mat,
        medium=jnp.full((n_rays,), jnp.float32(cfg.ior_air)),
    )

    def bounce(s, _):
        refl = _reflect_dir(s["d"], s["normal"])
        refr, n2, tir, c1a, n1v, n2v = _refract_dir(cfg, s["d"], s["normal"],
                                                    s["medium"])
        is_mirror = s["mat"] == 0
        if cfg.quirk_nan_tir:
            dead = tir & ~is_mirror            # NaN direction -> black
            use_refl = is_mirror
        else:
            dead = jnp.zeros_like(tir)
            use_refl = is_mirror | tir         # correct TIR: reflect
        new_dir = jnp.where(use_refl[:, None], refl, refr)
        new_medium = jnp.where(use_refl, jnp.float32(cfg.ior_air), n2)
        new_start = s["pos"] + jnp.float32(cfg.bias) * new_dir
        alive = s["active"] & ~dead
        new_dir = normalize3(new_dir, alive)

        weight = s["weight"]
        if cfg.fresnel:
            w_step = jnp.where(use_refl, jnp.float32(1.0),
                               jnp.float32(1.0) - _schlick(c1a, n1v, n2v))
            weight = jnp.where(alive, weight * w_step, weight)

        hit = intersect(ds, new_start, new_dir, tri_axis)
        diffuse = alive & hit.hit & (hit.mat > 0)
        keep_t = diffuse[:, None]
        cont = alive & hit.hit & (hit.mat <= 0)
        keep = cont[:, None]
        n_active = jnp.sum(alive.astype(jnp.int32))
        return dict(
            active=cont,
            term_valid=s["term_valid"] | diffuse,
            term_pos=jnp.where(keep_t, hit.pos, s["term_pos"]),
            term_normal=jnp.where(keep_t, hit.normal, s["term_normal"]),
            term_rgb=jnp.where(keep_t, hit.rgb, s["term_rgb"]),
            weight=weight,
            d=jnp.where(keep, new_dir, s["d"]),
            pos=jnp.where(keep, hit.pos, s["pos"]),
            normal=jnp.where(keep, hit.normal, s["normal"]),
            mat=jnp.where(cont, hit.mat, s["mat"]),
            medium=jnp.where(cont, new_medium, s["medium"]),
        ), (n_active, jnp.where(alive, hit.obj_id, jnp.int32(-1)))

    final, (n_active, bounce_id) = jax.lax.scan(
        jax.checkpoint(bounce), state0, None, length=cfg.bounces)
    final["bounce_rays"] = jnp.sum(n_active)
    final["bounce_id"] = bounce_id
    return final


def shade(ds: DeviceScene, cfg: RenderConfig, start, d, gid,
          tri_axis: str | None = None, record: bool = False):
    """Full per-ray radiance (``kernels.cl:411-425``): nearest hit, bounce
    loop for specular rays, then ONE soft-shadow evaluation at the unified
    shading point (the primary hit for diffuse rays, the bounce-terminal
    hit for specular rays — both use the same pixel-seeded RNG stream, so
    the result is identical to shading inside the loop as the reference
    does, at a tenth of the shadow-ray cost).

    With ``record`` returns (color, prim_id, lit_cnt, bounce_id): the
    discrete decisions the fused kernel records for the path-replay
    backward, in its encoding (``ops/replay.Residuals``)."""
    primary = intersect(ds, start, d, tri_axis)
    prim_diffuse = primary.hit & (primary.mat > 0)

    if cfg.bounces > 0:
        term = trace_specular(ds, cfg, primary, d, tri_axis)
        term_valid = term["term_valid"]
        sp_pos = jnp.where(prim_diffuse[:, None], primary.pos, term["term_pos"])
        sp_normal = jnp.where(prim_diffuse[:, None], primary.normal,
                              term["term_normal"])
    else:
        term = None
        term_valid = jnp.zeros_like(prim_diffuse)
        sp_pos, sp_normal = primary.pos, primary.normal

    dl = direct_light(ds, cfg, sp_pos, sp_normal, gid, tri_axis, record)
    if record:
        dl, lit = dl
    color = jnp.where(prim_diffuse[:, None],
                      primary.rgb * (ds.indirect[None] + dl), 0.0)
    if term is not None:
        sec = (jnp.float32(0.9) * (ds.indirect[None] + dl) * term["term_rgb"]
               * term["weight"][:, None])
        color = jnp.where(term_valid[:, None], sec, color)
    if not record:
        return color
    bounce_id = (term["bounce_id"] if term is not None
                 else jnp.zeros((0, d.shape[0]), jnp.int32))
    lit = jnp.where(prim_diffuse | term_valid, lit, jnp.float32(0.0))
    return color, primary.obj_id, lit, bounce_id


# ---------------------------------------------------------------------------
# CPU-reference semantics (the vestigial scalar renderer)
# ---------------------------------------------------------------------------

def shade_cpu_ref(ds: DeviceScene, cfg: RenderConfig, start, d,
                  record: bool = False):
    """``skeleton.cpp:184-279`` semantics: triangles only, unnormalized rays,
    distances measured as |t*d|, one hard shadow ray with relative bias 1e-3,
    no material logic (every triangle occludes). ``record`` as in
    ``shade``."""
    t, u, v, degenerate = _tri_tuv(ds, start, d)
    valid = ((t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)) & ~degenerate
    t_m = jnp.where(valid, t, jnp.float32(jnp.inf))
    t_m = jnp.where(jnp.isnan(t_m), jnp.float32(jnp.inf), t_m)
    idx = jnp.argmin(t_m, axis=1)
    ar = jnp.arange(d.shape[0])
    tb = t_m[ar, idx]
    hit = jnp.isfinite(tb)
    u_b = jnp.where(hit, u[ar, idx], 0.0)
    v_b = jnp.where(hit, v[ar, idx], 0.0)
    pos = ds.v0[idx] + u_b[:, None] * ds.e1[idx] + v_b[:, None] * ds.e2[idx]
    normal = ds.n[idx]
    rgb = ds.rgb[idx]

    # Hard shadow (skeleton.cpp:220-241): nearest occluder toward the light,
    # shadowed if its unnormalized-units distance is below the light radius.
    r = ds.light_pos[None] - pos
    radius = jnp.sqrt(dot3(r, r))
    s_start = pos + jnp.float32(cfg.cpu_ref_bias) * r
    ts, us, vs, degs = _tri_tuv(ds, s_start, r)
    valid_s = ((ts >= 0) & (us >= 0) & (vs >= 0) & ((us + vs) <= 1)) & ~degs
    dist = jnp.sqrt(ts * ts * dot3(r, r)[:, None])
    shadowed = jnp.any(valid_s & (dist < radius[:, None])
                       & ~jnp.isnan(dist), axis=1)

    rad_safe = jnp.where(radius == 0, 1.0, radius)
    lamb = (ds.light_color[None] * jnp.maximum(dot3(r, normal), 0.0)[:, None]
            / (_PI4 * rad_safe * rad_safe)[:, None])
    dl = jnp.where(shadowed[:, None], 0.0, lamb)
    color = jnp.where(hit[:, None], rgb * (dl + ds.indirect[None]), 0.0)
    if not record:
        return color
    prim_id = jnp.where(hit, idx.astype(jnp.int32), jnp.int32(-1))
    lit = jnp.where(hit & ~shadowed, jnp.float32(1.0), jnp.float32(0.0))
    return color, prim_id, lit, jnp.zeros((0, d.shape[0]), jnp.int32)
