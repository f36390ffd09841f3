"""Path-replay reconstruction: the hand-derived backward pass.

The forward (the fused kernel, or the plain jnp forward that records the
same decisions) keeps each ray's *discrete decisions* — primary hit object
id, per-bounce hit object ids, and soft-shadow lit counts — as cheap
residuals. This module rebuilds the pixel radiance as a lean
differentiable function of the scene parameters with those decisions frozen:
every ray gathers only the one object it actually hit (O(1) per bounce, no
[rays, triangles] broadcast) and the occlusion counts enter via
stop_gradient (their true derivative is zero almost everywhere).

Under the framework's gradient semantics (visibility is piecewise-constant;
the pixel gradient is the interior/shading gradient — SURVEY.md §7) the
gradient of this replay equals the gradient of the full pipeline, at a tiny
fraction of the cost: this is the same decision/recompute factorization used
by replay-style differentiable renderers, expressed as row gathers and
elementwise math that XLA fuses.

Object id encoding: 0..T-1 triangle, T+s sphere s, -1 miss/inactive.
Ray layout follows the kernel: (A, H, W) flattened A-major.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..scene import Scene
from .camera import gen_primary_rays
from .math3 import det3, dot3

_F = jnp.float32


class Residuals(NamedTuple):
    prim_id: jax.Array    # int32 [A, H, W]
    lit_cnt: jax.Array    # float32 [A, H, W] (number of unoccluded samples)
    bounce_id: jax.Array  # int32 [bounces, A, H, W] (empty if bounces == 0)


def build_object_table(scene: Scene):
    """Combined object table [T+S+1, 14] for one-hot gathering.

    Triangle rows: v0(0:3), e1(3:6), e2(6:9), rgb(9:12), mat(12), 0.
    Sphere rows:   c(0:3),  zeros,   zeros,   rgb(9:12), mat(12), r2(13).
    Final row: the miss/inactive target (mat=1, everything else 0).
    Differentiable w.r.t. every Scene leaf it draws from."""
    T = scene.tri_v0.shape[0]
    S = scene.sph_center.shape[0]
    tri = jnp.concatenate([
        scene.tri_v0, scene.tri_v1 - scene.tri_v0,
        scene.tri_v2 - scene.tri_v0, scene.tri_rgb,
        scene.tri_mat[:, None], jnp.zeros((T, 1), _F)], axis=1)
    rows = [tri]
    if S:
        sph = jnp.concatenate([
            scene.sph_center, jnp.zeros((S, 6), _F), scene.sph_rgb,
            scene.sph_mat[:, None], scene.sph_r2[:, None]], axis=1)
        rows.append(sph)
    pad = jnp.zeros((1, 14), _F).at[0, 12].set(1.0)
    rows.append(pad)
    return jnp.concatenate(rows, axis=0)


# Above this table size the transient [rays, rows] one-hot stops paying for
# itself (and would dominate memory); use the native gather instead.
_ONEHOT_MAX_ROWS = 2048


def _gather_rows(table, ids):
    """Row gather as a one-hot product: rows = onehot(ids) @ table (exact:
    each row has a single 1.0); its transpose, the scatter-add of the
    backward pass, is a product too. Precision.HIGHEST keeps the product in
    full f32: a TF32 product would round the gathered vertices. Large
    tables use jnp.take: the [N, rows] one-hot no longer fits."""
    R = table.shape[0]
    idx = jnp.where(ids < 0, R - 1, ids)
    if R > _ONEHOT_MAX_ROWS:
        return jnp.take(table, idx, axis=0)
    oh = (idx[:, None] == jnp.arange(R, dtype=ids.dtype)[None, :]).astype(_F)
    return jnp.dot(oh, table, preferred_element_type=_F,
                   precision=jax.lax.Precision.HIGHEST)


def _gather_rows_batched(table, id_list, max_bytes=1 << 28):
    """Gather several id vectors in as few matmuls as possible: the gathers
    depend only on the ids (recorded decisions), never on per-step ray
    state, so they can all be hoisted ahead of the replay math. Groups are
    sized so the transient one-hot stays under ~max_bytes."""
    if not id_list:
        return []
    n = id_list[0].shape[0]
    per = n * table.shape[0] * 4
    group = max(1, max_bytes // max(per, 1))
    out = []
    for i in range(0, len(id_list), group):
        chunk = id_list[i:i + group]
        rows = _gather_rows(table, jnp.concatenate(chunk))
        out.extend(jnp.split(rows, len(chunk)))
    return out


def _hit_from_row(row, n_tri: int, ids, start, d):
    """Differentiable hit reconstruction from a pre-gathered object row.

    Recomputes the reference formulas (Cramer t/u/v for the identified
    triangle, the stable quadratic root for the identified sphere) so values
    match the forward kernel on the smooth branch. Returns
    (pos, normal, rgb, mat, valid)."""
    is_sph = ids >= n_tri
    valid = ids >= 0

    v0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    rgb = row[:, 9:12]
    mat = row[:, 12]
    b = start - v0
    nd = -d
    detA = det3(nd, e1, e2)
    degen = detA == 0
    recip = _F(1.0) / jnp.where(degen, _F(1.0), detA)
    u = det3(nd, b, e2) * recip
    v = det3(nd, e1, b) * recip
    tri_pos = v0 + u[:, None] * e1 + v[:, None] * e2
    n_raw = jnp.cross(e2, e1)
    nn = dot3(n_raw, n_raw)
    tri_n = n_raw / jnp.sqrt(jnp.where(nn == 0, _F(1.0), nn))[:, None]

    # sphere branch (c lives in the v0 slot, r2 in slot 13). Triangle rows
    # also flow through this arithmetic (their result is masked out), but
    # their r2 = 0 makes disc <= 0 with equality at exact ray-vertex
    # alignment — an inf-grad sqrt(0); gate the sqrt on the lane actually
    # being a sphere hit.
    c = v0
    r2 = row[:, 13]
    L = start - c
    a_q = dot3(d, d)
    b_q = _F(2.0) * dot3(d, L)
    c_q = dot3(L, L) - r2
    disc = b_q * b_q - _F(4.0) * a_q * c_q
    no_sol = disc < 0
    # disc == 0 short-circuits the sqrt: its inf derivative would poison
    # the sphere gradients (see ops/intersect._sphere_roots)
    sq_zero = disc == 0
    sq = jnp.sqrt(jnp.where(no_sol | sq_zero | ~is_sph, _F(1.0), disc))
    sq = jnp.where(sq_zero, _F(0.0), sq)
    q = jnp.where(b_q > 0, _F(-0.5) * (b_q + sq), _F(-0.5) * (b_q - sq))
    qz = q == 0
    x0 = q / jnp.where(a_q == 0, _F(1.0), a_q)
    x1 = jnp.where(qz, x0, c_q / jnp.where(qz, _F(1.0), q))
    xmin = jnp.minimum(x0, x1)
    xmax = jnp.maximum(x0, x1)
    cand = jnp.where(xmin >= 0, xmin, xmax)
    cand = jnp.where(no_sol, _F(0.0), cand)
    sph_pos = start + cand[:, None] * d
    pc = sph_pos - c
    pl2 = dot3(pc, pc)
    sph_n = pc / jnp.sqrt(jnp.where(pl2 == 0, _F(1.0), pl2))[:, None]

    m = is_sph[:, None]
    pos = jnp.where(m, sph_pos, tri_pos)
    normal = jnp.where(m, sph_n, tri_n)
    vm = valid[:, None]
    return (jnp.where(vm, pos, 0.0), jnp.where(vm, normal, 0.0),
            jnp.where(vm, rgb, 0.0), jnp.where(valid, mat, _F(1.0)), valid)


def replay_forward(scene: Scene, cfg: RenderConfig, res: Residuals,
                   row0=None, rows: int | None = None):
    """Radiance [rows, W, 3] reconstructed from recorded decisions. Matches
    the fused kernel's forward output on the smooth branch; its jax gradient
    is the framework's pixel gradient. row0/rows replay only a row band of
    the logical image (the dp-sharded path)."""
    A = cfg.aa_rays
    H, W = cfg.height, cfg.width
    rows = H if rows is None else rows
    dirs, _ = gen_primary_rays(cfg, scene.yaw, scene.pitch)    # [H,W,A,3]
    if rows != H or row0 is not None:
        dirs = jax.lax.dynamic_slice_in_dim(
            dirs, jnp.asarray(0 if row0 is None else row0, jnp.int32),
            rows, axis=0)
    H = rows
    d = jnp.transpose(dirs, (2, 0, 1, 3)).reshape(-1, 3)       # A-major [N,3]
    n = d.shape[0]
    start = jnp.broadcast_to(scene.camera_pos, (n, 3))

    table = build_object_table(scene)
    n_tri = scene.tri_v0.shape[0]
    prim_id = res.prim_id.reshape(-1)
    n_b = res.bounce_id.shape[0] if cfg.bounces > 0 else 0
    all_rows = _gather_rows_batched(
        table, [prim_id] + [res.bounce_id[b].reshape(-1) for b in range(n_b)])
    pos, normal, rgb, mat, valid = _hit_from_row(all_rows[0], n_tri, prim_id,
                                                 start, d)
    # CPU-ref shades ANY hit triangle (skeleton.cpp:268 has no material test)
    prim_diffuse = valid if cfg.cpu_ref else valid & (mat > 0)

    # --- bounce chain replay ---
    term_valid = jnp.zeros((n,), bool)
    term_pos = jnp.zeros((n, 3), _F)
    term_nrm = jnp.zeros((n, 3), _F)
    term_rgb = jnp.zeros((n, 3), _F)
    weight = jnp.ones((n,), _F)
    if cfg.bounces > 0 and res.bounce_id.shape[0]:
        cur_d, cur_pos, cur_nrm, cur_mat = d, pos, normal, mat
        medium = jnp.full((n,), _F(cfg.ior_air))
        active = valid & (mat <= 0)
        for b in range(cfg.bounces):
            ids_b = res.bounce_id[b].reshape(-1)
            # reflect / refract decision recomputed (kernels.cl:54-88)
            dn = dot3(cur_d, cur_nrm)
            refl = cur_d - _F(2.0) * dn[:, None] * cur_nrm
            c1 = dn
            nflip = jnp.where(c1[:, None] < 0, -cur_nrm, cur_nrm)
            c1a = jnp.abs(c1)
            in_air = medium == _F(cfg.ior_air)
            n1 = jnp.where(in_air, _F(cfg.ior_air), _F(cfg.ior_glass))
            n2 = jnp.where(in_air, _F(cfg.ior_glass), _F(cfg.ior_air))
            nr = n1 / n2
            k = _F(1.0) - nr * nr * (_F(1.0) - c1a * c1a)
            tir = k < 0
            kz = k == 0   # grazing TIR boundary: kill the inf sqrt grad
            c2 = jnp.sqrt(jnp.where(tir | kz, _F(1.0), k))
            c2 = jnp.where(kz, _F(0.0), c2)
            refr = nr[:, None] * cur_d + (nr * c1a - c2)[:, None] * (-nflip)
            is_mirror = cur_mat == 0
            if cfg.quirk_nan_tir:
                dead = tir & ~is_mirror
                use_refl = is_mirror
            else:
                dead = jnp.zeros_like(tir)
                use_refl = is_mirror | tir
            ndir = jnp.where(use_refl[:, None], refl, refr)
            nmed = jnp.where(use_refl, _F(cfg.ior_air), n2)
            nstart = cur_pos + _F(cfg.bias) * ndir
            alive = active & ~dead
            nd2 = jnp.maximum(dot3(ndir, ndir), _F(1e-30))
            ndir = ndir / jnp.sqrt(nd2)[:, None]
            if cfg.fresnel:
                r0f = jnp.square((n1 - n2) / (n1 + n2))
                refl_w = r0f + (1 - r0f) * (1 - c1a) ** 5
                w_step = jnp.where(use_refl, _F(1.0), _F(1.0) - refl_w)
                weight = jnp.where(alive, weight * w_step, weight)

            h_pos, h_nrm, h_rgb, h_mat, h_valid = _hit_from_row(
                all_rows[1 + b], n_tri, ids_b, nstart, ndir)
            h_valid = h_valid & alive
            diffuse = h_valid & (h_mat > 0)
            km = diffuse[:, None]
            term_valid = term_valid | diffuse
            term_pos = jnp.where(km, h_pos, term_pos)
            term_nrm = jnp.where(km, h_nrm, term_nrm)
            term_rgb = jnp.where(km, h_rgb, term_rgb)
            cont = h_valid & (h_mat <= 0)
            cm = cont[:, None]
            cur_d = jnp.where(cm, ndir, cur_d)
            cur_pos = jnp.where(cm, h_pos, cur_pos)
            cur_nrm = jnp.where(cm, h_nrm, cur_nrm)
            cur_mat = jnp.where(cont, h_mat, cur_mat)
            medium = jnp.where(cont, nmed, medium)
            active = cont

    # --- unified shading point + frozen-count soft shadow ---
    sp_pos = jnp.where(prim_diffuse[:, None], pos, term_pos)
    sp_nrm = jnp.where(prim_diffuse[:, None], normal, term_nrm)
    sdir = scene.light_pos[None] - sp_pos
    radius_sq = dot3(sdir, sdir)
    rs = jnp.where(radius_sq == 0, _F(1.0), radius_sq)
    lam_base = jnp.maximum(dot3(sdir, sp_nrm), 0.0) / (_F(4.0 * jnp.pi) * rs)
    lam_base = jnp.where(radius_sq == 0, _F(0.0), lam_base)
    lit = jax.lax.stop_gradient(res.lit_cnt.reshape(-1))
    dl_scale = lit * lam_base / _F(cfg.shadow_samples)
    dl = scene.light_color[None] * dl_scale[:, None]

    color = jnp.where(prim_diffuse[:, None],
                      rgb * (scene.indirect_light[None] + dl), 0.0)
    color = jnp.where(term_valid[:, None],
                      _F(0.9) * (scene.indirect_light[None] + dl)
                      * term_rgb * weight[:, None], color)
    img = color.reshape(A, H, W, 3)
    return img.sum(axis=0) / _F(A)
