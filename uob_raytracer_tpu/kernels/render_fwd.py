"""Fused forward kernel: the whole per-pixel pipeline in one launch, written
for Pallas's Triton route (``backend="triton"``).

This is the analogue of the reference's single ``draw`` kernel
(``Source/kernels.cl:368-428``): one program per block of rays computes AA
ray generation, brute-force nearest-hit over the whole scene, the specular
bounce loop, one soft-shadow pass at the unified shading point and the AA
average, with every intermediate in registers. The scene tables stay in
global memory (a few KB for Cornell, 0.6 MB at 8k triangles: both live in
L1/L2) and are read scalar-by-scalar, every thread of the block reading the
same address, mirroring the reference's local-memory staging
(``kernels.cl:374-376``).

Layout: a block is (Ap, TW) float32 per vector quantity: the AA rays of TW
adjacent pixels of one image row, with the AA count padded to a power of two
(Triton's tensors must have power-of-two sizes). Padding AA rays are traced
like any other and masked out of the average. The bounce loop is a
``lax.while_loop`` with a block-level early exit: a block whose rays hold no
specular surface leaves after one max-reduction, which is how the
reference's per-ray loop exit (``kernels.cl:348``) maps onto SIMT blocks.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import RenderConfig
from ..scene import Scene

# Rays per program and warps per program. 256 rays on 4 warps is two rays
# per thread: the bounce loop carries ~20 f32 per ray and the shadow pass
# ~5 per sample, which keeps a block under the 255-register cap.
RAYS_PER_BLOCK = 256
NUM_WARPS = 4
NUM_STAGES = 1

# np scalars (not jnp): jnp scalars materialize as device arrays at import
# time and would be flagged as captured constants by pallas_call.
_F = np.float32
_PI4 = np.float32(4.0 * np.pi)
_BIG = np.float32(3.0e38)
_UINT_MAX_F = np.float32(4294967295.0)  # == 2^32 in f32, as in the OpenCL

# Table widths, padded to powers of two. tri row: v0 0:3, e1 3:6, e2 6:9,
# n(unit) 9:12, rgb 12:15, mat 15, E=cross(e1,e2) 16:19. sph row: c 0:3,
# r2 3, rgb 4:7, mat 7. cam: rot rows r0 r1 r2, camera, light, light_color,
# indirect. shd row (ops/quads.py): v0 0:3, e1 3:6, e2 6:9, E 9:12, mat 12.
TRI_COLS = 32
SPH_COLS = 8
CAM_LEN = 32
SHD_COLS = 16


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _pad_pow2(tbl, cols: int):
    """Zero-pad a table to a power-of-two row count and ``cols`` columns.
    All-zero pad rows have E = 0 and hence a zero determinant: every accept
    test rejects them, so they are inert wherever a scan reaches them."""
    rows = tbl.shape[0]
    return jnp.pad(tbl, ((0, _pow2(rows) - rows), (0, cols - tbl.shape[1])))


# --------------------------------------------------------------------------
# Scene packing: SoA pytree -> flat tables (traced, differentiable)
# --------------------------------------------------------------------------

def pack_scene(scene: Scene):
    """Flatten the scene into (tri [T,19], sph [S,8], cam [21]) float32
    tables. Built inside the traced graph from the Scene leaves."""
    v0 = scene.tri_v0
    e1 = scene.tri_v1 - v0
    e2 = scene.tri_v2 - v0
    n = jnp.cross(e2, e1)
    nn = jnp.sum(n * n, axis=-1, keepdims=True)
    n = n / jnp.sqrt(jnp.where(nn == 0, 1.0, nn))
    tri = jnp.concatenate(
        [v0, e1, e2, n, scene.tri_rgb, scene.tri_mat[:, None],
         jnp.cross(e1, e2)], axis=1)

    if scene.sph_center.shape[0]:
        sph = jnp.concatenate([
            scene.sph_center, scene.sph_r2[:, None], scene.sph_rgb,
            scene.sph_mat[:, None]], axis=1)
    else:
        sph = jnp.zeros((1, SPH_COLS), _F)

    cy, sy = jnp.cos(scene.yaw), jnp.sin(scene.yaw)
    cp, sp = jnp.cos(scene.pitch), jnp.sin(scene.pitch)
    cam = jnp.concatenate([
        jnp.stack([cy, sp * sy, sy * cp, _F(0.0), cp, -sp,
                   -sy, cy * sp, cp * cy]),
        scene.camera_pos, scene.light_pos, scene.light_color,
        scene.indirect_light,
    ]).astype(_F)
    return tri, sph, cam


def pack_shadow(scene: Scene, quads):
    """Pack the occlusion-scan geometry for a quad pairing from
    ``ops.quads.detect_shadow_quads``: ``n_quads`` parallelogram rows
    (spanned from triangle a's off-diagonal corner p by its two shared
    vertices) followed by the unpaired triangles' rows, 13 columns each.
    Built in the traced graph from the current Scene leaves (pairing
    indices are static)."""
    pairs, leftover = quads
    v = jnp.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], axis=1)
    rows = []
    if pairs:
        pa = np.array([p[0] for p in pairs])
        pc = np.array([p[1] for p in pairs])
        P = v[pa, pc]
        e1 = v[pa, (pc + 1) % 3] - P
        e2 = v[pa, (pc + 2) % 3] - P
        rows.append(jnp.concatenate(
            [P, e1, e2, jnp.cross(e1, e2), scene.tri_mat[pa][:, None]],
            axis=1))
    if leftover:
        li = np.array(leftover)
        P = scene.tri_v0[li]
        e1 = scene.tri_v1[li] - P
        e2 = scene.tri_v2[li] - P
        rows.append(jnp.concatenate(
            [P, e1, e2, jnp.cross(e1, e2), scene.tri_mat[li][:, None]],
            axis=1))
    return jnp.concatenate(rows, axis=0).astype(_F)


# --------------------------------------------------------------------------
# vec3-as-tuple helpers over (Ap, TW) component arrays
# --------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _scale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _det3(a, b, c):
    """Cofactor expansion, rows (a,b,c) (kernels.cl:31-35)."""
    return (a[0] * (b[1] * c[2] - b[2] * c[1])
            - a[1] * (b[0] * c[2] - b[2] * c[0])
            + a[2] * (b[0] * c[1] - b[1] * c[0]))


def _where3(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def _ptx_f32(op: str, *args):
    """One PTX f32 instruction applied elementwise: ``op $0, $1[, $2];``."""
    args = jnp.broadcast_arrays(*(jnp.asarray(x, _F) for x in args))
    operands = ", ".join(f"${i}" for i in range(len(args) + 1))
    (out,) = plgpu.elementwise_inline_asm(
        f"{op} {operands};", args=list(args),
        constraints=",".join(["=f"] + ["f"] * len(args)), pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(args[0].shape, _F)])
    return out


class _Arith(NamedTuple):
    """Division and square root as the kernel computes them."""
    div: Callable
    sqrt: Callable


# IEEE round-to-nearest f32 division and square root, as NumPy (the oracle)
# computes them. Triton lowers ``/`` to div.full.f32 and sqrt to an
# approximation (on an H100, 28 % of random quotients and 17 % of roots
# differ from IEEE in the last bit), which moves rays and accept tests off
# the oracle's by an ulp and flips marginal hits and shadow samples.
_IEEE_TRITON = _Arith(div=lambda a, b: _ptx_f32("div.rn.f32", a, b),
                      sqrt=lambda a: _ptx_f32("sqrt.rn.f32", a))
# the Pallas interpreter runs on the CPU, whose XLA division and sqrt are
# already IEEE
_IEEE_INTERPRET = _Arith(div=jnp.divide, sqrt=jnp.sqrt)


def _xorshift3(s):
    out = []
    for v in s:
        v = v ^ (v << jnp.uint32(13))
        v = v ^ (v >> jnp.uint32(17))
        v = v ^ (v << jnp.uint32(5))
        out.append(v)
    return tuple(out)


def _u32_to_f32(v):
    """uint32 -> float32 with round-to-nearest, via an exact hi/lo split of
    two non-negative int32 halves (a signed convert of the whole word would
    misread values >= 2^31). hi*65536 and lo are both exactly representable,
    so the single add rounds exactly like a direct unsigned convert."""
    hi = jax.lax.bitcast_convert_type(v >> jnp.uint32(16), jnp.int32)
    lo = jax.lax.bitcast_convert_type(v & jnp.uint32(0xFFFF), jnp.int32)
    return hi.astype(_F) * _F(65536.0) + lo.astype(_F)


def _f32_to_u32(v):
    """float32 -> uint32 truncation for values < 2^31 (all our uses)."""
    return jax.lax.bitcast_convert_type(v.astype(jnp.int32), jnp.uint32)


def _crush3(s, rng, ar):
    r = _F(rng)
    return tuple(ar.div(r * _u32_to_f32(v), _UINT_MAX_F) - r / _F(2.0)
                 for v in s)


# --------------------------------------------------------------------------
# Scans over scene tables
# --------------------------------------------------------------------------

def _scan(ref, lo: int, hi: int):
    """Row-range scan over a table as a loop (unrolled scans of even the
    26-triangle Cornell box take Triton minutes to compile). The body
    receives (get, gi, carry): get(col) -> scalar of the current row,
    gi = row index (int32)."""
    def scan(body, carry):
        def wrap(i, c):
            return body(lambda col: ref[i, col], i, c)
        return jax.lax.fori_loop(lo, hi, wrap, carry)
    return scan


def _sphere_roots(c, r2, start, d, ar):
    """Stable quadratic roots (kernels.cl:140-143): (xmin, xmax, no_sol,
    a_q) for one sphere against the ray bundle."""
    L = _sub(start, c)
    a_q = _dot(d, d)
    b_q = _F(2.0) * _dot(d, L)
    c_q = _dot(L, L) - r2
    disc = b_q * b_q - _F(4.0) * a_q * c_q
    no_sol = disc < 0
    sq = ar.sqrt(jnp.where(no_sol, _F(1.0), disc))
    q = jnp.where(b_q > 0, _F(-0.5) * (b_q + sq), _F(-0.5) * (b_q - sq))
    qz = q == 0
    x0 = ar.div(q, jnp.where(a_q == 0, _F(1.0), a_q))
    x1 = jnp.where(qz, x0, ar.div(c_q, jnp.where(qz, _F(1.0), q)))
    return jnp.minimum(x0, x1), jnp.maximum(x0, x1), no_sol, a_q


def _sph(sph_ref, i):
    return ((sph_ref[i, 0], sph_ref[i, 1], sph_ref[i, 2]), sph_ref[i, 3],
            (sph_ref[i, 4], sph_ref[i, 5], sph_ref[i, 6]), sph_ref[i, 7])


def _lit_count(tri_ref, sph_ref, shd_ref, n_tri, n_sph, n_quads, n_shd,
               start, sdir, state, radius_sq, cfg: RenderConfig, ar):
    """Unoccluded-sample count for the soft-shadow pass, the hot loop.

    Two restructurings over the naive per-sample scan (identical semantics
    up to boundary-epsilon rounding):
    * determinants are linear in the ray direction, so the per-triangle
      invariants (E = e1 x e2 from the table, b, t_num = b.E, b x e2,
      e1 x b) hoist out of the sample loop: each of the S jittered rays
      costs only three dot products and the accept test;
    * the accept test is division-free: t >= 0 becomes t_num*detA >= 0,
      |t d|^2 < r^2 becomes t_num^2 |d|^2 < r^2 detA^2, and u,v,u+v tests
      multiply through by detA.

    With a quad table (``pack_shadow``), rows [0, n_quads) are
    parallelograms, the same dot products with independent bounds
    (0 <= u <= 1, 0 <= v <= 1), each standing in for two triangles; rows
    [n_quads, n_shd) are unpaired triangles."""
    S = cfg.shadow_samples
    if cfg.cpu_ref:
        # CPU-ref semantics (skeleton.cpp:220-241): ONE unjittered hard
        # shadow ray; with dds == radius_sq the division-free t-window test
        # reduces to t^2 < 1, exactly the oracle's |t r| < |r|.
        dirs, dds = [sdir], [radius_sq]
    else:
        # Jittered directions (RNG stream exactly as kernels.cl:331): sample
        # s uses the (s+1)-th xorshift of the pixel seed.
        dirs, dds = [], []
        for _ in range(S):
            state = _xorshift3(state)
            ds = _add(sdir, _crush3(state, cfg.light_spread, ar))
            dirs.append(ds)
            dds.append(_dot(ds, ds))

    def occ_body(ecol: int, mcol: int, quad: bool):
        def body(get, gi, occs):
            v0 = (get(0), get(1), get(2))
            e1 = (get(3), get(4), get(5))
            e2 = (get(6), get(7), get(8))
            E = (get(ecol), get(ecol + 1), get(ecol + 2))  # cross(e1, e2)
            b = _sub(start, v0)
            t_num = _dot(b, E)
            t_num2 = t_num * t_num
            B2 = _cross(b, e2)
            B1 = _cross(e1, b)
            # CPU-ref occlusion has no material logic: every triangle
            # occludes (skeleton.cpp:220-241); the GPU path skips glass
            # (kernels.cl:247,279).
            not_glass = True if cfg.cpu_ref else get(mcol) != _F(-1.0)
            new = []
            for s in range(S):
                dA = -_dot(dirs[s], E)
                u_n = -_dot(dirs[s], B2)
                v_n = -_dot(dirs[s], B1)
                dA2 = dA * dA
                hit = ((t_num * dA >= 0)
                       & (t_num2 * dds[s] < radius_sq * dA2)
                       & (u_n * dA >= 0) & (v_n * dA >= 0))
                if quad:
                    # dA == 0 is rejected by the strict t-window test
                    hit = hit & (u_n * dA <= dA2) & (v_n * dA <= dA2)
                else:
                    hit = hit & ((u_n + v_n) * dA <= dA2) & (dA != 0)
                new.append(occs[s] | (hit & not_glass))
            return tuple(new)
        return body

    occs = tuple(jnp.zeros(start[0].shape, jnp.bool_) for _ in range(S))
    if shd_ref is not None:
        occs = _scan(shd_ref, 0, n_quads)(occ_body(9, 12, True), occs)
        occs = _scan(shd_ref, n_quads, n_shd)(occ_body(9, 12, False), occs)
    else:
        occs = _scan(tri_ref, 0, n_tri)(occ_body(16, 15, False), occs)
    occs = list(occs)

    for i in range(n_sph):
        c, r2, _, mat = _sph(sph_ref, i)
        not_glass = mat != _F(-1.0)
        for s in range(S):
            xmin, xmax, no_sol, a_q = _sphere_roots(c, r2, start, dirs[s],
                                                    ar)
            hit = (~no_sol & not_glass
                   & (((xmin >= 0) & (xmin * xmin * a_q < radius_sq))
                      | ((xmax >= 0) & (xmax * xmax * a_q < radius_sq))))
            occs[s] = occs[s] | hit

    lit = jnp.full(start[0].shape, _F(S))
    for s in range(S):
        lit = lit - occs[s].astype(_F)
    return lit


def _gather_tri(tri_ref, idx, n_tri: int, start_col: int, n_cols: int,
                default: float):
    """Columns of the triangle each ray hit (idx in [0, n_tri)), ``default``
    where it hit none: one gather per column from the L1-resident table."""
    is_tri = (idx >= 0) & (idx < n_tri)
    ti = jnp.where(is_tri, idx, 0)
    return tuple(jnp.where(is_tri, tri_ref[ti, start_col + k], _F(default))
                 for k in range(n_cols))


def _sphere_winners(sph_ref, n_tri, n_sph, start, d, t_b, idx, ar):
    """Spheres after the triangle scan, strict < against the triangle best
    (kernels.cl:140-166): updated (t_b, idx)."""
    for i in range(n_sph):
        c, r2, _, _ = _sph(sph_ref, i)
        xmin, xmax, no_sol, _ = _sphere_roots(c, r2, start, d, ar)
        cand = jnp.where(xmin >= 0, xmin, xmax)
        ok = ~no_sol & (cand >= 0) & (cand < t_b)
        t_b = jnp.where(ok, cand, t_b)
        idx = jnp.where(ok, np.int32(n_tri + i), idx)
    return t_b, idx


def _sphere_attrs(sph_ref, n_tri, n_sph, idx, pos, nrm, rgb, mat, ar):
    """Overwrite shading attributes where a sphere won."""
    for i in range(n_sph):
        c, _, srgb, smat = _sph(sph_ref, i)
        m = idx == np.int32(n_tri + i)
        pc = _sub(pos, c)
        pclen = ar.sqrt(jnp.maximum(_dot(pc, pc), _F(1e-30)))
        nrm = _where3(m, _scale(ar.div(_F(1.0), pclen), pc), nrm)
        rgb = _where3(m, srgb, rgb)
        mat = jnp.where(m, smat, mat)
    return nrm, rgb, mat


def _nearest_hit_primary(tri_ref, sph_ref, n_tri, n_sph, cam, d, ar):
    """Nearest hit for the primary bundle, exploiting the uniform ray origin
    (every AA ray starts at the camera, ``kernels.cl:388-396``).

    With a shared origin the Möller–Trumbore system's b-vector, t-numerator
    and the two cross-product columns are per-triangle *scalars*, so the
    per-ray work per triangle shrinks to three 3-dots, one divide and the
    accept test, carrying only (t_best, id). The winner's shading attributes
    are gathered once after the scan (hit position as start + t*d, the same
    point as the u/v form up to rounding)."""
    shape = d[0].shape

    def tri_body(get, gi, carry):
        t_b, idx = carry
        v0 = (get(0), get(1), get(2))
        e1 = (get(3), get(4), get(5))
        e2 = (get(6), get(7), get(8))
        E = (get(16), get(17), get(18))       # cross(e1, e2), precomputed
        b = _sub(cam, v0)                     # scalar per-triangle invariants
        t_num = _dot(b, E)
        B2 = _cross(b, e2)
        B1 = _cross(e1, b)
        dA = -_dot(d, E)
        degen = dA == 0
        rA = ar.div(_F(1.0), jnp.where(degen, _F(1.0), dA))
        t = t_num * rA
        u = -_dot(d, B2) * rA
        v = -_dot(d, B1) * rA
        ok = ((t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)
              & ~degen & (t < t_b))
        return jnp.where(ok, t, t_b), jnp.where(ok, gi, idx)

    t_b, idx = _scan(tri_ref, 0, n_tri)(
        tri_body, (jnp.full(shape, _BIG), jnp.full(shape, -1, jnp.int32)))
    start = tuple(jnp.full(shape, c) for c in cam)
    t_b, idx = _sphere_winners(sph_ref, n_tri, n_sph, start, d, t_b, idx,
                               ar)

    hit = t_b < _BIG
    zero = jnp.zeros(shape)
    pos = _add(start, _scale(jnp.where(hit, t_b, _F(0.0)), d))
    pos = _where3(hit, pos, (zero, zero, zero))
    nrm = _gather_tri(tri_ref, idx, n_tri, 9, 3, 0.0)
    rgb = _gather_tri(tri_ref, idx, n_tri, 12, 3, 0.0)
    (mat,) = _gather_tri(tri_ref, idx, n_tri, 15, 1, 1.0)
    nrm, rgb, mat = _sphere_attrs(sph_ref, n_tri, n_sph, idx, pos, nrm, rgb,
                                  mat, ar)
    return t_b, pos, nrm, rgb, mat, idx


def _nearest_hit(tri_ref, sph_ref, n_tri, n_sph, start, d, ar):
    """Brute-force nearest hit for the ray bundle (start, d): the running-
    best scan of the reference (kernels.cl:92-166) carrying (t, u, v, id),
    then one gather of the winner's attributes. Returns (t, pos, normal,
    rgb, mat, id): id -1 miss, i for triangle i, n_tri + s for sphere s
    (the residual the path-replay backward keys on)."""
    shape = d[0].shape
    zero = jnp.zeros(shape)

    def tri_body(get, gi, carry):
        t_b, u_b, v_b, idx = carry
        v0 = (get(0), get(1), get(2))
        e1 = (get(3), get(4), get(5))
        e2 = (get(6), get(7), get(8))
        b = _sub(start, v0)
        nd = (-d[0], -d[1], -d[2])
        detA = _det3(nd, e1, e2)
        degen = detA == 0
        recip = ar.div(_F(1.0), jnp.where(degen, _F(1.0), detA))
        t = _det3(b, e1, e2) * recip
        u = _det3(nd, b, e2) * recip
        v = _det3(nd, e1, b) * recip
        ok = ((t >= 0) & (u >= 0) & (v >= 0) & ((u + v) <= 1)
              & ~degen & (t < t_b))
        return (jnp.where(ok, t, t_b), jnp.where(ok, u, u_b),
                jnp.where(ok, v, v_b), jnp.where(ok, gi, idx))

    t_b, u_b, v_b, idx = _scan(tri_ref, 0, n_tri)(
        tri_body, (jnp.full(shape, _BIG), zero, zero,
                   jnp.full(shape, -1, jnp.int32)))
    v0 = _gather_tri(tri_ref, idx, n_tri, 0, 3, 0.0)
    e1 = _gather_tri(tri_ref, idx, n_tri, 3, 3, 0.0)
    e2 = _gather_tri(tri_ref, idx, n_tri, 6, 3, 0.0)
    pos = _add(v0, _add(_scale(u_b, e1), _scale(v_b, e2)))
    nrm = _gather_tri(tri_ref, idx, n_tri, 9, 3, 0.0)
    rgb = _gather_tri(tri_ref, idx, n_tri, 12, 3, 0.0)
    (mat,) = _gather_tri(tri_ref, idx, n_tri, 15, 1, 1.0)

    t_tri = t_b
    t_b, idx = _sphere_winners(sph_ref, n_tri, n_sph, start, d, t_b, idx,
                               ar)
    sph_won = t_b < t_tri
    pos = _where3(sph_won, _add(start, _scale(t_b, d)), pos)
    nrm, rgb, mat = _sphere_attrs(sph_ref, n_tri, n_sph, idx, pos, nrm, rgb,
                                  mat, ar)
    return t_b, pos, nrm, rgb, mat, idx


# --------------------------------------------------------------------------
# Kernel
# --------------------------------------------------------------------------

def _render_kernel(tri_ref, sph_ref, cam_ref, off_ref, *refs,
                   cfg: RenderConfig, n_tri: int, n_sph: int, ap: int,
                   tw: int, n_col: int, n_quads: int, n_shd: int,
                   residuals: bool, interpret: bool):
    if n_shd:
        shd_ref, *refs = refs
    else:
        shd_ref = None
    r_ref, g_ref, b_ref, *res_refs = refs
    if residuals:
        # pid: primary hit object id; lit: unoccluded shadow-sample count
        # (0 where the ray has no shading point); bid: per-bounce hit
        # object id. The decision record consumed by the path-replay
        # backward (ops/replay.py).
        pid_ref, lit_ref, *bid = res_refs
        bid_ref = bid[0] if bid else None
    ar = _IEEE_INTERPRET if interpret else _IEEE_TRITON
    blk = pl.program_id(0)
    A = cfg.aa_rays
    ax, ay = cfg.aa_x, cfg.aa_y
    W, H = cfg.width, cfg.height
    shape = (ap, tw)

    # off_ref[0]: global row offset of this launch (0 for a full frame;
    # the dp-shard's first row when rendering a row band under shard_map)
    row = off_ref[0] + blk // n_col
    xs = ((blk % n_col) * tw
          + jax.lax.broadcasted_iota(jnp.int32, shape, 1))
    ys = jnp.full(shape, row)
    gid = jax.lax.bitcast_convert_type(ys * W + xs, jnp.uint32)  # < 2^24
    aa = jax.lax.broadcasted_iota(jnp.int32, shape, 0)

    cam_vals = [cam_ref[k] for k in range(21)]
    r0, r1, r2 = cam_vals[0:3], cam_vals[3:6], cam_vals[6:9]
    cam = tuple(cam_vals[9:12])
    light = tuple(cam_vals[12:15])
    light_rgb = cam_vals[15:18]
    indirect = cam_vals[18:21]

    # --- AA ray generation (kernels.cl:384-407) ---
    bx = (xs.astype(_F) * _F(ax) - _F(W * ax / 2.0)
          + (aa % ax).astype(_F))
    by = (ys.astype(_F) * _F(ay) - _F(H * ay / 2.0)
          + (aa // ax).astype(_F))
    bz = jnp.full(shape, _F(cfg.effective_focal))
    b = (bx, by, bz)
    d = (_dot(r0, b), _dot(r1, b), _dot(r2, b))
    if not cfg.cpu_ref:   # CPU-ref rays stay unnormalized (skeleton.cpp:259)
        dlen = ar.sqrt(_dot(d, d))   # divide (not recip-multiply): parity
        d = (ar.div(d[0], dlen), ar.div(d[1], dlen),  # w/ oracle's normalize
             ar.div(d[2], dlen))

    t_b, pos, normal, rgb, mat, prim_id = _nearest_hit_primary(
        tri_ref, sph_ref, n_tri, n_sph, cam, d, ar)
    hit = t_b < _BIG
    # CPU-ref shades ANY hit triangle (no material logic, skeleton.cpp:268)
    prim_diffuse = hit if cfg.cpu_ref else hit & (mat > 0)
    if residuals:
        pid_ref[...] = prim_id

    # --- specular bounce loop (block-level early exit) ---
    zero = jnp.zeros(shape)
    if cfg.bounces > 0:
        def cond(s):
            # the active mask rides as f32 0/1: max over it is the block's
            # "any ray still bouncing" (there is no reduce_or lowering)
            return (s[0] < cfg.bounces) & (jnp.max(s[1]) > 0)

        def body(s):
            (b_i, active_f, dxc, dyc, dzc, px, py, pz, nx, ny, nz, matc,
             medium, weight, tv_f, tpx, tpy, tpz, tnx, tny, tnz,
             trr, trg, trb) = s
            active = active_f > 0
            dcur = (dxc, dyc, dzc)
            nrm = (nx, ny, nz)
            # reflect (kernels.cl:54-65)
            dn = _dot(dcur, nrm)
            refl = _sub(dcur, _scale(_F(2.0) * dn, nrm))
            # refract (kernels.cl:67-88)
            c1 = _dot(nrm, dcur)
            nflip = _where3(c1 < 0, _scale(_F(-1.0), nrm), nrm)
            c1a = jnp.abs(c1)
            in_air = medium == _F(cfg.ior_air)
            n1 = jnp.where(in_air, _F(cfg.ior_air), _F(cfg.ior_glass))
            n2 = jnp.where(in_air, _F(cfg.ior_glass), _F(cfg.ior_air))
            nr = ar.div(n1, n2)
            k = _F(1.0) - nr * nr * (_F(1.0) - c1a * c1a)
            tir = k < 0
            c2 = ar.sqrt(jnp.where(tir, _F(1.0), k))
            refr = _add(_scale(nr, dcur),
                        _scale(nr * c1a - c2, _scale(_F(-1.0), nflip)))
            is_mirror = matc == 0
            if cfg.quirk_nan_tir:
                alive = active & ~(tir & ~is_mirror)
                use_refl = is_mirror
            else:
                alive = active
                use_refl = is_mirror | tir
            ndir = _where3(use_refl, refl, refr)
            nmed = jnp.where(use_refl, _F(cfg.ior_air), n2)
            nstart = _add((px, py, pz), _scale(_F(cfg.bias), ndir))
            nlen = ar.sqrt(jnp.maximum(_dot(ndir, ndir), _F(1e-30)))
            ndir = (ar.div(ndir[0], nlen), ar.div(ndir[1], nlen),
                    ar.div(ndir[2], nlen))
            if cfg.fresnel:
                r0f = jnp.square(ar.div(n1 - n2, n1 + n2))
                refl_w = r0f + (1 - r0f) * (1 - c1a) ** 5
                w_step = jnp.where(use_refl, _F(1.0), _F(1.0) - refl_w)
                weight = jnp.where(alive, weight * w_step, weight)

            t_n, pos_n, nrm_n, rgb_n, mat_n, id_n = _nearest_hit(
                tri_ref, sph_ref, n_tri, n_sph, nstart, ndir, ar)
            hit_n = t_n < _BIG
            diffuse = alive & hit_n & (mat_n > 0)
            cont = alive & hit_n & (mat_n <= 0)
            if residuals:
                bid_ref[b_i] = jnp.where(alive, id_n, np.int32(-1))
            return (b_i + 1, cont.astype(_F),
                    jnp.where(cont, ndir[0], dxc),
                    jnp.where(cont, ndir[1], dyc),
                    jnp.where(cont, ndir[2], dzc),
                    jnp.where(cont, pos_n[0], px),
                    jnp.where(cont, pos_n[1], py),
                    jnp.where(cont, pos_n[2], pz),
                    jnp.where(cont, nrm_n[0], nx),
                    jnp.where(cont, nrm_n[1], ny),
                    jnp.where(cont, nrm_n[2], nz),
                    jnp.where(cont, mat_n, matc),
                    jnp.where(cont, nmed, medium),
                    weight,
                    jnp.maximum(tv_f, diffuse.astype(_F)),
                    jnp.where(diffuse, pos_n[0], tpx),
                    jnp.where(diffuse, pos_n[1], tpy),
                    jnp.where(diffuse, pos_n[2], tpz),
                    jnp.where(diffuse, nrm_n[0], tnx),
                    jnp.where(diffuse, nrm_n[1], tny),
                    jnp.where(diffuse, nrm_n[2], tnz),
                    jnp.where(diffuse, rgb_n[0], trr),
                    jnp.where(diffuse, rgb_n[1], trg),
                    jnp.where(diffuse, rgb_n[2], trb))

        if residuals:
            # steps skipped by the early exit must read as "inactive"
            for step in range(cfg.bounces):
                bid_ref[step] = jnp.full(shape, -1, jnp.int32)
        init = (np.int32(0), (hit & (mat <= 0)).astype(_F),
                d[0], d[1], d[2], pos[0], pos[1], pos[2],
                normal[0], normal[1], normal[2], mat,
                jnp.full(shape, _F(cfg.ior_air)), jnp.ones(shape), zero,
                zero, zero, zero, zero, zero, zero, zero, zero, zero)
        out = jax.lax.while_loop(cond, body, init)
        weight, term_valid = out[13], out[14] > 0
        term_pos, term_nrm, term_rgb = out[15:18], out[18:21], out[21:24]
    else:
        weight = jnp.ones(shape)
        term_valid = jnp.zeros(shape, jnp.bool_)
        term_pos = term_nrm = term_rgb = (zero, zero, zero)

    # --- unified shading point + one soft-shadow pass ---
    sp_pos = _where3(prim_diffuse, pos, term_pos)
    sp_nrm = _where3(prim_diffuse, normal, term_nrm)
    sdir = _sub(light, sp_pos)
    # CPU-ref shadow bias is the CPU path's relative 1e-3 (skeleton.cpp:229)
    sbias = cfg.cpu_ref_bias if cfg.cpu_ref else cfg.bias
    sstart = _add(sp_pos, _scale(_F(sbias), sdir))
    radius_sq = _dot(sdir, sdir)
    rs_safe = jnp.where(radius_sq == 0, _F(1.0), radius_sq)
    lam_base = ar.div(jnp.maximum(_dot(sdir, sp_nrm), 0.0), _PI4 * rs_safe)
    lam_base = jnp.where(radius_sq == 0, _F(0.0), lam_base)

    gf = _u32_to_f32(gid)
    state = _xorshift3((gid, _f32_to_u32(gf * _F(91.0)),
                        _f32_to_u32(gf * _F(19.0))))
    lit_count = _lit_count(tri_ref, sph_ref, shd_ref, n_tri, n_sph, n_quads,
                           n_shd, sstart, sdir, state, radius_sq, cfg, ar)
    if residuals:
        lit_ref[...] = jnp.where(prim_diffuse | term_valid, lit_count,
                                 _F(0.0))
    dl_scale = ar.div(lit_count * lam_base, _F(cfg.shadow_samples))

    # --- combine (kernels.cl:415-425), AA average over the real AA rays ---
    keep = aa < A
    for c, out_ref in enumerate((r_ref, g_ref, b_ref)):
        dl = light_rgb[c] * dl_scale
        color = jnp.where(prim_diffuse, rgb[c] * (indirect[c] + dl), 0.0)
        if cfg.bounces > 0:
            color = jnp.where(
                term_valid,
                _F(0.9) * (indirect[c] + dl) * term_rgb[c] * weight, color)
        if ap != A:
            color = jnp.where(keep, color, 0.0)
        out_ref[...] = jnp.sum(color, axis=0) * _F(1.0 / A)


def _whole(ndim: int):
    """Index map of a table every program reads whole."""
    return lambda i: (0,) * ndim


def _launch(scene: Scene, cfg: RenderConfig, row0, rows: int, quads,
            interpret: bool, residuals: bool):
    """One pallas_call over a row band [row0, row0+rows) of the logical
    image, its width padded up to the block width; padded lanes render
    harmless off-screen content that is cropped. The kernel's math uses the
    logical cfg dimensions (ray centering, pixel-id RNG seeds)."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused forward kernel compiles only for a GPU (platform "
            f"{jax.default_backend()!r}); pass interpret=True to run it in "
            "the Pallas interpreter")
    A = cfg.aa_rays
    ap = _pow2(A)
    tw = max(1, RAYS_PER_BLOCK // ap)
    n_col = -(-cfg.width // tw)
    wp = n_col * tw
    n_pix = rows * wp
    off = (jnp.zeros((1,), jnp.int32) if row0 is None
           else jnp.asarray(row0, jnp.int32).reshape(1))
    tri, sph, cam = pack_scene(scene)
    n_tri = scene.tri_v0.shape[0]
    # CPU-ref ignores spheres entirely (the vestigial path predates them)
    n_sph = 0 if cfg.cpu_ref else scene.sph_center.shape[0]
    inputs = [_pad_pow2(tri, TRI_COLS), _pad_pow2(sph, SPH_COLS),
              jnp.pad(cam, (0, CAM_LEN - cam.shape[0])), off]
    n_quads = n_shd = 0
    if quads is not None and not cfg.cpu_ref:
        shd = pack_shadow(scene, quads)
        n_quads, n_shd = len(quads[0]), shd.shape[0]
        inputs.append(_pad_pow2(shd, SHD_COLS))
    in_specs = [pl.BlockSpec(x.shape, _whole(x.ndim)) for x in inputs]

    img_spec = pl.BlockSpec((tw,), lambda i: (i,))
    out_specs = [img_spec] * 3
    out_shape = [jax.ShapeDtypeStruct((n_pix,), jnp.float32)] * 3
    if residuals:
        ray_spec = pl.BlockSpec((ap, tw), lambda i: (0, i))
        out_specs += [ray_spec, ray_spec]
        out_shape += [jax.ShapeDtypeStruct((ap, n_pix), jnp.int32),
                      jax.ShapeDtypeStruct((ap, n_pix), jnp.float32)]
        if cfg.bounces > 0:
            out_specs.append(pl.BlockSpec((cfg.bounces, ap, tw),
                                          lambda i: (0, 0, i)))
            out_shape.append(jax.ShapeDtypeStruct((cfg.bounces, ap, n_pix),
                                                  jnp.int32))
    kernel = functools.partial(
        _render_kernel, cfg=cfg, n_tri=n_tri, n_sph=n_sph, ap=ap, tw=tw,
        n_col=n_col, n_quads=n_quads, n_shd=n_shd, residuals=residuals,
        interpret=interpret)
    outs = pl.pallas_call(
        kernel,
        grid=(rows * n_col,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        name="render_fwd",
    )(*inputs)

    def crop(x):
        return x.reshape(x.shape[:-1] + (rows, wp))[..., :cfg.width]

    img = jnp.stack([crop(c) for c in outs[:3]], axis=-1)
    if not residuals:
        return img
    from ..ops.replay import Residuals
    pid, lit = crop(outs[3])[:A], crop(outs[4])[:A]
    bid = (crop(outs[5])[:, :A] if cfg.bounces > 0
           else jnp.zeros((0, A, rows, cfg.width), jnp.int32))
    return img, Residuals(prim_id=pid, lit_cnt=lit, bounce_id=bid)


@functools.partial(jax.jit, static_argnames=("cfg", "rows", "quads",
                                             "interpret"))
def render_fused(scene: Scene, cfg: RenderConfig, row0=None,
                 rows: int | None = None, quads=None,
                 interpret: bool = False) -> jax.Array:
    """Forward render through the fused kernel: image [rows, W, 3] float32.

    Any image size: the launch is padded up to the block width and
    cropped. row0/rows render only a row band of the logical cfg-sized
    image (ray centering and pixel-id RNG stay global), the dp-sharded
    launch path. quads: optional static pairing from
    ops.quads.detect_shadow_quads, the quad-merged occlusion scan. Not
    differentiable directly; render.py wires the path-replay custom_vjp.
    interpret=True runs the kernel in the Pallas interpreter (tests on the
    CPU); otherwise it compiles for the GPU and raises anywhere else.

    cfg.cpu_ref runs the same fused kernel in CPU-ref semantics
    (skeleton.cpp:184-279): unnormalized single rays, triangles only, one
    hard shadow ray with relative bias, no material logic."""
    rows = cfg.height if rows is None else rows
    return _launch(scene, cfg, row0, rows, quads, interpret, False)


@functools.partial(jax.jit, static_argnames=("cfg", "rows", "quads",
                                             "interpret"))
def render_fused_res(scene: Scene, cfg: RenderConfig, row0=None,
                     rows: int | None = None, quads=None,
                     interpret: bool = False):
    """``render_fused`` that also returns the decision residuals consumed
    by the path-replay backward: (image, Residuals)."""
    rows = cfg.height if rows is None else rows
    return _launch(scene, cfg, row0, rows, quads, interpret, True)
