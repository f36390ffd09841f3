"""Unit tests for the jnp ops: RNG parity, reflection/refraction physics,
intersection edge cases, rotation matrices, image packing."""
import numpy as np
import jax.numpy as jnp
import pytest

from uob_raytracer_tpu import cornell_box, RenderConfig
from uob_raytracer_tpu.ops import (
    xorshift, crush, shadow_seed, rotation_matrix, pack_argb,
    prepare_scene, intersect, in_shadow,
)
from uob_raytracer_tpu.ops.shading import _reflect_dir, _refract_dir
from uob_raytracer_tpu.reference import oracle as orc


# --------------------------------------------------------------------- RNG

def test_xorshift_matches_oracle_bitexact():
    gids = np.array([0, 1, 7, 1023, 104 * 128 + 104, 1024 * 1024 - 1],
                    dtype=np.uint32)
    state_j = np.asarray(shadow_seed(jnp.asarray(gids)))
    state_n = orc._shadow_seed(gids)
    np.testing.assert_array_equal(state_j, state_n)
    for _ in range(20):
        state_j = np.asarray(xorshift(jnp.asarray(state_j)))
        state_n = orc._xorshift(state_n)
        np.testing.assert_array_equal(state_j, state_n)


def test_crush_range_and_parity():
    state = orc._xorshift(orc._shadow_seed(np.arange(1000, dtype=np.uint32)))
    c_n = orc._crush(state, 0.05)
    c_j = np.asarray(crush(jnp.asarray(state), 0.05))
    np.testing.assert_array_equal(c_n, c_j)
    assert np.all(np.abs(c_n) <= 0.025 + 1e-7)


def test_seed_float_trunc_quirk():
    # (uint)(gid*91.0f) must go through float32 rounding then truncation —
    # not exact integer multiply (kernels.cl:319).
    gid = np.uint32(11930465)  # 11930465*91 = 1085672315; f32 rounds it up
    f32_lane = np.uint32(np.float32(np.float32(gid) * np.float32(91.0)))
    int_lane = np.uint32(int(gid) * 91 & 0xFFFFFFFF)
    assert f32_lane != int_lane
    got = np.asarray(shadow_seed(jnp.asarray([gid])))[0]
    want = orc._xorshift(np.array([gid, f32_lane,
                                   np.uint32(np.float32(np.float32(gid)
                                                        * np.float32(19.0)))]))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ camera

def test_rotation_matrix_orthonormal():
    R = np.asarray(rotation_matrix(jnp.float32(0.3), jnp.float32(-0.2)))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(R, orc.rotation_matrix(0.3, -0.2), atol=1e-7)


# ------------------------------------------------------------ intersection

@pytest.fixture(scope="module")
def ds():
    return prepare_scene(cornell_box())


def test_center_ray_hits_tall_block(ds):
    # The camera's central ray hits the (rotated) tall blue block, not the
    # back wall — the blocks are angled as in the real Cornell box.
    h = intersect(ds, jnp.array([[0.0, 0.0, -3.2]]),
                  jnp.array([[0.0, 0.0, 1.0]]))
    assert bool(h.hit[0])
    np.testing.assert_allclose(np.asarray(h.rgb)[0], [0.0, 0.2, 0.5])


def test_primary_hit_back_wall(ds):
    # A ray aimed at an upper corner patch of the back wall (clear of both
    # blocks and spheres) lands on it at z=1 with the white albedo.
    o = np.array([0.0, 0.0, -3.2], np.float32)
    target = np.array([0.9, -0.9, 1.0], np.float32)
    d = (target - o) / np.linalg.norm(target - o)
    h = intersect(ds, jnp.asarray(o)[None], jnp.asarray(d)[None])
    assert bool(h.hit[0])
    np.testing.assert_allclose(np.asarray(h.pos)[0, 2], 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h.rgb)[0], [0.75, 0.75, 0.75])


def _sphere_id(ds, center):
    """Object id of the sphere at ``center``: T + sphere index."""
    s = int(np.argmin(np.abs(np.asarray(ds.sph_c) - center).sum(axis=1)))
    return ds.v0.shape[0] + s


def test_sphere_hit_and_normal(ds):
    # Ray toward the glass sphere center from the camera: hits the near
    # surface; normal points back along the ray.
    c = np.array([0.3, 0.1, -0.5], np.float32)
    o = np.array([0.0, 0.0, -3.2], np.float32)
    d = (c - o) / np.linalg.norm(c - o)
    h = intersect(ds, jnp.asarray(o)[None], jnp.asarray(d)[None])
    assert int(h.obj_id[0]) == _sphere_id(ds, c) and float(h.mat[0]) == -1.0
    r = np.linalg.norm(np.asarray(h.pos)[0] - c)
    np.testing.assert_allclose(r, np.sqrt(0.075), rtol=1e-5)
    assert np.dot(np.asarray(h.normal)[0], d) < -0.99


def test_ray_from_inside_sphere(ds):
    # Origin at the glass sphere's center: x_min < 0 so x_max is taken.
    o = jnp.array([[0.3, 0.1, -0.5]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    h = intersect(ds, o, d)
    assert int(h.obj_id[0]) == _sphere_id(ds, np.float32([0.3, 0.1, -0.5]))
    np.testing.assert_allclose(float(h.t[0]), np.sqrt(0.075), rtol=1e-5)


def test_miss_behind_camera(ds):
    h = intersect(ds, jnp.array([[0.0, 0.0, -3.2]]),
                  jnp.array([[0.0, 0.0, -1.0]]))
    assert not bool(h.hit[0]) and int(h.obj_id[0]) == -1


def test_degenerate_parallel_ray(ds):
    # Ray parallel to the floor plane: detA == 0 for floor triangles; must
    # not produce NaN or a bogus hit at t=0.
    h = intersect(ds, jnp.array([[0.0, 0.99, -3.2]]),
                  jnp.array([[0.0, 0.0, 1.0]]))
    assert np.isfinite(np.asarray(h.t)[0])


def _occluded(ds, p, target):
    p = np.asarray(p, np.float32)
    sdir = np.asarray(target, np.float32) - p
    occ = in_shadow(ds, jnp.asarray(p)[None], jnp.asarray(sdir)[None],
                    jnp.asarray([np.dot(sdir, sdir)]))
    return bool(occ[0])


def test_glass_casts_no_shadow(ds):
    # Segment along z through the glass sphere's center, clear of all other
    # geometry: occlusion must ignore glass (kernels.cl:247,279).
    assert not _occluded(ds, [0.3, 0.1, -0.95], [0.3, 0.1, -0.05])


def test_mirror_casts_shadow(ds):
    # Same construction through the mirror sphere: occluded.
    assert _occluded(ds, [-0.4, 0.8, -0.9], [-0.4, 0.8, -0.1])


# ----------------------------------------------------------- reflect/refract

def test_reflect_mirror_law():
    d = jnp.array([[0.6, -0.8, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    r = np.asarray(_reflect_dir(d, n))[0]
    np.testing.assert_allclose(r, [0.6, 0.8, 0.0], atol=1e-6)


def test_refract_snell():
    cfg = RenderConfig()
    d = jnp.array([[np.sin(0.5), -np.cos(0.5), 0.0]], dtype=jnp.float32)
    n = jnp.array([[0.0, 1.0, 0.0]])
    medium = jnp.array([1.0], dtype=jnp.float32)
    out, n2, tir, c1a, _, _ = _refract_dir(cfg, d, n, medium)
    out = np.asarray(out)[0]
    out = out / np.linalg.norm(out)
    # Snell: sin(theta_t) = sin(0.5)/1.52
    assert not bool(tir[0])
    np.testing.assert_allclose(abs(out[0]), np.sin(0.5) / 1.52, rtol=1e-5)
    assert float(n2[0]) == np.float32(1.52)


def test_refract_tir_detected():
    cfg = RenderConfig()
    # Grazing exit from glass: angle beyond critical (~41.1 deg).
    ang = np.deg2rad(60.0)
    d = jnp.array([[np.sin(ang), -np.cos(ang), 0.0]], dtype=jnp.float32)
    n = jnp.array([[0.0, 1.0, 0.0]])
    medium = jnp.array([1.52], dtype=jnp.float32)
    _, _, tir, _, _, _ = _refract_dir(cfg, d, n, medium)
    assert bool(tir[0])


# ------------------------------------------------------------------- image

def test_pack_argb_matches_oracle():
    img = np.random.RandomState(0).uniform(-0.1, 1.2, (7, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(pack_argb(jnp.asarray(img))),
                                  orc.pack_argb_np(img))


def test_pack_argb_truncates():
    img = np.full((1, 1, 3), 0.999, np.float32)  # 254.745 -> 254 (trunc)
    packed = int(np.asarray(pack_argb(jnp.asarray(img)))[0, 0])
    assert (packed >> 16) & 0xFF == 254
