"""WorldBuilders: samplers x layers x clippers x mixer."""

import numpy as np
import pytest

from husky_rover_mppi import worldbuilders as wb


def test_uniform_plane():
    layer = wb.Layer_Factory.get(
        wb.Plane_T(xmin=-2, xmax=3, ymin=1, ymax=4),
        wb.UniformSampler_T(randomization_space=2, min=(-2, 1), max=(3, 4), seed=0),
    )
    pts = layer(1000)
    assert pts.shape == (1000, 2)
    assert pts[:, 0].min() >= -2 and pts[:, 0].max() <= 3
    assert pts[:, 1].min() >= 1 and pts[:, 1].max() <= 4


def test_disk_layer_annulus():
    layer = wb.Layer_Factory.get(
        wb.Disk_T(center=(1.0, -1.0), radius_min=0.5, radius_max=2.0),
        wb.UniformSampler_T(randomization_space=2, min=(0, 0), max=(1, 1), seed=1),
    )
    pts = layer(2000)
    r = np.linalg.norm(pts - np.array([1.0, -1.0]), axis=-1)
    assert r.min() >= 0.5 - 1e-9 and r.max() <= 2.0 + 1e-9
    # area-correct: mean radius of uniform annulus = 2(r2^3-r1^3)/(3(r2^2-r1^2))
    expect = 2 * (2.0**3 - 0.5**3) / (3 * (2.0**2 - 0.5**2))
    assert abs(r.mean() - expect) < 0.05


def test_circle_layer_on_ring():
    layer = wb.Layer_Factory.get(
        wb.Circle_T(center=(0, 0), radius=2.0, alpha=1.0, beta=0.5),
        wb.UniformSampler_T(randomization_space=1, min=(0,), max=(2 * np.pi,), seed=2),
    )
    pts = layer(500)
    assert np.allclose((pts[:, 0] / 2.0) ** 2 + (pts[:, 1] / 1.0) ** 2, 1.0, atol=1e-9)


def test_sphere_cylinder_cone_torus_within_bounds():
    sampler = lambda seed: wb.UniformSampler_T(
        randomization_space=3, min=(0, 0, 0), max=(1, 1, 1), seed=seed
    )
    sph = wb.Layer_Factory.get(
        wb.Sphere_T(center=(0, 0, 0), radius_min=1.0, radius_max=2.0), sampler(3)
    )(800)
    r = np.linalg.norm(sph, axis=-1)
    assert r.min() >= 1.0 - 1e-9 and r.max() <= 2.0 + 1e-9

    cyl = wb.Layer_Factory.get(
        wb.Cylinder_T(radius_max=1.5, height_min=-1, height_max=1), sampler(4)
    )(800)
    assert np.linalg.norm(cyl[:, :2], axis=-1).max() <= 1.5 + 1e-9
    assert cyl[:, 2].min() >= -1 and cyl[:, 2].max() <= 1

    cone = wb.Layer_Factory.get(
        wb.Cone_T(radius_max=2.0, height_min=0, height_max=1), sampler(5)
    )(800)
    frac = 1.0 - cone[:, 2]
    assert np.all(np.linalg.norm(cone[:, :2], axis=-1) <= 2.0 * frac + 1e-6)

    torus = wb.Layer_Factory.get(
        wb.Torus_T(ring_radius=3.0, tube_radius_max=0.5), sampler(6)
    )(800)
    ring_d = np.abs(np.linalg.norm(torus[:, :2], axis=-1) - 3.0)
    assert np.all(np.sqrt(ring_d**2 + torus[:, 2] ** 2) <= 0.5 + 1e-6)


def test_polygon_layer():
    tri = wb.Polygon_T(vertices=((0, 0), (4, 0), (0, 4)))
    layer = wb.Layer_Factory.get(
        tri, wb.UniformSampler_T(randomization_space=2, min=(0, 0), max=(4, 4), seed=7)
    )
    pts = layer(500)
    assert pts.shape[0] > 0
    assert np.all(pts[:, 0] + pts[:, 1] <= 4 + 1e-9)


def test_transform_2d():
    tr = wb.Transformation2D_T(
        translation=wb.Translation2D_T(x=10.0, y=-5.0),
        orientation=wb.Rot2D_T(theta=np.pi / 2),
    )
    layer = wb.Layer_Factory.get(
        wb.Plane_T(xmin=0, xmax=1, ymin=0, ymax=0, transform=tr),
        wb.UniformSampler_T(randomization_space=2, min=(0, 0), max=(1, 0), seed=8),
    )
    pts = layer(100)
    # a segment along +x rotates onto +y then translates
    assert np.allclose(pts[:, 0], 10.0, atol=1e-9)
    assert pts[:, 1].min() >= -5.0 - 1e-9 and pts[:, 1].max() <= -4.0 + 1e-9


def test_hardcore_uniform_min_distance():
    layer = wb.Layer_Factory.get(
        wb.Plane_T(xmin=0, xmax=10, ymin=0, ymax=10),
        wb.HardCoreUniformSampler_T(
            randomization_space=2, min=(0, 0), max=(10, 10), seed=9,
            core_radius=1.0, num_repeat=1,
        ),
    )
    pts = layer(200)
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() >= 1.0 - 1e-9


def test_matern_and_thomas_cluster():
    for cfg in [
        wb.MaternClusterPointSampler_T(
            randomization_space=2, lambda_parent=0.05, lambda_daughter=20,
            cluster_radius=1.0, seed=10,
        ),
        wb.ThomasClusterSampler_T(
            randomization_space=2, lambda_parent=0.05, lambda_daughter=20,
            sigma=0.5, seed=11,
        ),
    ]:
        layer = wb.Layer_Factory.get(
            wb.Plane_T(xmin=0, xmax=20, ymin=0, ymax=20), cfg
        )
        pts = layer(1)
        assert pts.shape[0] > 20
        from scipy.spatial import cKDTree

        d, _ = cKDTree(pts).query(pts, k=2)
        area = 400.0
        uniform_nn = 0.5 / np.sqrt(pts.shape[0] / area)
        assert d[:, 1].mean() < 0.8 * uniform_nn  # clustered


def test_poisson_point_sampler_density():
    layer = wb.Layer_Factory.get(
        wb.Plane_T(xmin=0, xmax=10, ymin=0, ymax=10),
        wb.PoissonPointSampler_T(randomization_space=2, lambda_poisson=2, seed=12),
    )
    pts = layer(1)
    assert abs(pts.shape[0] - 200) < 60


def test_linear_and_deterministic():
    lin = wb.Layer_Factory.get(
        wb.Line_T(xmin=0, xmax=1),
        wb.LinearInterpolationSampler_T(randomization_space=1, min=(0,), max=(1,), seed=0),
    )(5)
    np.testing.assert_allclose(lin[:, 0], np.linspace(0, 1, 5))

    det = wb.Layer_Factory.get(
        wb.Plane_T(xmin=0, xmax=1, ymin=0, ymax=1),
        wb.DeterministicSampler_T(
            randomization_space=2, data=np.array([[0.1, 0.2], [0.3, 0.4]])
        ),
    )(2)
    np.testing.assert_allclose(det, [[0.1, 0.2], [0.3, 0.4]])


def test_image_layer_mask_weighting():
    mask = np.zeros((20, 20))
    mask[:, 10:] = 1.0  # only the x >= 10*mpp half is allowed
    layer = wb.Layer_Factory.get(
        wb.Image_T(data=mask, mpp_resolution=1.0),
        wb.UniformSampler_T(
            randomization_space=2, min=(0, 0), max=(20, 20), seed=13,
            use_image_sampling=True,
        ),
    )
    pts = layer(300)
    assert np.all(pts[:, 0] >= 10.0)


def test_height_clipper_origin_modes(rng):
    img = rng.normal(size=(16, 16))
    q = np.array([[3.2, 4.7], [8.1, 1.3]])
    for origin in ["lower", "upper", "center"]:
        clip = wb.HeightClipper(wb.ImageClipper_T(
            randomization_space=1, resolution=(16, 16), mpp_resolution=1.0,
            data=img, loc_origin=origin,
        ))
        out = clip(query_point=q)
        assert out.shape == (2, 1)
        if origin == "upper":
            assert out[0, 0] == img[4, 3]
        if origin == "lower":
            assert out[0, 0] == img[15 - 4, 3]


def test_normal_map_clipper_unit_quats(rng):
    img = rng.normal(size=(16, 16)) * 0.1
    clip = wb.NormalMapClipper(wb.NormalMapClipper_T(
        randomization_space=1, resolution=(16, 16), mpp_resolution=1.0, data=img,
    ))
    q = clip(query_point=np.array([[5.0, 5.0], [2.0, 9.0]]))
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-9)


def test_request_mixer_full_pipeline(rng):
    """Point process drives the count; height + orientation clipped from a
    DEM; missing scale axes default-filled (Mixer.py:22-176 semantics)."""
    dem = rng.normal(size=(32, 32)) * 0.1
    reqs = (
        wb.UserRequest_T(
            p_type=wb.Position_T(),
            sampler=wb.ThomasClusterSampler_T(
                randomization_space=2, lambda_parent=0.05, lambda_daughter=10,
                sigma=0.5, seed=3,
            ),
            layer=wb.Plane_T(xmin=0, xmax=30, ymin=0, ymax=30),
            axes=["x", "y"],
        ),
        wb.UserRequest_T(
            p_type=wb.Position_T(),
            sampler=wb.ImageClipper_T(
                randomization_space=1, resolution=(32, 32), mpp_resolution=1.0,
                data=dem, loc_origin="upper",
            ),
            layer=wb.Line_T(xmin=0, xmax=1),
            axes=["z"],
        ),
        wb.UserRequest_T(
            p_type=wb.Scale_T(),
            sampler=wb.UniformSampler_T(
                randomization_space=1, min=(0.5,), max=(1.5,), seed=4
            ),
            layer=wb.Line_T(xmin=0.5, xmax=1.5),
            axes=["xyz"],
        ),
        wb.UserRequest_T(
            p_type=wb.OrientationParam_T(),
            sampler=wb.NormalMapClipper_T(
                randomization_space=1, resolution=(32, 32), mpp_resolution=1.0,
                data=dem, loc_origin="upper",
            ),
            layer=wb.RollPitchYaw_T(output_space=4),
            axes=["x", "y", "z", "w"],
        ),
    )
    mixer = wb.RequestMixer(reqs)
    out = mixer(num=1)
    n = out["xformOp:translation"].shape[0]
    assert n > 5
    assert out["xformOp:translation"].shape == (n, 3)
    assert out["xformOp:scale"].shape == (n, 3)
    assert out["xformOp:orientation"].shape == (n, 4)
    # uniform scale replicated across xyz
    s = out["xformOp:scale"]
    np.testing.assert_allclose(s[:, 0], s[:, 1])
    np.testing.assert_allclose(s[:, 0], s[:, 2])
    assert s.min() >= 0.5 and s.max() <= 1.5
    # z column matches direct DEM lookup of the sampled xy
    xy = out["xformOp:translation"][:, :2]
    u = np.clip((xy[:, 0] // 1.0).astype(int), 0, 31)
    v = np.clip((xy[:, 1] // 1.0).astype(int), 0, 31)
    np.testing.assert_allclose(out["xformOp:translation"][:, 2], dem[v, u])
    # orientation quaternions are unit
    np.testing.assert_allclose(
        np.linalg.norm(out["xformOp:orientation"], axis=-1), 1.0, atol=1e-9
    )


def test_mixer_default_fill():
    reqs = (
        wb.UserRequest_T(
            p_type=wb.Position_T(),
            sampler=wb.UniformSampler_T(
                randomization_space=2, min=(0, 0), max=(1, 1), seed=5
            ),
            layer=wb.Plane_T(xmin=0, xmax=1, ymin=0, ymax=1),
            axes=["x", "y"],
        ),
    )
    out = wb.RequestMixer(reqs)(num=7)
    t = out["xformOp:translation"]
    assert t.shape == (7, 3)
    np.testing.assert_allclose(t[:, 2], 0.0)  # default z
