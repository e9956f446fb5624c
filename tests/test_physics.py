"""Deformation engine + terramechanics solver."""

import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.physics import (
    BoundaryDistributionConf,
    DeformationEngine,
    DeformationEngineConf,
    DepthDistributionConf,
    RobotParameter,
    TerrainMechanicalParameter,
    TerramechanicsSolver,
)


def _engine(depth="uniform", boundary="uniform"):
    conf = DeformationEngineConf(
        terrain_resolution=0.05, terrain_width=10.0, terrain_height=10.0,
        depth=DepthDistributionConf(distribution=depth),
        boundary=BoundaryDistributionConf(distribution=boundary),
    )
    return DeformationEngine(conf)


def test_footprint_profile_shape():
    eng = _engine()
    # 0.1 m x 0.25 m footprint at 0.05 m -> 3 x 6 grid of points
    assert eng.profile.shape[1] == 2
    assert eng.profile.shape[0] == eng.px_width * eng.px_height
    assert np.abs(eng.profile[:, 0]).max() <= 0.05 + 1e-9
    assert np.abs(eng.profile[:, 1]).max() <= 0.125 + 1e-9


def test_deform_carves_trench():
    eng = _engine()
    dem = jnp.zeros((200, 200))
    num_pass = jnp.zeros((200, 200), jnp.int32)
    pos = jnp.asarray([[5.0, 5.0, 0.0]])
    quat = jnp.asarray([[1.0, 0.0, 0.0, 0.0]])  # identity wxyz (scalar first)
    forces = jnp.asarray([100.0])
    dem2, np2 = eng.deform(dem, num_pass, pos, quat, forces)
    assert float(dem2.min()) < 0.0          # soil pushed down
    assert int(np2.sum()) > 0
    # deformation localized around the footprint
    y = int(eng.sim_height - 5.0 / 0.05)
    x = int(5.0 / 0.05)
    assert abs(float(dem2[y, x])) > 0 or abs(float(dem2[y - 1, x])) > 0
    assert float(jnp.abs(dem2[:50, :50]).sum()) == 0.0


def test_deform_decay_on_repeat():
    eng = _engine()
    dem = jnp.zeros((200, 200))
    num_pass = jnp.zeros((200, 200), jnp.int32)
    pos = jnp.asarray([[5.0, 5.0, 0.0]])
    quat = jnp.asarray([[1.0, 0.0, 0.0, 0.0]])  # identity wxyz
    forces = jnp.asarray([100.0])
    dem1, num_pass = eng.deform(dem, num_pass, pos, quat, forces)
    first = float(dem1.min())
    dem2, num_pass = eng.deform(dem1, num_pass, pos, quat, forces)
    second = float(dem2.min()) - first
    # second pass decays by deform_decay_ratio (0.01)
    assert abs(second) < abs(first) * 0.05


def test_depth_distributions_all_kinds():
    for depth in ["uniform", "sinusoidal", "trapezoidal"]:
        for boundary in ["uniform", "parabolic", "trapezoidal"]:
            eng = _engine(depth, boundary)
            assert np.isfinite(np.asarray(eng.depth_dist)).all()
            assert np.isfinite(np.asarray(eng.boundary_dist)).all()
            # boundary distribution is <= 0 (pushes down)
            assert np.asarray(eng.boundary_dist).max() <= 1e-6


def test_terramechanics_forces():
    solver = TerramechanicsSolver(
        RobotParameter(wheel_radius=0.165, wheel_base=0.25),
        TerrainMechanicalParameter(),
    )
    v = jnp.asarray([0.5, 1.0, 1.5, 0.2])
    omega = jnp.asarray([4.0, 7.0, 9.5, 1.0])
    sinkage = jnp.asarray([0.01, 0.02, 0.015, 0.03])
    forces, torques = solver.compute_force_and_torque(v, omega, sinkage)
    assert forces.shape == (4, 3) and torques.shape == (4, 3)
    f = np.asarray(forces)
    t = np.asarray(torques)
    assert np.isfinite(f).all() and np.isfinite(t).all()
    assert np.all(f[:, 1] == 0) and np.all(t[:, 0] == 0) and np.all(t[:, 2] == 0)
    # driving wheels (wr > v) produce positive resistance torque; the
    # braking wheel (v=0.2, w=1.0 -> wr < v) reverses sign
    driving = np.asarray(v) < np.asarray(omega) * solver.robot.wheel_radius
    assert np.all(t[driving, 1] > 0)
    assert np.all(t[~driving, 1] < 0)


def test_terramechanics_slip_ratio_branches():
    solver = TerramechanicsSolver()
    r = solver.robot.wheel_radius
    # driving: v < w r -> 1 - v/(wr)
    s = float(solver.slip_ratio(jnp.asarray(0.5), jnp.asarray(5.0)))
    np.testing.assert_allclose(s, 1 - 0.5 / (5.0 * r), rtol=1e-5)
    # braking: v > w r -> wr/v - 1
    s = float(solver.slip_ratio(jnp.asarray(2.0), jnp.asarray(5.0)))
    np.testing.assert_allclose(s, 5.0 * r / 2.0 - 1, rtol=1e-5)


def test_terramechanics_quadrature_converges():
    """Gauss-Legendre order 32 agrees with scipy.quad on one wheel."""
    import scipy.integrate as integ

    solver = TerramechanicsSolver()
    v, omega, sk = 0.5, 5.0, 0.02
    slip = float(solver.slip_ratio(jnp.asarray(v), jnp.asarray(omega)))
    r = solver.robot.wheel_radius
    t = solver.terrain
    theta_f = np.arctan(1 - sk / r)
    theta_m = (t.a_0 + t.a_1 * slip) * theta_f
    sigma_max = ((t.c * t.k_c) + (t.rho * 9.81 * solver.robot.wheel_base * t.k_phi)) * (
        r / solver.robot.wheel_base
    ) ** t.n

    def tau_lower(th):
        j = r * (theta_f - th - (1 - slip) * (np.sin(theta_f) - np.sin(th)))
        sigma = sigma_max * (np.cos(th) - np.cos(theta_f))
        return (t.c + sigma * np.tan(t.phi)) * (1 - np.exp(-j / t.K))

    ref, _ = integ.quad(tau_lower, theta_m, theta_f)
    from husky_rover_mppi.physics.terramechanics import _integrate

    got = float(_integrate(
        lambda th: solver._tau(
            th, jnp.asarray([theta_f])[:, None], jnp.asarray([theta_m])[:, None],
            jnp.asarray([0.0])[:, None], sigma_max, jnp.asarray([slip])[:, None],
            False,
        ),
        jnp.asarray([theta_m]), jnp.asarray([theta_f]),
    )[0])
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_footprint_rotation_wxyz_yaw():
    """The footprint heading extraction is wxyz (Isaac get_world_poses
    scalar-first — deformation_engine.py:651-652): a yaw-90 quaternion
    rotates the footprint's +x offsets onto +y."""
    conf = DeformationEngineConf(terrain_resolution=0.1)
    eng = DeformationEngine(conf)
    pos = jnp.asarray([[0.0, 0.0, 0.0]])
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    quat = jnp.asarray([[c, 0.0, 0.0, s]])  # yaw = 90 deg, wxyz
    pts = np.asarray(eng.footprint_in_global(pos, quat))
    base = np.asarray(eng.footprint_in_global(
        pos, jnp.asarray([[1.0, 0.0, 0.0, 0.0]])))
    # rotation by 90 deg: (x, y) -> (-y, x)
    np.testing.assert_allclose(pts[:, 0], -base[:, 1], atol=1e-5)
    np.testing.assert_allclose(pts[:, 1], base[:, 0], atol=1e-5)
