"""Tests for rendering post-fx and checkpoint/resume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from husky_rover_mppi.aux import (
    ChromaticAberrationsConf,
    FlaresConf,
    MotionBlurConf,
    RenderSettings,
    apply_chromatic_aberrations,
    apply_lens_flare,
    apply_motion_blur,
    apply_post_fx,
    checkpoint,
    chromatic_aberration,
    lens_flare,
    motion_blur,
)
from husky_rover_mppi.aux.render_fx import starburst_kernel


def _test_image(h=64, w=64):
    """Dark field with one bright blob off-center."""
    yy, xx = np.mgrid[0:h, 0:w]
    blob = np.exp(-(((xx - 40) ** 2 + (yy - 20) ** 2) / 8.0))
    img = 0.1 + 0.9 * blob
    return jnp.asarray(np.stack([img] * 3, -1), jnp.float32)


def test_settings_surface_mirrors_rtx_keys():
    s = RenderSettings()
    apply_lens_flare(FlaresConf(enable=True, scale=0.7, blades=5), s)
    assert s.get("/rtx/post/lensFlares/enabled") is True
    assert s.get("/rtx/post/lensFlares/flareScale") == 0.7
    assert s.get("/rtx/post/lensFlares/blades") == 5
    apply_chromatic_aberrations(
        ChromaticAberrationsConf(enable=True, strength=(0.1, 0.0, -0.1)), s
    )
    assert s.get("/rtx/post/chromaticAberration/strengthR") == 0.1
    apply_motion_blur(MotionBlurConf(enable=True, num_samples=4), s)
    assert s.get("/rtx/post/motionblur/numSamples") == 4


def test_chromatic_aberration_shifts_channels_apart():
    img = _test_image()
    out = chromatic_aberration(img, jnp.asarray([0.05, 0.0, -0.05]))
    # Green channel untouched (strength 0), R and B displaced differently.
    np.testing.assert_allclose(np.asarray(out[..., 1]), np.asarray(img[..., 1]), atol=1e-5)
    assert float(jnp.abs(out[..., 0] - img[..., 0]).max()) > 1e-3
    assert float(jnp.abs(out[..., 0] - out[..., 2]).max()) > 1e-3


def test_chromatic_aberration_barrel_is_radius_dependent():
    img = _test_image()
    out = chromatic_aberration(
        img, jnp.asarray([0.2, 0.0, 0.0]), models=("Barrel", "Radial", "Radial")
    )
    # center pixel unchanged under barrel (r=0), unlike pure radial
    c = img.shape[0] // 2
    assert abs(float(out[c, c, 0] - img[c, c, 0])) < 1e-4


def test_lens_flare_adds_energy_around_bright_source():
    img = _test_image()
    out = lens_flare(img, jnp.asarray(0.5), 6, jnp.asarray(0.0), 12)
    diff = np.asarray(out - img).sum(-1)
    assert diff.min() >= -1e-5          # purely additive
    assert diff.max() > 1e-3            # visible streaks
    # energy concentrated near the blob, not uniformly
    assert diff[20, 40] > diff[60, 5]


def test_starburst_kernel_normalized_and_bladed():
    k = np.asarray(starburst_kernel(6, 0.0, 10))
    assert k.shape == (21, 21)
    np.testing.assert_allclose(k.sum(), 1.0, rtol=1e-5)
    assert k[10, 10] == k.max()


def test_motion_blur_smears_along_velocity():
    img = _test_image()
    out = motion_blur(
        img, jnp.asarray([8.0, 0.0]), jnp.asarray(1.0), jnp.asarray(0.5), 8
    )
    # blur reduces the peak and keeps total energy approximately
    assert float(out.max()) < float(img.max())
    np.testing.assert_allclose(float(out.mean()), float(img.mean()), rtol=0.05)
    # horizontal smear: variance along x grows more than along y
    row = np.asarray(out[20, :, 0])
    col = np.asarray(out[:, 40, 0])
    row0 = np.asarray(img[20, :, 0])
    col0 = np.asarray(img[:, 40, 0])
    assert (row > 0.2).sum() > (row0 > 0.2).sum()
    assert abs(int((col > 0.2).sum()) - int((col0 > 0.2).sum())) <= 2


def test_apply_post_fx_pipeline_respects_enables():
    img = _test_image()
    s = RenderSettings()  # everything disabled by default
    out = apply_post_fx(img, s)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-6)
    apply_lens_flare(FlaresConf(enable=True, scale=0.5), s)
    apply_motion_blur(MotionBlurConf(enable=True), s)
    out2 = apply_post_fx(img, s, velocity_px=(6.0, 0.0))
    assert float(jnp.abs(out2 - img).max()) > 1e-4
    assert float(out2.max()) <= 1.0 and float(out2.min()) >= 0.0


# -- checkpoint/resume -------------------------------------------------------


def test_checkpoint_roundtrip_loop_state(tmp_path):
    from husky_rover_mppi.core import HeightField
    from husky_rover_mppi.env import (
        ClosedLoopConfig,
        RoverState,
        init_loop_state,
    )
    from husky_rover_mppi.terrain import crater_surface

    hf = HeightField.create(
        crater_surface(64, 8.0, [((1.0, 1.0), 1.0, 2.0)], dtype=jnp.float32),
        8.0, dtype=jnp.float32,
    )
    cfg = ClosedLoopConfig()
    rovers = RoverState.create(np.array([[1.0, 2.0], [-3.0, 0.5]]),
                               [1.0, 0.0, 0.0], hf)
    state = init_loop_state(cfg, rovers, jnp.float32)
    state = state._replace(err_total=state.err_total + 0.25)

    path = tmp_path / "ckpt.npz"
    checkpoint.save(path, state, {"step": 17})
    template = init_loop_state(cfg, rovers, jnp.float32)
    restored, meta = checkpoint.restore(path, template)
    assert meta == {"step": 17}
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = tmp_path / "x.npz"
    checkpoint.save(path, {"a": jnp.zeros((3,))})
    with pytest.raises(ValueError):
        checkpoint.restore(path, {"a": jnp.zeros((4,))})
    with pytest.raises(KeyError):
        checkpoint.restore(path, {"b": jnp.zeros((3,))})


def test_cli_rendering_group_drives_sdg_postfx(tmp_path, capsys):
    """The cfg/rendering group actually changes SDG output: with chromatic
    aberration enabled the recorded RGB differs from the effects-off run
    (startSim parity: the rendering config is applied before the SDG loop)."""
    import json

    import numpy as np
    import yaml

    from husky_rover_mppi import cli

    def run(rendering, out_dir):
        cfg = {
            "mode": "sdg",
            "sdg": {"num_images": 1, "data_dir": str(out_dir)},
            "rendering": rendering,
        }
        path = tmp_path / f"{out_dir.name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        assert cli.main([f"--config={path}"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        run_dir = list(out_dir.iterdir())[0]
        rgbs = sorted(run_dir.glob("rgb_*.npy")) + sorted(run_dir.glob("*.npy"))
        return np.load(rgbs[0])

    plain = run({"flares": {"enable": False}}, tmp_path / "plain")
    fx = run(
        {"chromatic_aberration": {"enable": True,
                                  "strength": [-0.2, 0.1, 0.25]}},
        tmp_path / "fx",
    )
    assert plain.shape == fx.shape
    assert not np.allclose(plain, fx)


def test_checkpoint_path_without_npz_suffix_roundtrips(tmp_path):
    """np.savez silently appends .npz; save and resume must agree on the
    file for a bare `checkpoint: {path: traverse.ckpt}` config."""
    state = {"a": jnp.arange(4.0), "b": jnp.ones((2, 2))}
    bare = tmp_path / "traverse.ckpt"
    checkpoint.save(bare, state, {"step": 3})
    assert checkpoint.load_metadata(bare) == {"step": 3}
    restored, meta = checkpoint.restore(
        bare, {"a": jnp.zeros(4), "b": jnp.zeros((2, 2))})
    np.testing.assert_allclose(np.asarray(restored["a"]), np.arange(4.0))
    assert meta == {"step": 3}
