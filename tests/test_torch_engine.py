"""PyTorch port, the whole slice: one progressive iteration rendered by the
port and by the JAX package, same scene, settings and seed, compared pixel
by pixel.

The RNG streams are bit-identical, so the two images sample the same paths;
they can only part where a few-ulp difference (XLA's CPU backend contracts
multiply-adds, torch does not) flips a discrete decision. The criterion is
the share of pixels that differ by more than 1e-4 in any channel: it must be
under 1%. Measured on the CPU at these sizes: 0.0% for both scenes (the
images were bit-identical).
"""
import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu import render as jax_render
from pathtracer_tpu_torch import load_scene, render
from pathtracer_tpu_torch.engine.wavefront import (lanes_to_image,
                                                   render_iteration,
                                                   zero_accum)
from pathtracer_tpu_torch.io.image import save_png
from pathtracer_tpu_torch.scene.fixtures import scene_path

torch.set_num_threads(2)


@pytest.mark.parametrize("name,res,depth", [("teapot", 32, 3),
                                            ("cornell", 64, 4)])
def test_one_iteration_matches_jax(name, res, depth):
    overrides = {"RES": [res, res], "DEPTH": depth}
    j_scene, j_set = jax_load_scene(scene_path(name), overrides=overrides)
    p_scene, p_set = load_scene(scene_path(name), "cpu", overrides=overrides)
    img_j = np.asarray(jax_render(j_scene, j_set, iterations=1, seed=0))
    img_p = render(p_scene, p_set, iterations=1, seed=0)
    assert img_p.shape == (res, res, 3) and img_p.dtype == np.float32
    assert np.isfinite(img_p).all() and img_p.max() > 0
    differs = np.abs(img_p - img_j).max(axis=-1) > 1e-4
    assert differs.mean() < 0.01, differs.mean()


def test_fixed_depth_and_early_exit_agree():
    """The early-exit loop stops only when no path is live, so it must give
    the fixed-depth loop's image exactly."""
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [32, 32], "DEPTH": 5})
    a = render_iteration(scene, settings, zero_accum(settings, "cpu"), 1,
                         early_exit=True)
    b = render_iteration(scene, settings, zero_accum(settings, "cpu"), 1,
                         early_exit=False)
    for ca, cb in zip(a, b):
        torch.testing.assert_close(ca, cb, rtol=0, atol=0)


def test_accumulation_is_in_place_and_additive():
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [16, 16], "DEPTH": 3})
    accum = zero_accum(settings, "cpu")
    out = render_iteration(scene, settings, accum, 1)
    assert out is accum
    first = accum.x.clone()
    render_iteration(scene, settings, accum, 2)
    second = render_iteration(scene, settings, zero_accum(settings, "cpu"), 2)
    torch.testing.assert_close(accum.x, first + second.x)


def test_lanes_to_image_inverts_tile_order():
    scene, settings = load_scene(scene_path("teapot"), "cpu",
                                 overrides={"RES": [64, 64]})
    assert settings.tile == (32, 32)
    pm = settings.pixel_map()(torch.arange(settings.pixel_count))
    lane_vals = pm.to(torch.float32)      # each lane holds its pixel id
    img = lanes_to_image(type(zero_accum(settings, "cpu"))(
        lane_vals, lane_vals, lane_vals), settings)
    np.testing.assert_array_equal(img[..., 0].reshape(-1),
                                  np.arange(64 * 64, dtype=np.float32))
    assert dataclasses.replace(settings, tile=None).pixel_map()(5) == 5


def test_command_line_render_writes_png(tmp_path, capsys):
    from pathtracer_tpu_torch.__main__ import main

    out = tmp_path / "teapot.png"
    main([scene_path("teapot"), "--res", "16", "--spp", "1", "--depth", "2",
          "--out", str(out), "--seed", "3"])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "16x16 d2 1 iterations on cpu" in capsys.readouterr().out


def test_save_png_round_trip(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(0).uniform(-0.2, 1.2, size=(5, 7, 3))
    path = save_png(img, str(tmp_path / "x.png"))
    back = np.asarray(PIL.open(path).convert("RGB"))
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)[:, ::-1, :]
    np.testing.assert_array_equal(back, want)
