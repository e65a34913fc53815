"""PyTorch port, golden-image parity: the port's Cornell render against the
reference's checked-in CUDA render (scenes/golden/, 800x800, 5000 spp), with
the bounds of tests/test_golden.py (64x64 d8, 96 iterations in chunks of
32, 8x8 block means), plus the port's image readers and writers against the
JAX package's.

The bounds are the JAX package's, measured there on seeds 0-2 with ~40%
headroom: brightness < 0.006, block MAD < 0.013, correlation > 0.98, red
wall left and green wall right; the 3-seed average (slow) < 0.005, < 0.010,
> 0.985. The port draws the JAX package's random numbers
(tests/test_torch_engine.py), so its envelope is the same.
"""
import numpy as np
import pytest
import torch

from pathtracer_tpu.io import image as j_image
from pathtracer_tpu.scene import fixtures as j_fixtures
from pathtracer_tpu_torch import load_scene, render
from pathtracer_tpu_torch.io.image import load_png, save_hdr, save_png
from pathtracer_tpu_torch.scene.fixtures import golden_path, scene_path

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden_blocks():
    ref = load_png(golden_path())
    assert ref.shape == (800, 800, 3)
    return ref.reshape(8, 100, 8, 100, 3).mean(axis=(1, 3))


@pytest.fixture(scope="module")
def cornell_64():
    return load_scene(scene_path("cornell"), "cpu",
                      overrides={"RES": [64, 64], "DEPTH": 8})


def _render_blocks(cornell_64, seed):
    scene, settings = cornell_64
    img = render(scene, settings, iterations=96, chunk=32, seed=seed)
    img = np.clip(img, 0.0, 1.0)[:, ::-1, :]  # saveImage mirror (main.cpp:407)
    return img, img.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cornell_matches_reference_render(golden_blocks, cornell_64, seed):
    rb = golden_blocks
    img, ob = _render_blocks(cornell_64, seed)
    assert abs(rb.mean() - ob.mean()) < 0.006         # global brightness
    assert np.abs(rb - ob).mean() < 0.013             # block error
    corr = np.corrcoef(rb.ravel(), ob.ravel())[0, 1]
    assert corr > 0.98                                # structure
    left = img[24:40, 4:12]
    right = img[24:40, 52:60]
    assert left[..., 0].mean() > left[..., 1].mean()    # red dominant
    assert right[..., 1].mean() > right[..., 0].mean()  # green dominant


@pytest.mark.slow
def test_cornell_seed_average_tight(golden_blocks, cornell_64):
    rb = golden_blocks
    ob = np.mean([_render_blocks(cornell_64, seed)[1] for seed in (0, 1, 2)],
                 axis=0)
    assert abs(rb.mean() - ob.mean()) < 0.005
    assert np.abs(rb - ob).mean() < 0.010
    assert np.corrcoef(rb.ravel(), ob.ravel())[0, 1] > 0.985


def test_golden_path_is_the_jax_packages():
    assert golden_path() == j_fixtures.golden_path()


@pytest.mark.parametrize("name", ["REFERENCE_cornell", "REFERENCE_alien"])
def test_load_png_matches_jax(name):
    """The port's zlib decoder against the JAX package's load_png (PIL), on
    the checked-in goldens."""
    path = golden_path().replace("REFERENCE_cornell", name)
    got = load_png(path)
    want = j_image.load_png(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_load_png_every_filter(tmp_path, mode):
    """PNGs written by PIL with each of the five scanline filters, in grey,
    RGB and RGBA, read back as PIL's convert("RGB") reads them."""
    PIL = pytest.importorskip("PIL.Image")
    g = np.random.default_rng(0)
    ch = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = g.integers(0, 256, (13, 17, ch), dtype=np.uint8)
    img = PIL.fromarray(arr[..., 0] if ch == 1 else arr, mode=mode)
    for f in range(5):
        path = tmp_path / f"f{f}.png"
        img.save(path, optimize=False, compress_level=1, filter=f)
        want = np.asarray(PIL.open(path).convert("RGB"),
                          dtype=np.float32) / 255.0
        np.testing.assert_array_equal(load_png(str(path)), want)


def test_save_png_round_trips_through_load_png(tmp_path):
    img = np.random.default_rng(1).uniform(-0.2, 1.2, size=(5, 7, 3))
    back = load_png(save_png(img, str(tmp_path / "x.png")))
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)[:, ::-1, :]
    np.testing.assert_array_equal(back, want / np.float32(255.0))


def test_save_hdr_bytes_match_jax(tmp_path):
    """The Radiance writer gives the JAX writer's bytes, on an image with
    zeros, tiny values, values over 1 and negatives."""
    g = np.random.default_rng(2)
    img = g.uniform(-0.5, 4.0, size=(9, 11, 3)).astype(np.float32)
    img[0, :3] = 0.0
    img[1, :2] = 1e-33
    for mirror in (True, False):
        a = save_hdr(img, str(tmp_path / "port.hdr"), mirror_x=mirror)
        b = j_image.save_hdr(img, str(tmp_path / "jax.hdr"), mirror_x=mirror)
        assert open(a, "rb").read() == open(b, "rb").read()
