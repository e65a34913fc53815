"""PyTorch port, tools/golden_parity.py against the repo's
tools/golden_parity.py (the JAX package's tool), on the CPU.

The full-scale comparison (800x800, hundreds of spp) needs the card
(tests/test_torch_parity_full.py); here both tools render Cornell 32x32 d3
at 2 spp against a 32x32 reference (the golden's 25x25 block means) and
must report the same measures within METRIC_TOL. The port's image is the
JAX package's bit for bit at this size (tests/test_torch_engine.py), so
the quantized images agree and the measures differ by float rounding only.
"""
import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.io.image import load_png, save_png
from pathtracer_tpu_torch.scene.fixtures import golden_path
from pathtracer_tpu_torch.tools import golden_parity
from tools import golden_parity as jax_golden_parity

torch.set_num_threads(2)

METRIC_TOL = 1e-6
KEYS = ("mad", "b8_mean", "b8_max", "b16_mean", "b16_max", "corr")


@pytest.mark.parametrize("b", [1, 3, 8, 16])
def test_block_reduce_equals_jax(b):
    img = np.random.default_rng(b).random((37, 50, 3))
    np.testing.assert_array_equal(golden_parity.block_reduce(img, b),
                                  jax_golden_parity.block_reduce(img, b))


@pytest.fixture(scope="module")
def small_ref(tmp_path_factory):
    """A 32x32 reference: the Cornell golden's 25x25 block means, written
    as stored (no mirror), so it reads back as the golden reads."""
    ref = load_png(golden_path()).reshape(32, 25, 32, 25, 3).mean((1, 3))
    path = str(tmp_path_factory.mktemp("ref") / "ref32.png")
    save_png(ref, path, mirror_x=False)
    return path


def test_compute_parity_equals_jax(small_ref):
    kw = dict(spp=2, chunk=2, ref_png=small_ref,
              overrides={"RES": [32, 32], "DEPTH": 3})
    want = jax_golden_parity.compute_parity(**kw)
    got = golden_parity.compute_parity(**kw, device="cpu")
    assert got["spp"] == 2 and got["seconds"] > 0 and got["ms_frame"] > 0
    for k in KEYS:
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    for k in ("means_ours", "means_gold", "mean_delta"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL)


def test_parity_metrics_through_the_png(small_ref, tmp_path):
    """With png_path the measures come from the written PNG, which holds
    save_png's quantization: the same as without a file."""
    kw = dict(spp=2, chunk=1, ref_png=small_ref, device="cpu",
              overrides={"RES": [32, 32], "DEPTH": 3})
    png = str(tmp_path / "ours.png")
    a = golden_parity.compute_parity(png_path=png, **kw)
    b = golden_parity.compute_parity(**kw)
    assert load_png(png).shape == (32, 32, 3)
    for k in KEYS:
        assert abs(a[k] - b[k]) <= METRIC_TOL, k
    # the same image against itself
    same = golden_parity.parity_metrics(load_png(png), load_png(png))
    assert same["mad"] == 0 and same["b16_max"] == 0
    assert same["corr"] == pytest.approx(1.0)


def test_reference_of_the_wrong_shape_raises(small_ref):
    with pytest.raises(ValueError, match="does not match"):
        golden_parity.compute_parity(spp=1, ref_png=small_ref, device="cpu",
                                     overrides={"RES": [16, 16], "DEPTH": 2})
    with pytest.raises(ValueError, match="differs"):
        golden_parity.parity_metrics(np.zeros((4, 4, 3)), np.zeros((4, 5, 3)))


def test_main_writes_its_markdown(small_ref, tmp_path):
    out, png = tmp_path / "P.md", tmp_path / "c.png"
    golden_parity.main(["--spp", "1", "--res", "32", "--depth", "2",
                        "--ref", small_ref, "--out", str(out), "--png",
                        str(png), "--device", "cpu"])
    text = out.read_text()
    assert "pixel correlation" in text and "the CPU" in text
    assert "TPU" not in text
    assert png.exists()


PASSING = {"b8_mean": 0.0059, "b16_mean": 0.0039, "corr": 0.971,
           "mean_delta": np.array([0.0039, 0.0, 0.001])}


@pytest.mark.parametrize("key, value, word", [
    (None, None, None),
    ("b8_mean", 0.006, "b8_mean"),
    ("b16_mean", 0.004, "b16_mean"),
    ("corr", 0.97, "corr"),
    ("mean_delta", np.array([0.001, 0.004, 0.0]), "channel-mean"),
])
def test_check_envelope(key, value, word):
    """tests/test_parity_full.py's bounds: each breaks at its limit, on its
    own; the spp the card holds them at is recorded beside them."""
    m = dict(PASSING)
    if key is not None:
        m[key] = value
    bad = golden_parity.check_envelope(m)
    if word is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad
    assert golden_parity.ENVELOPE_SPP == 1000
