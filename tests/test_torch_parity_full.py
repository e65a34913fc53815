"""PyTorch port, full-scale golden parity on the card: the counterpart of
tests/test_parity_full.py, with its bounds unchanged. Cornell 800x800 d8
through pathtracer_tpu_torch/tools/golden_parity.py against the
reference's 5000-spp render: 8x8-block MAD mean < 0.006, 16x16 < 0.004,
pixel correlation > 0.97, channel-mean deltas < 0.004
(golden_parity.check_envelope, which chip_smoke.py's phase 23 calls too).

At that test's 300 spp the correlation bound cannot hold for a correct
render: per-pixel Monte Carlo noise keeps the correlation with the golden
near 0.956 (an H100 run: 0.95586, with b8 0.00347, b16 0.00187, channel
deltas <= 0.00055; the JAX package draws the same random numbers, and its
2000-spp artifact PARITY.md reads 0.986). So the bounds are held at
golden_parity.ENVELOPE_SPP (1000) spp, where the noise leaves the
correlation near 0.98.

Imports no JAX; needs a CUDA device (skips without one) and is slow (~3
min of rendering on an H100):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_parity_full.py -m cuda
"""
import pytest
import torch


@pytest.mark.cuda
@pytest.mark.slow
def test_full_scale_parity_envelope():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathtracer_tpu_torch.tools.golden_parity import (ENVELOPE_SPP,
                                                          check_envelope,
                                                          compute_parity)

    m = compute_parity(spp=ENVELOPE_SPP, chunk=100, png_path=None,
                       device="cuda")
    assert check_envelope(m) == [], m
