"""PyTorch port, ops/scan.py: every public function against the JAX package's
on the same inputs, made with numpy from a seed.

On the CPU the port's scan is its plain version (csrc/scan.cu runs only on a
CUDA tensor; tests/test_torch_kernels.py holds the kernel against it on the
card). JAX's `exclusive_scan` runs both ways: through its Pallas kernel in
interpret mode and through jnp. Integer outputs must be equal; the float32
scan agrees within JAX's own test_scan tolerance, rtol 1e-4 / atol 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import scan as jscan
from pathtracer_tpu_torch.ops import kernels
from pathtracer_tpu_torch.ops import scan
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("n", [1, 7, 128, 4096, 4097, 40000])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_exclusive_scan_int32_equals_jax(n, use_pallas):
    x = np.random.default_rng(n).integers(0, 5, size=n).astype(np.int32)
    got = scan.exclusive_scan(torch.from_numpy(x))
    assert got.dtype == torch.int32
    want = _np(jscan.exclusive_scan(jnp.asarray(x), use_pallas=use_pallas))
    np.testing.assert_array_equal(got.numpy(), want)


def test_exclusive_scan_int32_wraps_as_jax():
    """Sums past 2**31 wrap in int32 in both packages."""
    x = np.full(5000, 2 ** 30, dtype=np.int32)
    got = scan.exclusive_scan(torch.from_numpy(x)).numpy()
    want = _np(jscan.exclusive_scan(jnp.asarray(x), use_pallas=True))
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any()


def test_exclusive_scan_float32_within_jax_tolerance():
    x = np.random.default_rng(0).standard_normal(20000).astype(np.float32)
    got = scan.exclusive_scan(torch.from_numpy(x)).numpy()
    for use_pallas in (True, False):
        want = _np(jscan.exclusive_scan(jnp.asarray(x),
                                        use_pallas=use_pallas))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_exclusive_scan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        scan.exclusive_scan(torch.arange(10))            # int64
    with pytest.raises(ValueError):
        scan.scan_kernel(torch.arange(10, dtype=torch.int32))   # on the CPU


def _mask(n, seed, kind):
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    return np.random.default_rng(seed).random(n) < 0.3


@pytest.mark.parametrize("kind", ["random", "all", "none"])
def test_compaction_functions_equal_jax(kind):
    n = 4096
    mask = _mask(n, 5, kind)
    vals = np.random.default_rng(6).integers(-99, 99, n).astype(np.int32)
    fvals = np.random.default_rng(7).random(n).astype(np.float32)
    tm = torch.from_numpy(mask)
    jm = jnp.asarray(mask)

    idx, count = scan.compaction_indices(tm)
    j_idx, j_count = jscan.compaction_indices(jm, use_pallas=True)
    assert idx.dtype == torch.int32 and count.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), _np(j_idx))
    assert int(count) == int(j_count) == mask.sum()

    tree = {"v": torch.from_numpy(vals),
            "w": Vec3(*(torch.from_numpy(fvals) * k for k in (1, 2, 3)))}
    j_tree = {"v": jnp.asarray(vals),
              "w": tuple(jnp.asarray(fvals) * k for k in (1, 2, 3))}
    for fn, jfn in ((scan.compact, jscan.compact),
                    (scan.partition_stable, jscan.partition_stable)):
        packed, c = fn(tree, tm)
        j_packed, jc = jfn(j_tree, jm, use_pallas=True)
        assert isinstance(packed["w"], Vec3)
        assert int(c) == int(jc)
        np.testing.assert_array_equal(packed["v"].numpy(), _np(j_packed["v"]))
        for a, b in zip(packed["w"], j_packed["w"]):
            np.testing.assert_array_equal(a.numpy(), _np(b))

    packed, c = scan.partition_multisort(tree, tm)
    j_packed, jc = jscan.partition_multisort(j_tree, jm)
    assert int(c) == int(jc)
    np.testing.assert_array_equal(packed["v"].numpy(), _np(j_packed["v"]))
    np.testing.assert_array_equal(packed["w"].y.numpy(),
                                  _np(j_packed["w"][1]))


@pytest.mark.parametrize("sorter", ["multisort", "segmented"])
def test_sorts_by_key_equal_jax(sorter):
    n = 4096
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 9, n).astype(np.int32)
    payload = np.arange(n, dtype=np.int32)
    fpay = rng.random(n).astype(np.float32)
    fn = getattr(scan, f"sort_by_key_{sorter}")
    jfn = getattr(jscan, f"sort_by_key_{sorter}")
    k, (p, f) = fn(torch.from_numpy(keys), (torch.from_numpy(payload),
                                            torch.from_numpy(fpay)))
    jk, (jp, jf) = jfn(jnp.asarray(keys), (jnp.asarray(payload),
                                          jnp.asarray(fpay)))
    assert k.dtype == torch.int32
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    np.testing.assert_array_equal(p.numpy(), _np(jp))
    np.testing.assert_array_equal(f.numpy(), _np(jf))


def test_segmented_sort_needs_whole_columns():
    with pytest.raises(AssertionError):
        scan.sort_by_key_segmented(torch.zeros(200, dtype=torch.int32),
                                   torch.zeros(200))


@pytest.mark.parametrize("n", [8, 4096, 12345])
def test_radix_sort_equals_jax(n):
    """Five bits, keys up to 40: a key of 32 or more sorts as its low five
    bits do, in both packages."""
    keys = np.random.default_rng(n).integers(0, 41, n).astype(np.int32)
    payload = np.arange(n, dtype=np.int32) * 3
    before = dict(kernels.LAUNCHES)
    k, t = scan.sort_by_key(torch.from_numpy(keys),
                            {"p": torch.from_numpy(payload)}, n_bits=5)
    assert kernels.LAUNCHES == before        # the CPU runs the plain scan
    for use_pallas in (True, False):
        jk, jt = jscan.sort_by_key(jnp.asarray(keys),
                                   {"p": jnp.asarray(payload)}, n_bits=5,
                                   use_pallas=use_pallas)
        np.testing.assert_array_equal(k.numpy(), _np(jk))
        np.testing.assert_array_equal(t["p"].numpy(), _np(jt["p"]))
    order = np.argsort(keys & 31, kind="stable")
    np.testing.assert_array_equal(k.numpy(), keys[order])


def test_gather_tree_keeps_the_structure():
    tree = {"a": torch.arange(4), "b": (torch.arange(4) * 2.0,
                                        [torch.arange(4) + 1])}
    out = scan.gather_tree(tree, torch.tensor([3, 2, 1, 0],
                                              dtype=torch.int32))
    assert out["a"].tolist() == [3, 2, 1, 0]
    assert out["b"][0].tolist() == [6.0, 4.0, 2.0, 0.0]
    assert out["b"][1][0].tolist() == [4, 3, 2, 1]
    with pytest.raises(TypeError):
        scan.gather_tree({"a": 1}, torch.tensor([0]))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, to drive the scan
    wrapper's host side with the launch mocked."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def mocked_launch(monkeypatch):
    """scan_kernel's launches, recorded instead of made: (stream, scratch
    capacity, n, epoch) each; the current stream is `stream[0]`."""
    calls, stream = [], [11]
    monkeypatch.setattr(scan, "_SCRATCH", {})
    monkeypatch.setattr(kernels, "current_stream", lambda dev: stream[0])

    def launch(name, dev, x, out, words, cap, n, is_float, epoch, *,
               stream):
        assert name == "scan" and dev == torch.device("cuda", 0)
        calls.append((stream, cap, n, epoch))

    class HostScratch(scan._Scratch):     # its words in host memory
        def __init__(self, tiles, device):
            super().__init__(tiles, "cpu")

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(scan, "_Scratch", HostScratch)
    return calls, stream


def test_scan_wrapper_epochs_skip_zero_and_wrap(mocked_launch):
    calls, _ = mocked_launch
    x = torch.zeros(100, dtype=torch.int32).as_subclass(_OnCard)
    for _ in range(3):
        scan.scan_kernel(x)
    assert [c[3] for c in calls] == [1, 2, 3]
    s = scan._SCRATCH[(0, 11)]
    s.epoch = scan.EPOCH_MAX - 1
    s.words.fill_(7)                    # flags of earlier calls
    scan.scan_kernel(x)
    assert calls[-1][3] == scan.EPOCH_MAX and bool((s.words == 7).all())
    scan.scan_kernel(x)                 # wraps: flags zeroed, epoch 1
    assert calls[-1][3] == 1 and not bool(s.words.any())
    scan.scan_kernel(x)
    assert calls[-1][3] == 2


def test_scan_wrapper_keeps_one_scratch_per_stream(mocked_launch):
    calls, stream = mocked_launch
    small = torch.zeros(5000, dtype=torch.int32).as_subclass(_OnCard)
    big = torch.zeros(40000, dtype=torch.float32).as_subclass(_OnCard)
    scan.scan_kernel(small)
    first = scan._SCRATCH[(0, 11)]
    scan.scan_kernel(small)
    assert scan._SCRATCH[(0, 11)] is first and calls[-1][3] == 2
    stream[0] = 12                      # another stream: its own scratch
    scan.scan_kernel(small)
    assert scan._SCRATCH[(0, 12)] is not first and calls[-1][3] == 1
    stream[0] = 11                      # 10 tiles outgrow 2: remade
    scan.scan_kernel(big)
    grown = scan._SCRATCH[(0, 11)]
    assert grown is not first and grown.words.numel() - 1 == 10
    assert calls[-1] == (11, 10, 40000, 1)
    scan.scan_kernel(small)             # kept while it is large enough
    assert scan._SCRATCH[(0, 11)] is grown and calls[-1][3] == 2
    assert [c[1] for c in calls] == [2, 2, 2, 10, 10]


@pytest.mark.parametrize("n,tiles", [(1, 1), (4096, 1), (4097, 2),
                                     (2 ** 22, 1024), (2 ** 22 + 1, 1025),
                                     (2 ** 24 + 3, 4097)])
def test_scan_tiles_cover_the_kernels_tiles(n, tiles):
    """One flag a 4,096-element tile: enough for the kernel's 4,096- and
    8,192-element tiles alike."""
    assert scan.scan_tiles(n) == tiles
