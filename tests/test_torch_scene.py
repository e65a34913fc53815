"""PyTorch port, scene layer: the port's loader against the JAX package's.

The loader is numpy host code copied into the port, so every table it puts
on the device must equal the JAX loader's array for array, bit for bit: no
tolerance. The packed [rows, 128] tables are what the CUDA kernels read, so
this is also what makes the kernels read exactly the JAX kernels' tables.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT, scene_path
from pathtracer_tpu_torch.scene.loader import scene_from_jax_arrays

torch.set_num_threads(2)

SCENES = ["cornell", "sphere", "glass_slab", "open_test_scene", "test_scene",
          "teapot", "cow", "animal"]   # every scene in scenes/
TABLES = ["bvh_packed_f", "bvh_packed_i", "tris_packed", "treelet_f",
          "treelet_i", "treelet_super", "tris_mxu_c", "tris_mxu_n",
          "nodes8_f", "nodes8_i", "tris8", "wide_root"]
GROUPS = ["geoms", "materials", "bvh", "camera"]


def jax_leaves(tree, prefix=""):
    """Dotted field path -> numpy array, over a JAX SceneArrays."""
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(jax_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def port_leaves(scene):
    """The same dotted paths -> numpy arrays, over the port's SceneArrays."""
    out = {k: getattr(scene, k).numpy() for k in TABLES}
    for g in GROUPS:
        for f in dataclasses.fields(getattr(scene, g)):
            out[f"{g}.{f.name}"] = getattr(getattr(scene, g), f.name).numpy()
    return out


def assert_scene_equal(port, ref_leaves):
    got = port_leaves(port)
    for key, arr in got.items():
        ref = ref_leaves[key]
        assert arr.dtype == ref.dtype, key
        np.testing.assert_array_equal(arr, ref, err_msg=key)
    assert port.tre_rows == ref_leaves["treelet_rows"].shape[0]
    meshes = ref_leaves["geoms.gtype"] == 2
    assert port.mesh_roots == tuple(
        int(r) for r in ref_leaves["geoms.root_node"][meshes])


@pytest.mark.parametrize("name", SCENES)
def test_load_scene_matches_jax_exactly(name):
    j_scene, j_settings = jax_load_scene(scene_path(name))
    p_scene, p_settings = load_scene(scene_path(name), "cpu")
    assert p_scene.device.type == "cpu"
    assert_scene_equal(p_scene, jax_leaves(j_scene))
    for f in dataclasses.fields(p_settings):
        assert getattr(p_settings, f.name) == getattr(j_settings, f.name), (
            f.name)
    # lane -> pixel map, including the tile-major order of mesh scenes
    lanes = np.arange(p_settings.pixel_count, dtype=np.int64)
    np.testing.assert_array_equal(p_settings.pixel_map()(lanes),
                                  np.asarray(j_settings.pixel_map()(lanes)))


@pytest.mark.parametrize("name", ["teapot", "cow"])
def test_wide_and_brute_tables_match_jax_exactly(name):
    """The 8-wide BVH tables and the brute-force tables, built on request,
    equal the JAX loader's bit for bit (without the request both packages
    pack the same placeholders, test_load_scene_matches_jax_exactly)."""
    j_scene, _ = jax_load_scene(scene_path(name), brute_tables=True,
                                wide_tables=True)
    p_scene, _ = load_scene(scene_path(name), "cpu", brute_tables=True,
                            wide_tables=True)
    assert_scene_equal(p_scene, jax_leaves(j_scene))
    assert p_scene.tris_mxu_n.shape[0] > 0 and p_scene.tris8.shape[0] > 8
    # and they survive the carry across from the JAX package
    carried = scene_from_jax_arrays(jax_leaves(j_scene), "cpu")
    assert_scene_equal(carried, jax_leaves(j_scene))
    assert p_scene.wide_built and carried.wide_built


def test_scene_from_jax_arrays_round_trip():
    """JAX leaves carried across give the port's own scene, bit for bit."""
    j_scene, _ = jax_load_scene(scene_path("teapot"))
    leaves = jax_leaves(j_scene)
    carried = scene_from_jax_arrays(leaves, "cpu")
    assert carried.device.type == "cpu"
    assert_scene_equal(carried, leaves)
    # the placeholder forest is known for one on both sides
    assert not carried.wide_built
    assert not load_scene(scene_path("teapot"), "cpu")[0].wide_built


@pytest.mark.parametrize("impl", ["binned", "wide", "wide_nosort", "pallas",
                                  "sorted", "brute"])
def test_load_scene_bvh_impl_loads_its_tables(impl):
    """load_scene(bvh_impl=...) picks the intersector and builds the tables
    it needs, as render.py's --bvh does: brute tables for "brute", the wide
    forest for "wide" / "wide_nosort", neither for the others."""
    scene, settings = load_scene(scene_path("teapot"), "cpu", bvh_impl=impl)
    assert settings.bvh_impl == impl
    assert (scene.tris_mxu_n.shape[0] > 0) == (impl == "brute")
    assert scene.wide_built == (impl in ("wide", "wide_nosort"))
    ref, _ = load_scene(scene_path("teapot"), "cpu",
                        brute_tables=impl == "brute",
                        wide_tables=impl in ("wide", "wide_nosort"))
    ref_leaves = port_leaves(ref)
    for key, arr in port_leaves(scene).items():
        np.testing.assert_array_equal(arr, ref_leaves[key], err_msg=key)


def test_port_never_imports_jax():
    """Importing the port and every one of its modules loads no jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pathtracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'pathtracer_tpu.')))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
