"""PyTorch port, the packet walk's tie rule against the JAX package.

Among hits at exactly the same t, the walk keeps the first in its order:
leaves left child first, a leaf's triangles in order. The port's kernel
(csrc/packet.cu) tests a leaf's triangles 32 at a time across a warp and
keeps the arg-min of (t, triangle index), which must keep the same triangle
as the serial strict-`<` loop. Here the plain walk, which the kernel is held
to bit for bit on the card (tests/test_torch_kernels.py), is held against
JAX `mesh_intersect_packet(..., interpret=True)` on a scene of coincident
triangles with different materials, in one leaf and split across two: per
lane t and material bit-equal, with JAX run in a process whose XLA may not
use FMA instructions, and normals within 1e-6 (JAX normalizes with
lax.rsqrt, the port with 1/sqrt), as tests/test_torch_binned.py holds them.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.ops.bvh_packet import mesh_intersect_packet
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT
from pathtracer_tpu_torch.utils.vec import Vec3
from test_torch_kernels import FLT_MAX, tie_rays, write_tie_scene

torch.set_num_threads(2)

N = 1024

JAX_PACKET = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from pathtracer_tpu import load_scene
from pathtracer_tpu.ops.bvh_pallas import mesh_intersect_packet
from pathtracer_tpu.utils.vec import Vec3
rays = np.load(sys.argv[1])
scene, settings = load_scene(sys.argv[2])
root = int(scene.geoms.root_node[0])
t, n, m = mesh_intersect_packet(
    scene, root, Vec3(*map(jnp.asarray, rays["o"])),
    Vec3(*map(jnp.asarray, rays["d"])), active=jnp.asarray(rays["act"]),
    t_bound=jnp.asarray(rays["tb"]), interpret=True)
np.savez(sys.argv[3], t=np.asarray(t), n=np.stack([np.asarray(c) for c in n]),
         m=np.asarray(m), nodes=np.asarray(scene.bvh.tri_count))
"""


@pytest.fixture(scope="module")
def tie(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tie")
    path = write_tie_scene(str(tmp))
    o, d, group = tie_rays(N, 0)
    r = np.random.default_rng(1)
    act = r.uniform(size=N) < 0.9
    tb = np.where(r.uniform(size=N) < 0.3, 0.5, FLT_MAX).astype(np.float32)
    np.savez(tmp / "rays.npz", o=o, d=d, act=act, tb=tb)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=AVX").strip()
    res = subprocess.run(
        [sys.executable, "-c", JAX_PACKET, str(tmp / "rays.npz"), path,
         str(tmp / "out.npz")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return path, (o, d, act, tb, group), {k: out[k] for k in out.files}


def test_tie_scene_splits_coincident_triangles_across_leaves(tie):
    """The scene is what the tie tests need: leaves of 75, 75 and 40."""
    path, _, jax_out = tie
    scene, _ = load_scene(path, "cpu")
    counts = scene.bvh.tri_count.numpy()
    assert sorted(counts[counts > 0].tolist()) == [40, 75, 75]
    np.testing.assert_array_equal(counts, jax_out["nodes"])


def test_packet_walk_tie_rule_bit_equal_to_jax(tie):
    path, (o, d, act, tb, group), ref = tie
    scene, _ = load_scene(path, "cpu")
    t, n, m = mesh_intersect_packet(
        scene, scene.mesh_roots[0], Vec3(*map(torch.from_numpy, o)),
        Vec3(*map(torch.from_numpy, d)), active=torch.from_numpy(act),
        t_bound=torch.from_numpy(tb))
    hit = act & (ref["t"] > 0)
    # every hit is at t = 1, so the lanes bounded at 0.5 miss
    assert hit.sum() > N // 2 and (act & ~hit).sum() > 50
    np.testing.assert_array_equal(t.numpy()[act], ref["t"][act])
    np.testing.assert_array_equal(m.numpy()[act], ref["m"][act])
    for c in range(3):   # JAX normalizes with rsqrt, the port with 1/sqrt
        np.testing.assert_allclose(n[c].numpy()[hit], ref["n"][c][hit],
                                   rtol=0, atol=1e-6)
    # the first copy of each group: m0 (id 1) and m2 (id 3)
    assert (ref["m"][hit & (group == 0)] == 1).all()
    assert (ref["m"][hit & (group == 1)] == 3).all()
