"""Platform plumbing: the compile cache's location and the pytrees that
replaced flax dataclasses."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from hagrid import scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.grid.packet import PacketGrid, build_packet
from hagrid.parallel import mesh as pmesh
from hagrid.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
from hagrid.utils import cache
d = cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()
print(d)
"""


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_cache_honours_env(tmp_path):
    d = tmp_path / "xla-cache"
    assert _probe(d) == str(d)
    assert any(d.iterdir()), "no compile cache entry landed there"


def test_cache_defaults_to_repo():
    assert _probe(None) == cache.REPO_CACHE
    assert cache.REPO_CACHE == os.path.join(REPO, ".jax_cache")


@pytest.fixture(scope="module")
def packet():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    return build_packet(tris, dims=(4, 5, 6)), primary_rays(
        scenes.cornell_camera(), 16, 16)


def test_pytree_roundtrip_through_jit(packet):
    grid, rays = packet
    # Leaves are arrays only: the static dims3 tuple is metadata.
    assert all(hasattr(x, "shape") for x in jax.tree_util.tree_leaves(grid))

    @jax.jit
    def f(g, r):
        # dims3 is static: Python ints inside the trace.
        assert isinstance(g.dims3[0][0], int)
        return dataclasses.replace(g, bbox_lo=g.bbox_lo + 1.0), r

    g2, r2 = f(grid, rays)
    assert isinstance(g2, PacketGrid) and isinstance(r2, Rays)
    assert g2.dims3 == grid.dims3
    np.testing.assert_allclose(np.asarray(g2.bbox_lo),
                               np.asarray(grid.bbox_lo) + 1.0)
    np.testing.assert_array_equal(np.asarray(r2.dir), np.asarray(rays.dir))
    with pytest.raises(dataclasses.FrozenInstanceError):
        grid.dims3 = ()


def test_pytree_roundtrip_through_shard_map(packet):
    grid, rays = packet
    mesh = pmesh.make_mesh(4)

    def f(g, r):
        n = sum(d[0] for d in g.dims3)          # static under shard_map
        return Rays(org=r.org, dir=r.dir, tmin=r.tmin + n, tmax=r.tmax)

    out = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(), P("rays")),
                                out_specs=P("rays")))(grid, rays)
    assert isinstance(out, Rays)
    assert len(out.tmin.sharding.device_set) == 4
    np.testing.assert_allclose(np.asarray(out.tmin),
                               np.asarray(rays.tmin) + 4 + 5 + 6)
