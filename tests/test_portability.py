"""What the program needs from its installation and its device: pytree
dataclasses without flax, the main path without flax or Pillow, the compile
cache location, device checks that raise instead of falling back, and the
GPU smoke script (chip_smoke.py)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.data import synthetic
from orthosfm_tpu.data import tracks as tracks_mod
from orthosfm_tpu.parallel import mesh as mesh_mod
from orthosfm_tpu.utils import compile_cache, device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _camera_set():
    return cam_mod.make_euler(np.arange(3), 64.0, 48.0,
                              angles=np.full((3, 3), 0.1, np.float32))


def _track_set():
    return tracks_mod.empty(5, 3)


def _synthetic_dataset():
    return synthetic.generate_dataset(synthetic.sphere_cloud(20), num_views=3,
                                      width=64, height=64, seed=0)


@pytest.mark.parametrize("make,field,meta", [
    (_camera_set, "offset", {"kind": "euler"}),
    (_track_set, "alive", {}),
    (_synthetic_dataset, "gt_cameras", {"name": "custom"}),
])
def test_pytree_dataclass_roundtrip_and_replace(make, field, meta):
    obj = make()
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    assert all(isinstance(x, (jax.Array, np.ndarray)) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for k, v in meta.items():  # static fields are metadata, not leaves
        assert getattr(back, k) == v

    doubled = jax.jit(lambda t: jax.tree_util.tree_map(lambda x: x, t))(obj)
    assert jax.tree_util.tree_structure(doubled) == treedef

    new_value = jax.tree_util.tree_map(jnp.zeros_like, getattr(obj, field))
    changed = obj.replace(**{field: new_value})
    assert changed is not obj and getattr(changed, field) is new_value
    with pytest.raises(Exception):  # frozen
        setattr(obj, field, new_value)
    for k in meta:  # changing a static field changes the tree structure
        other = obj.replace(**{k: "other"})
        assert jax.tree_util.tree_structure(other) != treedef


def test_main_path_without_flax_and_pillow(tmp_path):
    """The CLI's modules import, and PNG images load and are written, with
    flax and PIL blocked."""
    code = f"""
import sys
sys.modules["flax"] = None
sys.modules["PIL"] = None
import numpy as np
from orthosfm_tpu import app
from orthosfm_tpu.pipeline import reconstruct, matching, incremental
from orthosfm_tpu.parallel import ba_sharded, matching_sharded, tk_sharded
from orthosfm_tpu.testbench import render
from orthosfm_tpu.data import views
gt = render.make_image_dataset({str(tmp_path)!r}, num_views=2, width=32,
                               height=32, seed=0)
vs = views.load_views({str(tmp_path)!r})
assert len(vs) == 2 and vs[0].pixels.shape == (32, 32, 3)
try:
    vs[0].load_pixel_data(downscale_factor=2)
except ImportError as e:
    assert "Pillow" in str(e), e
else:
    raise AssertionError("downscaling without Pillow did not raise")
print("IMPORT_OK")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORT_OK" in proc.stdout


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            assert compile_cache.enable() == compile_cache.DEFAULT_DIR
            assert compile_cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv(compile_cache.ENV_VAR, path)
            jax.config.update("jax_compilation_cache_dir", before)
            assert compile_cache.enable() == path
            # JAX reads the variable itself: nothing is set in code
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_checks_raise_instead_of_falling_back():
    n = jax.device_count()
    assert len(mesh_mod.make_mesh(n).devices.flat) == n
    assert mesh_mod.make_mesh(2).devices.size == 2
    with pytest.raises(RuntimeError, match="requested"):
        mesh_mod.make_mesh(n + 1)
    assert device.describe() == {"platform": "cpu", "kind": "cpu",
                                 "count": n}
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def _smoke_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(extra)
    return env


def test_chip_smoke_refuses_the_cpu():
    """On a CPU-only process the device phase exits NO_GPU and prints no
    result line."""
    import chip_smoke

    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_smoke_env(JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == chip_smoke.NO_GPU, proc.stdout + proc.stderr
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """chip_smoke.py end to end on the card (minutes), in a child process
    with the suite's CPU pin stripped. Skips only where the child finds no
    GPU (its NO_GPU exit); any other failure fails."""
    import chip_smoke

    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_smoke_env(), capture_output=True, text=True,
                          timeout=1500)
    if proc.returncode == chip_smoke.NO_GPU:
        pytest.skip("no GPU: " + proc.stderr.strip().splitlines()[-1])
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
