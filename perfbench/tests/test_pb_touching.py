"""The touching-pairs generator (``generators/touching.py``): its counts,
its pairs' geometry, its seeds, its refusal of a shape too small, and its
independence of the program."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import cells, gen

TOUCH400 = cells.load_json(cells.HERE / "traffic" / "touch400.json")["volumes"]


def _mod():
    return cells.load_module("generators", "touching")


def _draws(p, seed):
    return [_mod().draw(p, np.random.default_rng(gen.sub_seed(seed, 1, i)))
            for i in range(p["count"])]


@pytest.mark.parametrize("shape", [TOUCH400["shape"], [64, 384, 384]],
                         ids=["touch400", "reduced"])
def test_counts_are_exact(shape):
    p = dict(TOUCH400, shape=shape)
    for centers, radii, touch in _draws(p, 2 ** 31 + 3):
        assert centers.shape == radii.shape == (2 * 150 + 100, 3)
        assert touch.shape == (150,)
        assert ((touch >= 0.5) & (touch <= 0.7)).all()
        assert (centers - radii >= 0).all()
        assert (centers + radii <= np.array(shape)).all()


def test_pairs_touch_as_defined():
    """Each pair's centre distance is ``touch`` times the sum of the two
    ellipsoids' radii along the pair's axis; every other centre keeps
    ``min_center_dist``."""
    mod = _mod()
    centers, radii, touch = _draws(TOUCH400, 11)[0]
    c = centers.astype(np.float64)
    r = radii.astype(np.float64)
    for k in range(150):
        d = c[2 * k + 1] - c[2 * k]
        dist = np.linalg.norm(d)
        u = d / dist
        want = touch[k] * (mod.effective_radius(r[2 * k], u)
                           + mod.effective_radius(r[2 * k + 1], u))
        # the centres are float32: a few ulps of a ~500-voxel coordinate
        assert dist == pytest.approx(want, abs=2e-4)
    pair = np.arange(len(c)) // 2
    pair[300:] = -1 - np.arange(100)
    gaps = np.linalg.norm(c[:, None] - c[None], axis=-1)
    other = pair[:, None] != pair[None]
    assert gaps[other].min() >= TOUCH400["min_center_dist"] - 1e-3


def test_effective_radius_of_a_sphere_and_the_axes():
    mod = _mod()
    r = np.array([3.0, 5.0, 7.0])
    for a in range(3):
        u = np.zeros(3)
        u[a] = 1.0
        assert mod.effective_radius(r, u) == pytest.approx(r[a])
    u = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    assert mod.effective_radius(np.full(3, 4.0), u) == pytest.approx(4.0)


SMALL = {"generator": "touching", "shape": [16, 64, 64], "count": 2,
         "pairs": 2, "singles": 2, "touch_range": [0.5, 0.7],
         "radius_range": [2.0, 4.0], "anisotropy": [0.6, 1.0, 1.0],
         "noise": [0.05, 0.12], "min_center_dist": 10.0}


def test_same_seed_same_volumes_other_seed_other():
    a = gen.volumes_for(SMALL, 2 ** 32 + 9, "cpu")
    b = gen.volumes_for(SMALL, 2 ** 32 + 9, "cpu")
    c = gen.volumes_for(SMALL, 2 ** 32 + 10, "cpu")
    assert len(a) == 2
    for x, y, z in zip(a, b, c):
        assert x.image.shape == (16, 64, 64) and x.image.dtype == torch.float32
        assert torch.equal(x.image, y.image)
        assert (x.centers == y.centers).all()
        assert (x.half_sizes == y.half_sizes).all()
        assert not (x.centers == z.centers).all()
        assert not torch.equal(x.image, z.image)
        assert len(x.centers) == 2 * 2 + 2
    # the two volumes draw apart, and each takes its own noise level
    assert not (a[0].centers == a[1].centers).all()


def test_image_is_the_maximum_of_the_gaussians():
    """With no noise, each centre's voxel reads the maximum over nuclei
    of ``exp(-2 d2)`` there, as ``gen.render`` draws it."""
    p = dict(SMALL, count=1, noise=[0.0])
    vol = gen.volumes_for(p, 4, "cpu")[0]
    idx = np.round(vol.centers).astype(int)
    for z, y, x in idx:
        d2 = (((np.array([z, y, x]) - vol.centers) / vol.half_sizes) ** 2
              ).sum(1)
        inside = np.all(np.abs(np.array([z, y, x]) - vol.centers)
                        <= 2.5 * vol.half_sizes + 1, axis=1)
        want = np.exp(-2.0 * d2[inside]).max()
        assert float(vol.image[z, y, x]) == pytest.approx(want, rel=1e-5)


def test_a_shape_too_small_raises():
    with pytest.raises(ValueError, match="holds only"):
        _draws(dict(TOUCH400, shape=[48, 320, 320], count=1), 1)
    with pytest.raises(ValueError):
        gen.volumes_for(dict(SMALL, shape=[8, 16, 16], pairs=4), 1, "cpu")


def test_imports_nothing_of_the_program():
    path = cells.HERE / "generators" / "touching.py"
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "numpy", "torch", "perfbench"}
    code = ("import sys\n"
            "from perfbench import gen\n"
            f"gen.volumes_for({SMALL!r}, 3, 'cpu')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'tpuseg_torch', 'tpuseg', 'jax'}))\n")
    env = dict(os.environ, PYTHONPATH=str(cells.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(cells.ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
