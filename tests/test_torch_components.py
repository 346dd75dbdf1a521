"""The port's connected components and compact relabel
(``tpuseg_torch/ops/components.py``, ``ops/relabel.py``) ==
``tpuseg.ops.components`` / ``tpuseg.ops.relabel`` on the same numpy
inputs, elementwise, and against ``scipy.ndimage.label``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from tpuseg.ops import compact_relabel as ref_compact_relabel
from tpuseg.ops import connected_components as ref_connected_components
from tpuseg.ops.components import label_components as ref_label_components
from tpuseg.ops.components import \
    labels_are_connected as ref_labels_are_connected
from tpuseg_torch.ops import (compact_relabel, connected_components,
                              label_components, labels_are_connected)

from test_torch_model import single_torch_thread  # noqa: F401


def _snake():
    mask = np.zeros((4, 16, 16), bool)
    for y in range(0, 16, 2):
        mask[0, y, :] = True
    for y in range(1, 16, 2):
        mask[0, y, 0 if (y // 2) % 2 else 15] = True
    return mask


@pytest.mark.parametrize("kind", ["random0", "random1", "random2", "snake"])
def test_connected_components_equal_reference(kind):
    if kind == "snake":                  # one long winding component
        mask = _snake()
    else:
        mask = np.random.default_rng(int(kind[-1])).random((12, 12, 12)) < 0.35
    got = connected_components(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    want = np.asarray(ref_connected_components(jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    _, n = ndi.label(mask)
    assert len(np.unique(want[want > 0])) == n


def test_diagonal_contact_is_not_connected():
    mask = np.zeros((4, 4, 4), bool)
    mask[0, 0, 0] = mask[1, 1, 1] = True
    got = connected_components(torch.from_numpy(mask)).numpy()
    assert got[0, 0, 0] == 1 and got[1, 1, 1] == 1 + 16 + 4 + 1


def _labels_with_a_split():
    lab = np.zeros((4, 8, 8), np.int32)
    lab[1, 1:3, 1:3] = 5                  # one connected instance
    lab[1, 5:7, 5:7] = 7                  # another label ...
    lab[3, 1:3, 1:3] = 7                  # ... in two pieces
    lab[2, 1:3, 1:3] = 5                  # touching 7's second piece
    return lab


def test_label_components_equal_reference():
    lab = _labels_with_a_split()
    rng = np.random.default_rng(3)
    noisy = np.where(rng.random((6, 9, 11)) < 0.6,
                     rng.integers(1, 4, (6, 9, 11)), 0).astype(np.int32)
    for case in (lab, noisy):
        got = label_components(torch.from_numpy(case))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_label_components(jnp.asarray(case))))
    comps = label_components(torch.from_numpy(lab)).numpy()
    assert comps[1, 5, 5] != comps[3, 1, 1]   # the two 7-pieces
    assert comps[1, 1, 1] == comps[2, 1, 1]   # 5 across planes


def test_labels_are_connected_finds_the_disconnected_label():
    lab = _labels_with_a_split()
    assert not labels_are_connected(lab, device="cpu")
    assert not ref_labels_are_connected(lab)
    lab[3] = 0                            # drop the second piece
    assert labels_are_connected(lab, device="cpu")
    assert ref_labels_are_connected(lab)
    assert labels_are_connected(torch.from_numpy(lab))


def _u_through_the_bottom():
    """Label 3: two arms down the z axis joined only at the bottom plane, so
    every chunk above the last holds it in two pieces; label 4: a piece cut
    off below a gap, one plane under a seam of chunks of 2."""
    lab = np.zeros((7, 6, 6), np.int32)
    lab[0:7, 1, 1] = 3
    lab[0:7, 1, 4] = 3
    lab[6, 1, 1:5] = 3
    lab[0:3, 4, 2] = 4
    lab[4:6, 4, 2] = 4
    return lab


def _chunk_cases():
    rng = np.random.default_rng(5)
    noisy = np.where(rng.random((9, 7, 8)) < 0.7,
                     rng.integers(1, 3, (9, 7, 8)), 0).astype(np.int32)
    u = _u_through_the_bottom()
    joined = u.copy()
    joined[3, 4, 2] = 4                   # label 4 in one piece
    return {"split": _labels_with_a_split(), "u_gap": u, "u": joined,
            "noisy": noisy}


@pytest.mark.parametrize("chunk_z", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("case", ["split", "u_gap", "u", "noisy"])
def test_labels_are_connected_by_chunks_equal_reference(case, chunk_z,
                                                        tmp_path):
    """``chunk_z`` (the check of a streamed volume): components per chunk
    joined across the seams give the reference's answer, from a memmap
    too."""
    lab = _chunk_cases()[case]
    want = bool(ref_labels_are_connected(lab))
    assert want == {"split": False, "u_gap": False, "u": True}.get(case, want)
    np.save(tmp_path / "lab.npy", lab)
    for src in (lab, np.load(tmp_path / "lab.npy", mmap_mode="r")):
        assert labels_are_connected(src, device="cpu",
                                    chunk_z=chunk_z) == want


def test_compact_relabel_equal_reference():
    lab = np.array([[[0, 5, 5], [900, 0, 17], [17, 900, 0]]], np.int32)
    got = compact_relabel(torch.from_numpy(lab))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_compact_relabel(jnp.asarray(lab))))
    assert got.numpy()[0, 0, 1] == 1 and got.numpy()[0, 1, 0] == 3
