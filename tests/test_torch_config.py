"""The port's own config dataclasses and instance metrics
(``tpuseg_torch/core/config.py``, ``tpuseg_torch/eval/instance_f1.py``) ==
the JAX package's: the port imports nothing of ``tpuseg``, so the two copies
are held together here — same fields and defaults, one JSON format, equal
metric values (exact: both are the same numpy arithmetic)."""

import dataclasses

import numpy as np
import pytest

from tpuseg.core import config as ref_config
from tpuseg.eval import instance_f1 as ref_f1
from tpuseg_torch.core import config as port_config
from tpuseg_torch.data import synthesize_volume
from tpuseg_torch.eval import instance_f1 as port_f1

CLASSES = ("Config", "DataConfig", "InferConfig", "ModelConfig",
           "PostprocConfig", "TrainConfig")


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_has_the_same_fields_and_defaults(name):
    ref, port = getattr(ref_config, name), getattr(port_config, name)
    assert port.__module__ == "tpuseg_torch.core.config"
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    for f_ref, f_port in zip(dataclasses.fields(ref), dataclasses.fields(port)):
        assert str(f_port.type) == str(f_ref.type), f_ref.name


OVERRIDES = {"model.features": [32, 64], "postproc.nms_radius": [1, 2, 2],
             "postproc.nms_impl": "pallas", "infer.apply_impl": "fused",
             "infer.halo": [0, 8, 8], "data.aug_zscale": [0.5, 1.0],
             "train.lr": 1e-3, "train.ckpt_dir": "/tmp/x"}


@pytest.mark.parametrize("writer,reader", [(ref_config, port_config),
                                           (port_config, ref_config)],
                         ids=["jax_to_port", "port_to_jax"])
def test_config_json_written_by_one_loads_in_the_other(writer, reader):
    cfg = writer.Config().override(**OVERRIDES)
    text = cfg.to_json()
    back = reader.Config.from_json(text)
    assert type(back).__module__ == reader.__name__
    assert back.to_dict() == cfg.to_dict()
    assert back.to_json() == text
    assert back.model.features == (32, 64)          # lists come back as tuples
    assert back == reader.Config().override(**OVERRIDES)


def test_config_override_rejects_unknown_keys():
    with pytest.raises(KeyError, match="unknown config key"):
        port_config.Config().override(**{"infer.no_such_field": 1})


@pytest.fixture(scope="module")
def label_pair():
    """Ground truth of a synthetic stack and a damaged copy of it: one
    instance split in two, one removed, one shifted, one spurious blob."""
    gt = synthesize_volume(shape=(24, 48, 48), num_instances=12, seed=5).labels
    rng = np.random.default_rng(0)
    pred = gt.copy()
    ids = rng.permutation(np.unique(gt)[1:])
    zz = np.arange(gt.shape[0])[:, None, None]
    centre = int(np.round(np.argwhere(gt == ids[0])[:, 0].mean()))
    pred[(gt == ids[0]) & (zz > centre)] = gt.max() + 1
    pred[gt == ids[1]] = 0
    shifted = np.roll(gt == ids[2], 3, axis=2)
    pred[gt == ids[2]] = 0
    pred[shifted & (pred == 0)] = ids[2]
    pred[1:3, 1:4, 1:4] = gt.max() + 2
    return pred.astype(np.int32), gt.astype(np.int32)


@pytest.mark.parametrize("kwargs", [
    {"iou_threshold": 0.5}, {"iou_threshold": 0.3}, {"iou_threshold": 0.75},
    {"criterion": "center"}], ids=["iou0.5", "iou0.3", "iou0.75", "center"])
def test_instance_metrics_equal(label_pair, kwargs):
    pred, gt = label_pair
    got = port_f1.instance_metrics(pred, gt, **kwargs)
    want = ref_f1.instance_metrics(pred, gt, **kwargs)
    assert 0 < want["tp"] < want["n_gt"]
    np.testing.assert_equal(got, want)              # NaN-aware, exact


def test_voxel_and_center_metrics_equal(label_pair):
    pred, gt = label_pair
    assert port_f1.voxel_metrics(pred, gt) == ref_f1.voxel_metrics(pred, gt)
    centers = np.stack([np.argwhere(gt == i).mean(0) for i in np.unique(gt)[1:]])
    got = port_f1.center_match_f1(pred, centers)
    assert got == ref_f1.center_match_f1(pred, centers)
    assert 0 < got["tp"] < got["n_gt"]
    with pytest.raises(ValueError, match="unknown criterion"):
        port_f1.instance_metrics(pred, gt, criterion="nope")
