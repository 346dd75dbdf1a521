"""``python -m tpuseg_torch.cli.infer`` and the machine-with-the-card
contract: the port and ``chip_smoke.py`` run with no JAX installed, and the
smoke refuses to report a result without a GPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ckpt.torch_import import torch_state_dict_from_flax
from tpuseg.core import Config, ModelConfig
from tpuseg.data import synthesize_volume
from tpuseg.infer import make_infer_fn as ref_make_infer_fn
from tpuseg.models import build_model as ref_build_model
from tpuseg_torch.cli import infer as cli_infer
from tpuseg_torch.infer import make_infer_fn, make_infer_stages

from test_torch_model import (_port_model, _randomized_variables, port_config,
                              single_torch_thread)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # see single_torch_thread
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A tiny exported checkpoint, volume and config (thresholds at
    quantiles of the random net's own maps, so instances exist)."""
    tmp = tmp_path_factory.mktemp("cli")
    mcfg = ModelConfig(features=(8, 16), head_features=8,
                       compute_dtype="float32")
    variables = _randomized_variables(mcfg, seed=11)
    ckpt = str(tmp / "exported.pth")
    torch.save(torch_state_dict_from_flax(variables), ckpt)
    image = synthesize_volume(shape=(16, 32, 64), num_instances=6,
                              radius_range=(3.0, 5.0), seed=3).image
    vol = str(tmp / "vol.npy")
    np.save(vol, image)
    cfg = Config().override(**{
        "model.features": [8, 16], "model.head_features": 8,
        "model.compute_dtype": "float32", "infer.compute_dtype": "float32",
        "infer.tile": [16, 32, 32], "infer.halo": 12,
        "postproc.min_size": 5})
    logits = make_infer_stages(_port_model(mcfg, variables),
                               port_config(cfg))[1](torch.from_numpy(image))
    thr = {k: float(np.quantile(torch.sigmoid(logits[f"{k}_logits"]).numpy(), q))
           for k, q in (("fg", 0.5), ("peak", 0.9))}
    cfg = cfg.override(**{"postproc.fg_threshold": thr["fg"],
                          "postproc.peak_threshold": thr["peak"]})
    cfg_path = str(tmp / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    return dict(tmp=tmp, ckpt=ckpt, vol=vol, image=image, cfg=cfg,
                cfg_path=cfg_path, variables=variables, mcfg=mcfg)


def test_cli_labels_match(case):
    out = str(case["tmp"] / "labels.npy")
    res = _run(["-m", "tpuseg_torch.cli.infer", "--device", "cpu",
                "--checkpoint", case["ckpt"], "--input", case["vol"],
                "--output", out, "--config", case["cfg_path"],
                "--report-convergence"])
    assert res.returncode == 0, res.stderr
    assert "flood convergence: CONVERGED" in res.stdout
    got = np.load(out)
    assert got.dtype == np.int32 and got.max() >= 3
    # the same code in-process: identical
    port = make_infer_fn(_port_model(case["mcfg"], case["variables"]),
                         port_config(case["cfg"]))(
        torch.from_numpy(case["image"])).numpy()
    np.testing.assert_array_equal(got, port)
    # the JAX package on the same weights: float32 summation order only
    # (test_torch_pipeline.py's bound)
    want = np.asarray(ref_make_infer_fn(ref_build_model(case["mcfg"]),
                                        case["cfg"])(
        jax.tree.map(jnp.asarray, case["variables"]),
        jnp.asarray(case["image"])))
    assert abs(int(got.max()) - int(want.max())) <= 2
    assert (got == want).mean() >= 0.99


def test_cli_truncation_exits_4(case):
    out = str(case["tmp"] / "trunc.npy")
    status = cli_infer.main([
        "--device", "cpu", "--checkpoint", case["ckpt"], "--input",
        case["vol"], "--output", out, "--config", case["cfg_path"],
        "--set", "postproc.flood_iters=1", "--report-convergence"])
    assert status == 4
    assert os.path.exists(out)                   # labels are still written


def test_cli_calibrate_from_matches_reference(case, capsys):
    """``--calibrate-from``: the annotation-derived fg fraction, NMS radius
    and upper normalization percentile, then the volume-matched fg
    threshold, as the JAX package's CLI derives them."""
    import dataclasses

    from tpuseg.ops.calibrate import (adaptive_upper_pct, expected_fg_fraction,
                                      nms_radius_from_half_sizes)

    sv = synthesize_volume(shape=(16, 32, 64), num_instances=6,
                           radius_range=(3.0, 5.0), seed=3)
    ann = str(case["tmp"] / "ann.npz")
    np.savez(ann, centers=sv.centers, half_sizes=sv.half_sizes)
    out = str(case["tmp"] / "calibrated.npy")
    status = cli_infer.main(["--device", "cpu", "--checkpoint", case["ckpt"],
                             "--input", case["vol"], "--output", out,
                             "--config", case["cfg_path"],
                             "--calibrate-from", ann])
    assert status == 0 and "calibrated from" in capsys.readouterr().out
    cfg = case["cfg"]
    frac = expected_fg_fraction(sv.half_sizes, sv.image.size)
    cfg = dataclasses.replace(
        cfg, postproc=dataclasses.replace(
            cfg.postproc, fg_target_fraction=frac,
            nms_radius=nms_radius_from_half_sizes(sv.half_sizes)),
        data=dataclasses.replace(cfg.data, normalize_pcts=(
            cfg.data.normalize_pcts[0],
            adaptive_upper_pct(frac, cfg.data.normalize_pcts[1]))))
    want = np.asarray(ref_make_infer_fn(ref_build_model(case["mcfg"]), cfg)(
        jax.tree.map(jnp.asarray, case["variables"]),
        jnp.asarray(case["image"])))
    got = np.load(out)
    assert want.max() >= 2
    assert abs(int(got.max()) - int(want.max())) <= 2
    assert (got == want).mean() >= 0.99


def test_cli_postproc_settings(case):
    """``--set postproc.nms_impl="pallas"`` (the NMS kernel's composition)
    writes the default path's labels; ``postproc.method="flood"`` runs and
    labels the same foreground."""
    outs = {}
    for tag, sets in (("default", []),
                      ("nms", ["--set", 'postproc.nms_impl="pallas"']),
                      ("flood", ["--set", 'postproc.method="flood"'])):
        out = str(case["tmp"] / f"post_{tag}.npy")
        status = cli_infer.main([
            "--device", "cpu", "--checkpoint", case["ckpt"], "--input",
            case["vol"], "--output", out, "--config", case["cfg_path"], *sets])
        assert status == 0
        outs[tag] = np.load(out)
    assert outs["default"].max() >= 3
    np.testing.assert_array_equal(outs["nms"], outs["default"])
    assert outs["flood"].max() >= 3
    assert ((outs["flood"] > 0) == (outs["default"] > 0)).mean() >= 0.99


def test_cli_stream_equals_one_shot(case, capsys):
    """``--stream 16`` (one chunk of the 16-plane volume, halo 32 of
    edge-replicated planes: the net sees the one-shot's tile blocks) writes
    the one-shot CLI's labels, with ``--report-convergence``,
    ``--calibrate-from`` and ``--validate`` on both."""
    sv = synthesize_volume(shape=(16, 32, 64), num_instances=6,
                           radius_range=(3.0, 5.0), seed=3)
    ann = str(case["tmp"] / "ann_stream.npz")
    np.savez(ann, centers=sv.centers, half_sizes=sv.half_sizes)
    outs = {}
    for tag, extra in (("one_shot", []), ("stream", ["--stream", "16"])):
        out = str(case["tmp"] / f"{tag}.npy")
        status = cli_infer.main([
            "--device", "cpu", "--checkpoint", case["ckpt"], "--input",
            case["vol"], "--output", out, "--config", case["cfg_path"],
            "--report-convergence", "--calibrate-from", ann, "--validate",
            *extra])
        printed = capsys.readouterr().out
        assert status == 0
        assert "flood convergence: CONVERGED" in printed
        assert "connectivity validation: OK" in printed
        outs[tag] = np.load(out)
    assert "stream stats: " in printed and '"t_finalize"' in printed
    assert outs["one_shot"].max() >= 2
    np.testing.assert_array_equal(outs["stream"], outs["one_shot"])


def test_cli_stream_resume_dir_npy(case, tmp_path):
    """``--resume-dir`` with an ``.npy`` output: the labels stream into an
    int32 memmap at the output path and equal the run without it; a rerun
    finds the finished run and leaves the file as it was."""
    base = ["--device", "cpu", "--checkpoint", case["ckpt"], "--input",
            case["vol"], "--config", case["cfg_path"], "--stream", "8"]
    plain = str(tmp_path / "plain.npy")
    assert cli_infer.main([*base, "--output", plain]) == 0
    out, rdir = str(tmp_path / "resumable.npy"), str(tmp_path / "resume")
    for _ in range(2):
        assert cli_infer.main([*base, "--output", out, "--resume-dir",
                               rdir]) == 0
        np.testing.assert_array_equal(np.load(out), np.load(plain))
    assert sorted(os.listdir(rdir)) == ["chunk_000000.npz",
                                        "chunk_000001.npz", "finalize.json",
                                        "meta.json"]
    assert np.load(plain).max() >= 3


def test_cli_validate_fails_with_status_3(case, monkeypatch, capsys):
    """A disconnected instance: ``--validate`` prints FAILED, exits 3 and
    writes nothing."""
    from tpuseg_torch.ops import components

    monkeypatch.setattr(components, "labels_are_connected",
                        lambda labels, device, chunk_z: False)
    out = str(case["tmp"] / "never.npy")
    status = cli_infer.main([
        "--device", "cpu", "--checkpoint", case["ckpt"], "--input",
        case["vol"], "--output", out, "--config", case["cfg_path"],
        "--validate"])
    assert status == 3 and not os.path.exists(out)
    assert "connectivity validation: FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--stream-shard", "2"], ["--shard", "z2"]])
def test_cli_unported_flags_error(case, flag, capsys):
    """Both flags are ported now; each is refused (usage, status 2) in the
    mode it does not belong to: ``--stream-shard`` without ``--stream``,
    ``--shard`` with it."""
    stream = ["--stream", "8"] if flag[0] == "--shard" else []
    with pytest.raises(SystemExit) as exc:
        cli_infer.main(["--checkpoint", case["ckpt"], "--input", case["vol"],
                        "--output", "x.npy", *flag, *stream])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" not in err
    assert ("needs --stream" in err if not stream
            else "with --stream use --stream-shard" in err)


def _analytic_unet_state(mcfg):
    """A U-Net state whose logits are AnalyticNet's, up to the batch norms'
    ``1 / sqrt(1 + eps)``: only the centre taps of the full-resolution
    path carry the input (enc0 -> the skip -> up0.block -> head_trunk),
    every other weight is zero, and the heads map it to ``25 (v - 0.35)``
    and ``25 (v - 0.75)``. Its receptive field is 0, so its basins are the
    blobs': the sharded and streamed CLI runs meet the halo contract."""
    from tpuseg_torch.core import ModelConfig as PortModelConfig
    from tpuseg_torch.models import UNet3D

    model = UNet3D(PortModelConfig(**{
        k: getattr(mcfg, k) for k in ("features", "head_features",
                                      "compute_dtype")}))
    # batch norms the identity (scale 1, variance 1), everything else 0
    sd = {k: torch.ones_like(v) if k.endswith("running_var") or (
        ".norm" in k and k.endswith(".weight")) else torch.zeros_like(v)
        for k, v in model.state_dict().items()}
    f0 = mcfg.features[0]
    for conv, cin in (("enc0.conv0", 0), ("enc0.conv1", 0),
                      ("up0.block.conv0", f0), ("up0.block.conv1", 0),
                      ("head_trunk.conv0", 0), ("head_trunk.conv1", 0)):
        sd[conv + ".weight"][0, cin, 1, 1, 1] = 1.0
    for head, bias in (("fg_head", -0.35), ("peak_head", -0.75)):
        sd[head + ".weight"][0, 0] = 25.0
        sd[head + ".bias"][0] = 25.0 * bias
    return sd


@pytest.fixture(scope="module")
def shard_case(tmp_path_factory):
    """The analytic U-Net (``_analytic_unet_state``) on a (64, 32, 32)
    stack of blobs: ``--shard z8`` (slabs of 8), ``z2,y4`` (rows of 8) and
    ``--stream-shard 4`` at shard halo 8 meet the halo contract, so their
    labels equal the one-shot CLI's."""
    tmp = tmp_path_factory.mktemp("cli_shard")
    mcfg = ModelConfig(features=(4, 8), head_features=4,
                       compute_dtype="float32")
    ckpt = str(tmp / "analytic.pth")
    torch.save(_analytic_unet_state(mcfg), ckpt)
    image = synthesize_volume(shape=(64, 32, 32), num_instances=8,
                              radius_range=(3.0, 5.0), noise=0.0,
                              seed=4).image
    vol = str(tmp / "vol.npy")
    np.save(vol, image)
    cfg = Config().override(**{
        "model.features": [4, 8], "model.head_features": 4,
        "model.compute_dtype": "float32", "infer.compute_dtype": "float32",
        "infer.tile": [32, 32, 32], "infer.halo": 0,
        "infer.shard_halo": 8, "postproc.min_size": 5,
        "postproc.flood_iters": 16})
    cfg_path = str(tmp / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    return dict(tmp=tmp, ckpt=ckpt, vol=vol, image=image, cfg_path=cfg_path)


def _shard_argv(case, out, *extra):
    return ["--device", "cpu", "--checkpoint", case["ckpt"], "--input",
            case["vol"], "--output", out, "--config", case["cfg_path"],
            "--validate", *extra]


@pytest.fixture(scope="module")
def shard_one_shot(shard_case):
    out = str(shard_case["tmp"] / "one_shot.npy")
    assert cli_infer.main(_shard_argv(shard_case, out)) == 0
    labels = np.load(out)
    assert labels.max() >= 5
    return labels


@pytest.mark.parametrize("spec", ["z8", "z2,y4"])
def test_cli_infer_shard_modes(shard_case, shard_one_shot, spec, capsys):
    """``--shard z8`` and ``--shard z2,y4`` on the CPU (all shards on it)
    with ``--validate`` (``tests/e2e/test_cli.py``'s case): the placement
    line, connected instances, and the one-shot CLI's labels."""
    out = str(shard_case["tmp"] / f"shard_{spec.replace(',', '_')}.npy")
    status = cli_infer.main(_shard_argv(shard_case, out, "--shard", spec))
    printed = capsys.readouterr().out
    assert status == 0
    assert f"--shard {spec}: Mesh(" in printed and "devices=[cpu" in printed
    assert "connectivity validation: OK" in printed
    np.testing.assert_array_equal(np.load(out), shard_one_shot)


def test_cli_infer_stream_shard(shard_case, shard_one_shot, capsys):
    """``--stream 16 --stream-shard 4 --validate``: the y-sharded chunks
    give the plain stream's labels, here the one-shot's."""
    outs = {}
    for tag, extra in (("plain", []), ("sharded", ["--stream-shard", "4"])):
        out = str(shard_case["tmp"] / f"stream_{tag}.npy")
        assert cli_infer.main(_shard_argv(shard_case, out, "--stream", "16",
                                          *extra)) == 0
        printed = capsys.readouterr().out
        assert "connectivity validation: OK" in printed
        outs[tag] = np.load(out)
    assert "--stream-shard 4: Mesh({'y': 4}" in printed
    np.testing.assert_array_equal(outs["sharded"], outs["plain"])
    np.testing.assert_array_equal(outs["sharded"], shard_one_shot)


def test_cli_bad_shard_spec(case):
    for spec in ("x8", "y2,z2", "z"):
        with pytest.raises(SystemExit, match="bad --shard spec"):
            cli_infer.main(["--device", "cpu", "--checkpoint", case["ckpt"],
                            "--input", case["vol"], "--output", "x.npy",
                            "--shard", spec])


def test_cli_shard_report_convergence_not_wired(shard_case, capsys):
    out = str(shard_case["tmp"] / "shard_conv.npy")
    status = cli_infer.main(_shard_argv(shard_case, out, "--shard", "z2",
                                        "--report-convergence"))
    assert status == 0
    assert "--report-convergence: not wired for --shard (use --stream or " \
        "single-device)" in capsys.readouterr().out


def test_cli_cuda_without_card_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_infer.main(["--checkpoint", case["ckpt"], "--input", case["vol"],
                        "--output", str(case["tmp"] / "x.npy")])


NO_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "tpuseg"):
    sys.modules[name] = None            # any import of them now fails
import json, os, tempfile
import numpy as np, torch
import chip_smoke
import tpuseg_torch
from tpuseg_torch import ckpt, core, data, eval, infer, models, ops
from tpuseg_torch.cli import common, infer as cli_infer, train as cli_train
from tpuseg_torch.cli import evaluate as cli_evaluate, export as cli_export
from tpuseg_torch.eval import viz
from tpuseg_torch.utils import profiling
from tpuseg_torch.core import Config, InferConfig
from tpuseg_torch import losses, train
from tpuseg_torch.models import fused_eval, fused_train
from tpuseg_torch.parallel import multihost
from tpuseg_torch.train import dp

sv = data.synthesize_volume(shape=(12, 24, 40), num_instances=4,
                            radius_range=(3.0, 4.0), seed=1)
cfg = Config(infer=InferConfig(tile=(8, 16, 32), halo=2,
                               compute_dtype="float32"))
labels = infer.make_infer_fn(chip_smoke.AnalyticNet(), cfg)(
    torch.from_numpy(sv.image))
assert labels.dtype == torch.int32 and int(labels.max()) >= 1
with tempfile.TemporaryDirectory() as tmp:
    cfg = Config().override(**{"model.features": [4, 8],
                               "model.head_features": 4,
                               "infer.tile": [8, 16, 32], "infer.halo": 4})
    chip_smoke.write_seeded_checkpoint(os.path.join(tmp, "m.pth"), cfg.model)
    np.save(os.path.join(tmp, "v.npy"), sv.image)
    with open(os.path.join(tmp, "c.json"), "w") as f:
        f.write(cfg.to_json())
    status = cli_infer.main([
        "--device", "cpu", "--checkpoint", os.path.join(tmp, "m.pth"),
        "--input", os.path.join(tmp, "v.npy"),
        "--output", os.path.join(tmp, "o.npy"),
        "--config", os.path.join(tmp, "c.json")])
    assert status == 0 and np.load(os.path.join(tmp, "o.npy")).shape == (12, 24, 40)
    # the evaluation surface: export, evaluate, batched inference, viz
    cli_export.main(["--checkpoint", os.path.join(tmp, "m.pth"), "--output",
                     os.path.join(tmp, "x.pth"), "--config",
                     os.path.join(tmp, "c.json")])
    cli_evaluate.main(["--pred", os.path.join(tmp, "o.npy"),
                       "--gt", os.path.join(tmp, "o.npy")])
    tv = data.synthesize_touching_volume(shape=(12, 24, 40), num_pairs=2,
                                         num_singles=1, seed=1)
    small = Config(infer=InferConfig(tile=(8, 16, 32), halo=2,
                                     compute_dtype="float32"))
    batched = infer.make_batched_infer_fn(chip_smoke.AnalyticNet(), small)(
        torch.from_numpy(np.stack([sv.image, tv.image])))
    assert batched.shape == (2, 12, 24, 40)
    assert viz.overlay(tv.image, batched[1].numpy()).shape == (12, 24, 40, 3)
    with profiling.trace(None):
        profiling.hard_sync(batched)
    # training through its entry point, fused apply, then inference from the
    # trainer's checkpoint directory
    ck = os.path.join(tmp, "ck")
    cli_train.main(["--device", "cpu", "--synthetic", "1",
                    "--set", "model.features=[32,64]",
                    "--set", "data.patch_size=[8,16,64]",
                    "--set", "data.batch_size=2", "--set", "train.total_steps=2",
                    "--set", 'train.apply_impl="fused"',
                    "--set", "train.ckpt_dir=" + json.dumps(ck)])
    status = cli_infer.main([
        "--device", "cpu", "--checkpoint", ck,
        "--input", os.path.join(tmp, "v.npy"),
        "--output", os.path.join(tmp, "o2.npy"),
        "--set", "model.features=[32,64]", "--set", "infer.tile=[12,24,40]",
        "--set", "infer.halo=0"])
    assert status == 0 and np.load(os.path.join(tmp, "o2.npy")).shape == (12, 24, 40)
    # the same through the fused eval apply and the NMS kernel's composition
    # (their plain twins on the CPU)
    status = cli_infer.main([
        "--device", "cpu", "--checkpoint", ck,
        "--input", os.path.join(tmp, "v.npy"),
        "--output", os.path.join(tmp, "o3.npy"),
        "--set", "model.features=[32,64]", "--set", "infer.tile=[12,24,40]",
        "--set", "infer.halo=0", "--set", 'infer.apply_impl="fused"',
        "--set", 'postproc.nms_impl="pallas"'])
    assert status == 0 and np.load(os.path.join(tmp, "o3.npy")).shape == (12, 24, 40)
    # streamed: the function and the entry point (two chunks, resumable)
    streamed = infer.stream_infer(chip_smoke.AnalyticNet(), Config(
        infer=InferConfig(tile=(8, 16, 32), halo=2, compute_dtype="float32")),
        sv.image, chunk_z=8, halo=4, device="cpu")
    assert streamed.shape == (12, 24, 40) and int(streamed.max()) >= 1
    status = cli_infer.main([
        "--device", "cpu", "--checkpoint", os.path.join(tmp, "m.pth"),
        "--input", os.path.join(tmp, "v.npy"),
        "--output", os.path.join(tmp, "o4.npy"),
        "--config", os.path.join(tmp, "c.json"), "--stream", "8",
        "--resume-dir", os.path.join(tmp, "resume"), "--validate",
        "--report-convergence"])
    assert status in (0, 4) and np.load(os.path.join(tmp, "o4.npy")).shape == (12, 24, 40)
    # sharded: the function over a (z, y) mesh of CPU shards, and the entry
    # point's --shard and --stream-shard
    small = Config(infer=InferConfig(tile=(8, 16, 32), halo=2,
                                     compute_dtype="float32", shard_halo=4))
    mesh = infer.make_zy_mesh((2, 2), devices=["cpu"] * 4)
    sharded = infer.unshard(infer.make_sharded_infer_fn(
        chip_smoke.AnalyticNet(), small, mesh)(infer.shard_volume(
            sv.image, mesh)), mesh)
    assert sharded.shape == (12, 24, 40) and int(sharded.max()) >= 1
    for i, extra in enumerate((["--shard", "z2,y2"],
                               ["--stream", "8", "--stream-shard", "2"])):
        out = os.path.join(tmp, f"o5_{i}.npy")
        status = cli_infer.main([
            "--device", "cpu", "--checkpoint", os.path.join(tmp, "m.pth"),
            "--input", os.path.join(tmp, "v.npy"), "--output", out,
            "--config", os.path.join(tmp, "c.json"), "--set",
            "infer.shard_halo=4", *extra])
        assert status == 0 and np.load(out).shape == (12, 24, 40)
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "tpuseg")]
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    res = _run(["-c", NO_JAX])
    assert res.returncode == 0, res.stderr
    assert "NO_JAX_OK" in res.stdout


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # in the repository: no CUDA -> error, no result line
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert '"ok"' not in res.stdout
    # alone in a directory: the port is missing -> error, no result line
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    res = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert json.dumps({"ok": True}) not in res.stdout
