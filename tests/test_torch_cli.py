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

from test_torch_model import (_port_model, _randomized_variables,
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
    logits = make_infer_stages(_port_model(mcfg, variables), cfg)[1](
        torch.from_numpy(image))
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
                         case["cfg"])(torch.from_numpy(case["image"])).numpy()
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


@pytest.mark.parametrize("flag", [["--stream", "8"], ["--shard", "z2"],
                                  ["--calibrate-from", "a.npz"], ["--validate"]])
def test_cli_unported_flags_error(case, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_infer.main(["--checkpoint", case["ckpt"], "--input", case["vol"],
                        "--output", "x.npy", *flag])
    assert exc.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def test_cli_cuda_without_card_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_infer.main(["--checkpoint", case["ckpt"], "--input", case["vol"],
                        "--output", str(case["tmp"] / "x.npy")])


NO_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None            # any import of them now fails
import os, tempfile
import numpy as np, torch
import chip_smoke
import tpuseg_torch
from tpuseg_torch import ckpt, core, data, eval, infer, models, ops
from tpuseg_torch.cli import common, infer as cli_infer
from tpuseg_torch.core import Config, InferConfig

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
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax")]
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
