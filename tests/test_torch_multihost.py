"""The port's multi-process runtime (``tpuseg_torch/parallel/multihost.py``)
under sharded and streamed x sharded inference: two real localhost
processes on gloo, each holding two of the mesh's shards, against the
single-process port and the JAX package's ``make_sharded_infer_fn`` /
``stream_infer`` on the virtual CPU devices of ``tests/conftest.py`` (the
legs of ``tests/distributed/_mh_worker.py``).

The workers are this file run as a script (``python
tests/test_torch_multihost.py LEG DIR``) under the ``TPUSEG_*`` environment: they block ``jax``, ``flax``
and ``tpuseg`` before importing the port, write what they computed to
``DIR``, and the tests compare it here. ``tests/test_torch_dp_train.py``
uses the same launcher.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "tpuseg")

INFER = dict(tile=(8, 32, 32), halo=4, compute_dtype="float32", shard_halo=8,
             shard_max_labels=256)
POST = dict(peak_threshold=0.5, fg_threshold=0.5, nms_radius=2, min_size=5,
            flood_iters=16)
SETTINGS = {"default": {}, "calibrated": {"fg_target_fraction": 0.03},
            "merge": {"merge_saddle_ratio": 0.8},
            "pallas": {"nms_impl": "pallas"}}
MESHES = {"z4": (("z",), (4,)), "zy22": (("z", "y"), (2, 2))}
STREAM_SETTINGS = {"default": {}, "merge": {"merge_saddle_ratio": 0.8},
                   "calibrated": {"fg_target_fraction": 0.05}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argv, n: int = 2, timeout: int = 300, backend=None) -> list:
    """``argv`` (after the interpreter) run as ``n`` processes of one group
    on localhost (the ``TPUSEG_*`` environment, two torch threads each):
    their standard outputs; fails unless every one exits 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               TPUSEG_COORDINATOR=f"127.0.0.1:{free_port()}",
               TPUSEG_NUM_PROCESSES=str(n))
    if backend:
        env["TPUSEG_DIST_BACKEND"] = backend
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO,
                              env=dict(env, TPUSEG_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out[-6000:]}"
    return outs


def run_workers(script: str, leg: str, tmp, n: int = 2, **kw) -> list:
    """``script``'s worker ``leg`` in ``n`` processes; returns each rank's
    saved results (``DIR/<leg>_rank<r>.npz``)."""
    run_processes([script, leg, str(tmp)], n, **kw)
    return [dict(np.load(os.path.join(tmp, f"{leg}_rank{r}.npz")))
            for r in range(n)]


def block_reference() -> None:
    """In a worker: make every import of the JAX package or its stack
    fail."""
    for name in REFERENCE:
        sys.modules[name] = None


def assert_reference_blocked() -> None:
    loaded = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in REFERENCE]
    assert not loaded, loaded


def port_cfg(**post):
    from tpuseg_torch.core import Config, InferConfig, PostprocConfig

    return Config(infer=InferConfig(**INFER),
                  postproc=PostprocConfig(**{**POST, **post}))


class Recorder:
    """An array-like volume that records the (z, y) ranges read from it."""

    def __init__(self, array):
        self.array, self.reads = array, []
        self.shape, self.dtype = array.shape, array.dtype

    def __getitem__(self, index):
        index = index if isinstance(index, tuple) else (index,)
        z = index[0]
        y = index[1] if len(index) > 1 else slice(0, self.shape[1])
        self.reads.append((max(z.start, 0), min(z.stop, self.shape[0]),
                           y.start, y.stop))
        return self.array[index]


# ---------------------------------------------------------------- workers


def _worker_infer(tmp: str) -> None:
    """Legs A, C, D of the reference's worker, in the port: sharded
    inference on z4 and (2, 2) meshes (two shards a process) under each
    setting, the y-sharded stream, its kill and resume, and the refusals."""
    from chip_smoke import AnalyticNet
    from tpuseg_torch.infer import (make_sharded_infer_fn, shard_volume,
                                    stream_infer, unshard)
    from tpuseg_torch.parallel import Mesh
    from tpuseg_torch.parallel.mesh import place_shards
    from tpuseg_torch.parallel.multihost import initialize, process_index

    assert initialize(device="cpu")
    rank = process_index()
    inputs = np.load(os.path.join(tmp, "inputs.npz"))
    out = {}
    for name, (axes, shape) in MESHES.items():
        mesh = Mesh(place_shards(int(np.prod(shape)), "cpu"), axes, shape)
        out[f"local_{name}"] = np.array(mesh.local_ranks())
        vol = Recorder(inputs[name])
        shards = shard_volume(vol, mesh)
        out[f"reads_{name}"] = np.array(vol.reads)
        for setting, post in SETTINGS.items():
            fn = make_sharded_infer_fn(AnalyticNet(), port_cfg(**post), mesh,
                                       normalize=False)
            out[f"A_{name}_{setting}"] = unshard(fn(shards), mesh)

    ymesh = Mesh(place_shards(4, "cpu"), ("y",))
    sv = inputs["stream"]
    for setting, post in STREAM_SETTINGS.items():
        src = Recorder(sv)
        out[f"C_{setting}"] = stream_infer(
            AnalyticNet(), port_cfg(**post), src, chunk_z=16, halo=8,
            normalize=False, mesh=ymesh, device="cpu")
        out[f"C_reads_{setting}"] = np.array(src.reads)

    # D: both processes abandon the stream after the same chunk, then resume
    # from their own directories
    rdir = os.path.join(tmp, f"resume_{rank}")

    class Stop(Exception):
        pass

    def stop(ci):
        raise Stop()

    kept = np.zeros(sv.shape, np.int32)
    with pytest.raises(Stop):
        stream_infer(AnalyticNet(), port_cfg(), sv, out=kept, chunk_z=16,
                     halo=8, normalize=False, mesh=ymesh, resume_dir=rdir,
                     on_chunk_done=stop, device="cpu")
    out["D_chunks_before"] = np.array(len(
        [f for f in os.listdir(rdir) if f.startswith("chunk_")]))
    out["D"] = stream_infer(AnalyticNet(), port_cfg(), sv, out=kept,
                            chunk_z=16, halo=8, normalize=False, mesh=ymesh,
                            resume_dir=rdir, device="cpu")
    # killed again after the first chunk, process 1 losing that chunk's
    # artifacts: both resume from the chunks every process finished
    rdir = os.path.join(tmp, f"resume_again_{rank}")
    kept = np.zeros(sv.shape, np.int32)
    with pytest.raises(Stop):
        stream_infer(AnalyticNet(), port_cfg(), sv, out=kept, chunk_z=16,
                     halo=8, normalize=False, mesh=ymesh, resume_dir=rdir,
                     on_chunk_done=stop, device="cpu")
    if rank == 1:
        os.remove(os.path.join(rdir, "chunk_000000.npz"))
    out["D_uneven"] = stream_infer(
        AnalyticNet(), port_cfg(), sv, out=kept, chunk_z=16, halo=8,
        normalize=False, mesh=ymesh, resume_dir=rdir, device="cpu")
    with pytest.raises(ValueError, match="multi-process stream needs a mesh"):
        stream_infer(AnalyticNet(), port_cfg(), sv, chunk_z=16, halo=8,
                     normalize=False, device="cpu")
    assert_reference_blocked()
    np.savez(os.path.join(tmp, f"infer_rank{rank}.npz"), **out)


WORKERS = {"infer": _worker_infer}


# ---------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The pre-normalized volumes of ``test_torch_sharded.py`` and
    ``test_torch_streamed_sharded.py``, as the JAX package normalizes
    them."""
    from tpuseg.data import synthesize_volume
    from tpuseg.data.normalize import percentile_normalize

    tmp = tmp_path_factory.mktemp("multihost")

    def norm(shape, n, seed):
        sv = synthesize_volume(shape=shape, num_instances=n,
                               radius_range=(3.0, 5.0), noise=0.0, seed=seed)
        return np.asarray(percentile_normalize(sv.image))

    arrays = {"z4": norm((64, 32, 32), 8, 4),
              "zy22": norm((32, 32, 32), 10, 9),
              "stream": norm((48, 64, 32), 10, 4)}
    np.savez(tmp / "inputs.npz", **arrays)
    return tmp, arrays


@pytest.fixture(scope="module")
def infer_ranks(inputs):
    tmp, _ = inputs
    return run_workers(__file__, "infer", tmp)


def _single_process(vol, name, post):
    from chip_smoke import AnalyticNet
    from tpuseg_torch.infer import make_sharded_infer_fn, shard_volume, unshard
    from tpuseg_torch.parallel import Mesh

    axes, shape = MESHES[name]
    mesh = Mesh([torch.device("cpu")] * int(np.prod(shape)), axes, shape)
    fn = make_sharded_infer_fn(AnalyticNet(), port_cfg(**post), mesh,
                               normalize=False)
    return unshard(fn(shard_volume(vol, mesh)), mesh)


def _reference(vol, name, post):
    """The JAX package's sharded labels on a mesh of the same shape."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from tpuseg.core import Config, InferConfig, PostprocConfig
    from tpuseg.infer import make_sharded_infer_fn as ref_fn
    from tpuseg.infer import shard_volume as ref_shard_volume

    from test_torch_pipeline import RefAnalyticNet

    axes, shape = MESHES[name]
    mesh = JaxMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), axes)
    cfg = Config(infer=InferConfig(**INFER),
                 postproc=PostprocConfig(**{**POST, **post}))
    fn = ref_fn(RefAnalyticNet(), cfg, mesh, normalize=False)
    return np.asarray(fn({"params": {}},
                         ref_shard_volume(jnp.asarray(vol), mesh)))


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("name", list(MESHES))
def test_two_process_sharded_equals_single_process_and_reference(
        infer_ranks, inputs, name, setting):
    """Leg A: every process gets the whole labeling, equal to the
    single-process port's and to the JAX package's elementwise."""
    vol = inputs[1][name]
    post = SETTINGS[setting]
    got = [r[f"A_{name}_{setting}"] for r in infer_ranks]
    np.testing.assert_array_equal(got[0], got[1])
    want = _single_process(vol, name, post)
    assert want.max() >= 6
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[0], _reference(vol, name, post))


@pytest.mark.parametrize("name", list(MESHES))
def test_each_process_reads_only_its_slabs(infer_ranks, name):
    """``shard_volume`` under two processes: process r holds shards 2r and
    2r + 1 and reads exactly their slabs."""
    axes, shape = MESHES[name]
    for rank, res in enumerate(infer_ranks):
        local = [2 * rank, 2 * rank + 1]
        assert res[f"local_{name}"].tolist() == local
        dl = 64 // 4 if name == "z4" else 32 // 2
        want = []
        for r in local:
            iz, iy = (np.unravel_index(r, shape) + (0,))[:2]
            hl = 32 // (shape[1] if len(shape) == 2 else 1)
            want.append((iz * dl, (iz + 1) * dl, iy * hl, (iy + 1) * hl))
        assert [tuple(int(v) for v in r) for r in res[f"reads_{name}"]] \
            == want


def _one_shot(vol, post):
    from chip_smoke import AnalyticNet
    from tpuseg_torch.infer import make_infer_fn

    return make_infer_fn(AnalyticNet(), port_cfg(**post), False)(
        torch.from_numpy(vol)).numpy()


def _reference_stream(vol, post):
    import jax
    from jax.sharding import Mesh as JaxMesh

    from tpuseg.core import Config, InferConfig, PostprocConfig
    from tpuseg.infer import stream_infer as ref_stream_infer

    from test_torch_pipeline import RefAnalyticNet

    cfg = Config(infer=InferConfig(**INFER),
                 postproc=PostprocConfig(**{**POST, **post}))
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("y",))
    return ref_stream_infer(RefAnalyticNet(), cfg, {"params": {}}, vol,
                            chunk_z=16, halo=8, normalize=False, mesh=mesh)


@pytest.mark.parametrize("setting", list(STREAM_SETTINGS))
def test_two_process_streamed_sharded_equals_one_shot(infer_ranks, inputs,
                                                      setting):
    """Leg C: the stream with each chunk over 4 y-shards, two a process,
    equals the one-shot labels (and the JAX package's y-sharded stream
    without the merge, whose per-slab merge differs), and each process
    reads only its shards' rows of each chunk."""
    vol = inputs[1]["stream"]
    post = STREAM_SETTINGS[setting]
    got = [r[f"C_{setting}"] for r in infer_ranks]
    np.testing.assert_array_equal(got[0], got[1])
    want = _one_shot(vol, post)
    assert want.max() >= 8
    np.testing.assert_array_equal(got[0], want)
    if setting != "merge":
        np.testing.assert_array_equal(got[0], _reference_stream(vol, post))
    for rank, res in enumerate(infer_ranks):
        rows = {(int(r[2]), int(r[3])) for r in res[f"C_reads_{setting}"]}
        assert rows == {(rank * 32, rank * 32 + 32)}


def test_two_process_stream_kill_and_resume(infer_ranks, inputs):
    """Leg D: killed after the first chunk, resumed from per-process
    directories: the uninterrupted labels; also when one process lost the
    chunk's artifacts and both start over."""
    want = _one_shot(inputs[1]["stream"], {})
    for res in infer_ranks:
        assert int(res["D_chunks_before"]) == 1
        np.testing.assert_array_equal(res["D"], want)
        np.testing.assert_array_equal(res["D_uneven"], want)


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A small seeded U-Net checkpoint, a volume and its config."""
    from chip_smoke import write_seeded_checkpoint
    from tpuseg_torch.core import Config
    from tpuseg_torch.data import synthesize_volume

    tmp = tmp_path_factory.mktemp("mh_cli")
    cfg = Config().override(**{
        "model.features": [4, 8], "model.head_features": 4,
        "model.compute_dtype": "float32", "infer.compute_dtype": "float32",
        "infer.tile": [8, 32, 32], "infer.halo": 4, "infer.shard_halo": 8,
        "postproc.fg_target_fraction": 0.05})
    write_seeded_checkpoint(str(tmp / "m.pth"), cfg.model, seed=5)
    sv = synthesize_volume(shape=(32, 32, 32), num_instances=6,
                           radius_range=(3.0, 5.0), seed=3)
    np.save(tmp / "v.npy", sv.image)
    (tmp / "c.json").write_text(cfg.to_json())
    return tmp


def _cli_args(tmp, out, *extra):
    return ["--device", "cpu", "--checkpoint", str(tmp / "m.pth"),
            "--input", str(tmp / "v.npy"), "--output", str(out),
            "--config", str(tmp / "c.json"), "--validate", *extra]


@pytest.mark.parametrize("extra", [("--shard", "z2"),
                                   ("--stream", "16", "--stream-shard", "2",
                                    "--resume-dir", "RESUME")],
                         ids=["shard", "stream_shard"])
def test_cli_infer_in_two_processes(cli_case, extra):
    """``python -m tpuseg_torch.cli.infer`` started as two processes: one
    line per process, rank 0 alone writes the output, equal to the
    single-process call's file; both exit 0 with the validation passed."""
    from tpuseg_torch.cli import infer as cli_infer

    tag = extra[0].strip("-")

    def args(run):
        return _cli_args(cli_case, cli_case / f"{run}_{tag}.npy", *(
            str(cli_case / f"resume_{run}") if e == "RESUME" else e
            for e in extra))

    assert cli_infer.main(args("one")) == 0
    outs = run_processes(["-m", "tpuseg_torch.cli.infer", *args("two")])
    for r, out in enumerate(outs):
        assert f"process {r}/2 on cpu, backend gloo" in out
        assert ("connectivity validation: OK" in out) == (r == 0)
    got = np.load(cli_case / f"two_{tag}.npy")
    want = np.load(cli_case / f"one_{tag}.npy")
    assert want.max() >= 2
    np.testing.assert_array_equal(got, want)
    if tag == "stream":
        assert sorted(os.listdir(cli_case / "resume_two")) == [
            "process_0", "process_1"]


def test_initialize_without_environment_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from tpuseg_torch.parallel.multihost import (initialize, is_distributed,
                                                 process_count, process_index)

    for name in ("TPUSEG_COORDINATOR", "TPUSEG_NUM_PROCESSES",
                 "TPUSEG_PROCESS_ID", "TPUSEG_DIST_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    assert initialize(device="cpu") is False
    assert not dist.is_initialized() and not is_distributed()
    assert (process_index(), process_count()) == (0, 1)
    monkeypatch.setenv("TPUSEG_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="TPUSEG_COORDINATOR"):
        initialize(device="cpu")
    assert not dist.is_initialized()


def test_mesh_without_group_is_local():
    """Without a process group every shard belongs to process 0, as
    before the runtime existed."""
    from tpuseg_torch.parallel import Mesh

    mesh = Mesh(["cpu"] * 4, ("z", "y"), (2, 2))
    assert mesh.processes == (0, 0, 0, 0)
    assert mesh.local_ranks() == [0, 1, 2, 3]


if __name__ == "__main__":
    block_reference()
    torch.set_num_threads(2)
    WORKERS[sys.argv[1]](sys.argv[2])
