"""The captured programs of ``tpuseg_torch/infer/graph.py``, on the CPU.

A CUDA graph cannot be captured here, so the wrapper's logic runs against a
stand-in backend (``StandIn``): its "capture" runs the body once on the
static arguments, as a capture records it, and its "replay" runs the body
again on them and writes the results into the captured outputs, putting
the host counters back as they were, since a real replay runs no Python.
That holds the wrapper's part: eager at first sight, capture at the second
call, replays after, one graph a key, counter deltas, state, errors, the
settings that never capture, the release of the graphs when the model's
storage moves, and fresh outputs from static arguments (a stale argument
would show as a wrong label). The real pipeline, batched and sharded bodies run through
it on small volumes and equal their eager bodies exactly; the sharded call
with ``z_offset`` as a tensor equals the int path and the JAX package's
``make_sharded_infer_fn`` on the same offset block. Labels are integers:
no tolerance. The real capture runs on the card (``chip_smoke.py`` phase
20)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core import Config, InferConfig, PostprocConfig
from tpuseg.data import synthesize_volume
from tpuseg.infer import make_sharded_infer_fn as ref_make_sharded_infer_fn
from tpuseg.infer import make_z_mesh as ref_make_z_mesh
from tpuseg.infer import shard_volume as ref_shard_volume
from tpuseg_torch.infer import (make_batched_infer_fn, make_infer_fn,
                                make_infer_stages, make_sharded_infer_fn,
                                make_z_mesh, shard_volume, unshard)
from tpuseg_torch.infer.graph import (CapturedProgram, Chain, CudaGraphs,
                                      eager_reason, module_state, signature)
from tpuseg_torch.ops import LAST_CALL_STATE, resolve
from tpuseg_torch.ops.convblock import fused_convblock
from tpuseg_torch.ops.merge import saddle_merge

from chip_smoke import AnalyticNet
from test_torch_model import port_config, single_torch_thread  # noqa: F401
from test_torch_pipeline import RefAnalyticNet

CPU8 = [torch.device("cpu")] * 8


class _StandInGraph:
    def __init__(self, fn, args, out):
        self.fn, self.args, self.out, self.replays = fn, args, out, 0


class StandIn:
    """A graph backend that takes CPU tensors (module docstring)."""

    released = []

    @staticmethod
    def accepts(devices):
        return len(devices) == 1

    @staticmethod
    def new_pool():
        return object()

    @staticmethod
    def capture(fn, args, pool, device, generators=()):
        out = fn(*args)
        return _StandInGraph(fn, args, out), out, 0

    @staticmethod
    def replay(graph, device):
        from tpuseg_torch.infer.graph import _counters, _tensors

        counters = [(o, a, getattr(o, a)) for o, a in _counters()]
        fresh = graph.fn(*graph.args)
        for o, a, n in counters:
            setattr(o, a, n)
        for dst, src in zip(_tensors(graph.out), _tensors(fresh)):
            dst.copy_(src)
        graph.replays += 1

    @staticmethod
    def release(graphs):
        StandIn.released.extend(graphs)


@pytest.fixture
def standin_cuda(monkeypatch):
    """The factories' programs on the stand-in backend, which takes the
    CPU as the card."""
    for name in ("accepts", "new_pool", "capture", "replay", "release"):
        monkeypatch.setattr(CudaGraphs, name, getattr(StandIn, name))


class FailingCapture(StandIn):
    @staticmethod
    def capture(fn, args, pool, device, generators=()):
        raise RuntimeError("operation not permitted when stream is capturing")


def _affine(calls):
    def body(x):
        calls.append(x.shape)
        return {"y": x * 2 + 1, "n": (x.sum(),)}
    return body


def test_eager_first_sight_then_capture_then_replay():
    calls = []
    prog = CapturedProgram(_affine(calls), backend=StandIn)
    xs = [torch.arange(6.0).reshape(2, 3) + k for k in range(4)]
    runs = []
    outs = []
    for x in xs:
        outs.append(prog(x))
        runs.append(prog.last_run)
    assert runs == ["eager: first sight", "capture", "replay", "replay"]
    for x, out in zip(xs, outs):        # each call on its own input
        torch.testing.assert_close(out["y"], x * 2 + 1, rtol=0, atol=0)
        assert float(out["n"][0]) == float(x.sum())
    assert len(prog.graphs) == 1
    graph = next(iter(prog.graphs.values()))
    assert graph.graph.replays == 3      # the capture call's and two more
    # a caller keeps its result: outputs are clones, not the graph's own
    assert outs[2]["y"].data_ptr() != outs[3]["y"].data_ptr()
    assert all(o["y"].data_ptr() != t.data_ptr()
               for o in outs for t in graph.outputs)
    # the body ran eagerly once, once in the capture, and then only in the
    # stand-in's replays
    assert len(calls) == 2 + 3


def test_one_graph_per_key():
    prog = CapturedProgram(_affine([]), backend=StandIn)
    args = [torch.zeros(2, 3), torch.zeros(3, 2),
            torch.zeros(2, 3, dtype=torch.float64)]
    for _ in range(3):
        for a in args:
            prog(a)
    assert len(prog.graphs) == 3 and prog.last_run == "replay"
    assert set(prog.graphs) == {signature((a,)) for a in args}


@pytest.mark.parametrize("a,b", [
    ((torch.zeros(2, 3),), (torch.zeros(3, 2),)),
    ((torch.zeros(2, 3),), (torch.zeros(2, 3, dtype=torch.int32),)),
    ((torch.zeros(2, 3),), (torch.zeros(2, 3, device="meta"),)),
    ((torch.zeros(2), 1), (torch.zeros(2), 2)),
    (([torch.zeros(2)],), ((torch.zeros(2),),)),
])
def test_keys_by_shape_dtype_device_and_values(a, b):
    assert signature(a) != signature(b)
    assert signature(a) == signature(tuple(
        x.clone() if isinstance(x, torch.Tensor) else x for x in a))


def test_counter_deltas_are_added_on_each_replay():
    def body(x):
        resolve.chase_pass.launches += 128
        fused_convblock.mma_launches += 3
        return x + 1

    prog = CapturedProgram(body, backend=StandIn)
    c0 = resolve.chase_pass.launches
    m0 = fused_convblock.mma_launches
    for k in range(5):
        prog(torch.zeros(4))
        assert resolve.chase_pass.launches == c0 + 128 * (k + 1)
        assert fused_convblock.mma_launches == m0 + 3 * (k + 1)


def test_state_points_at_the_graphs_buffers_after_a_replay():
    holder = types.SimpleNamespace(last_count=None)

    def body(x):
        resolve.chase_resolve.last_gates = (x > 0).to(torch.int32)
        saddle_merge.last_dropped = x[:3].to(torch.int32)
        holder.last_count = x.sum()
        return x

    prog = CapturedProgram(body, state=((holder, "last_count"),),
                           backend=StandIn)
    prog(torch.ones(4))
    prog(torch.ones(4))                                   # capture
    graph = next(iter(prog.graphs.values()))
    captured = {(id(h), a): v for h, a, v in graph.state}
    resolve.chase_resolve.last_gates = saddle_merge.last_dropped = None
    holder.last_count = None
    prog(torch.ones(4))                                   # replay
    for h, a in ((resolve.chase_resolve, "last_gates"),
                 (saddle_merge, "last_dropped"), (holder, "last_count")):
        assert getattr(h, a) is captured[id(h), a]
        assert isinstance(getattr(h, a), torch.Tensor)


def test_wrapper_state_is_declared_beside_the_wrappers():
    """Every wrapper that keeps its last call's state declares it in
    ``ops.LAST_CALL_STATE``; a program sets each after a replay."""
    from tpuseg_torch.ops import merge

    assert set(LAST_CALL_STATE) == {(resolve.chase_resolve, "last_gates"),
                                    (resolve.flood_resolve, "last_gates"),
                                    (merge.saddle_merge, "last_dropped")}
    assert all(hasattr(h, a) for h, a in LAST_CALL_STATE)
    prog = CapturedProgram(_affine([]), state=((types.SimpleNamespace(),
                                                "x"),))
    assert prog.state[:len(LAST_CALL_STATE)] == LAST_CALL_STATE


def test_capture_error_propagates_without_an_eager_result():
    calls = []
    prog = CapturedProgram(_affine(calls), backend=FailingCapture)
    prog(torch.zeros(3))                                  # first sight
    for _ in range(2):
        with pytest.raises(RuntimeError, match="stream is capturing"):
            prog(torch.zeros(3))
    assert len(calls) == 1 and not prog.graphs


def test_cpu_tensors_never_capture(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CPU call reached torch.cuda")

    monkeypatch.setattr(CudaGraphs, "capture", no_cuda)
    monkeypatch.setattr(CudaGraphs, "new_pool", no_cuda)
    prog = CapturedProgram(_affine([]))
    for _ in range(3):
        prog(torch.zeros(3))
        assert prog.last_run == "eager: not on one CUDA device"
    assert not prog.graphs and prog.mode == "captured"
    assert not CudaGraphs.accepts({torch.device("cpu")})
    assert not CudaGraphs.accepts({torch.device("cuda", 0),
                                   torch.device("cuda", 1)})
    assert CudaGraphs.accepts({torch.device("cuda", 1)})


@pytest.mark.parametrize("program", ["fused", "staged"])
def test_program_restarts_when_the_model_moves(program):
    """A graph reads the weights where they were at its capture: when a
    parameter's storage, dtype or a training flag changes, the program
    releases its graphs and the next call of the key runs eagerly."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.BatchNorm1d(3))
    net.eval()

    def body(x):
        return net(x)

    def post(y):
        return y + 1

    kw = {"context": lambda: module_state(net), "backend": StandIn}
    prog = (Chain(body, post, eager=lambda x: post(body(x)), **kw)
            if program == "staged" else
            CapturedProgram(lambda x: post(body(x)), **kw))
    x = torch.ones(2, 3)
    first = ("eager: first sight", "capture", "replay")
    if program == "staged":
        first = tuple(f"{r} + {r}" for r in first)
    StandIn.released.clear()
    runs = []
    for change in (None, lambda: setattr(net[0].weight, "data",
                                         net[0].weight.data.clone()),
                   lambda: setattr(net[1], "running_mean",
                                   net[1].running_mean.clone()),
                   lambda: net.train(), lambda: net.eval()):
        if change is not None:
            change()
        for _ in range(3):
            out = prog(x)
            runs.append(prog.last_run)
        torch.testing.assert_close(out, post(body(x)), rtol=0, atol=0)
    assert tuple(runs) == first * 5
    assert len(StandIn.released) == 4 * (2 if program == "staged" else 1)
    assert len(prog.graphs) == (2 if program == "staged" else 1)


def test_release_frees_the_graphs_and_starts_over():
    prog = CapturedProgram(_affine([]), backend=StandIn)
    StandIn.released.clear()
    for _ in range(2):
        prog(torch.zeros(3))
    graph = next(iter(prog.graphs.values())).graph
    prog.release()
    assert not prog.graphs and StandIn.released == [graph]
    prog(torch.zeros(3))
    assert prog.last_run == "eager: first sight"
    prog.release()                                        # nothing to free
    assert StandIn.released == [graph]


@pytest.mark.parametrize("resolve_impl,plain,want", [
    ("auto", False, None),
    ("pallas", False, None),
    ("xla", False, "eager: resolve_impl='xla' reads the host"),
    ("auto", True, "eager: plain twins"),
])
def test_eager_reason(resolve_impl, plain, want):
    assert eager_reason(Config(postproc=PostprocConfig(
        resolve_impl=resolve_impl)), plain) == want


# --------------------------------------------------------- the real bodies


@pytest.fixture(scope="module")
def cfg():
    return Config(
        infer=InferConfig(tile=(8, 32, 32), halo=4, compute_dtype="float32",
                          shard_halo=8, shard_max_labels=256),
        postproc=PostprocConfig(peak_threshold=0.5, fg_threshold=0.5,
                                nms_radius=2, min_size=5, flood_iters=16),
    )


@pytest.fixture(scope="module")
def volumes():
    """Three volumes of one shape, each of other nuclei."""
    return [synthesize_volume(shape=(16, 32, 32), num_instances=6,
                              radius_range=(3.0, 5.0), noise=0.0,
                              seed=s).image for s in (0, 1, 2)]


def _with(cfg, **sections):
    import dataclasses

    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v)
        for k, v in sections.items()})


@pytest.mark.parametrize("program", ["fused", "staged"])
def test_pipeline_replays_equal_the_eager_body(cfg, volumes, program):
    """Fresh volumes through the stand-in's capture and replays equal the
    eager body; merge and calibration on, with diagnostics."""
    c = port_config(_with(cfg, infer={"program": program},
                          postproc={"merge_saddle_ratio": 0.5,
                                    "fg_target_fraction": 0.05}))
    infer, net, post = make_infer_stages(AnalyticNet(), c,
                                         with_diagnostics=True)
    prog = (Chain(net, post, eager=infer, backend=StandIn)
            if program == "staged" else
            CapturedProgram(infer, backend=StandIn))
    for v in volumes + volumes[:1]:
        vol = torch.from_numpy(v)
        got, diag = prog(vol)
        want, wdiag = infer(vol)
        assert want.max() > 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert int(diag["flood_truncated"]) == int(wdiag["flood_truncated"])
    assert prog.last_run.split(" + ")[-1] == "replay"
    assert len(prog.graphs) == (2 if program == "staged" else 1)


def test_staged_equals_fused(cfg, volumes):
    """``InferConfig.program="staged"`` gives the fused program's labels."""
    out = {}
    for program in ("fused", "staged"):
        infer = make_infer_fn(AnalyticNet(), port_config(
            _with(cfg, infer={"program": program})))
        assert isinstance(infer, Chain if program == "staged"
                          else CapturedProgram)
        out[program] = [infer(torch.from_numpy(v)) for v in volumes]
    for a, b in zip(out["fused"], out["staged"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("program", ["fused", "staged"])
def test_batched_replays_equal_single_calls(cfg, volumes, program):
    c = port_config(_with(cfg, infer={"program": program}))
    eager = make_batched_infer_fn(AnalyticNet(), c).eager
    stages = make_infer_stages(AnalyticNet(), c)
    prog = (Chain(*[p.eager for p in make_batched_infer_fn(
        AnalyticNet(), c).programs], eager=eager, backend=StandIn)
        if program == "staged" else CapturedProgram(eager, backend=StandIn))
    stack = torch.from_numpy(np.stack(volumes))
    for k in range(3):
        vols = torch.roll(stack, k, dims=0)
        got = prog(vols)
        for i in range(len(volumes)):
            torch.testing.assert_close(got[i], stages[0](vols[i]), rtol=0,
                                       atol=0)
    assert len(prog.graphs) == (2 if program == "staged" else 1)


def test_sharded_z_offset_tensor_equals_int_and_reference(cfg, volumes,
                                                          standin_cuda):
    """z8 over a 64-plane block of the three volumes at z_offset 64,
    through the factory's captured function on the stand-in backend: the
    0-d tensor offset, the int offset, the eager body and the JAX
    package's sharded call give one labelling, and calls at other offsets
    replay the one graph and equal the eager body at them."""
    vol = np.concatenate(volumes + volumes[:1])           # (64, 32, 32)
    c = port_config(cfg)
    mesh = make_z_mesh(devices=CPU8)
    infer = make_sharded_infer_fn(AnalyticNet(), c, mesh, normalize=False)
    assert infer.mode == "captured"
    shards = shard_volume(vol, mesh)
    by_int = unshard(infer(shards, z_offset=64), mesh)
    by_tensor = unshard(infer(shards, z_offset=torch.tensor(64)), mesh)
    assert infer.program.last_run == "capture"
    eager = unshard(infer.eager(shards, 64), mesh)
    rmesh = ref_make_z_mesh()
    ref = np.asarray(ref_make_sharded_infer_fn(
        RefAnalyticNet(), cfg, rmesh, normalize=False)(
        {"params": {}}, ref_shard_volume(jnp.asarray(vol), rmesh),
        z_offset=64))
    assert by_int.max() > 10
    for got in (by_tensor, eager, ref):
        np.testing.assert_array_equal(got, by_int)

    for z in (0, 3_000_000, torch.tensor(64)):
        np.testing.assert_array_equal(unshard(infer(shards, z), mesh),
                                      by_int)
        assert infer.program.last_run == "replay"
    assert len(infer.program.graphs) == 1


def test_sharded_tensor_offset_moves_the_root_coordinates(cfg, volumes,
                                                          monkeypatch):
    """The labels do not show the offset (every coordinate moves by one
    amount): the body's root coordinates at a 0-d tensor offset are those
    at 0 moved by ``z * H * W``, the sentinels kept."""
    from tpuseg_torch.infer import sharded

    vol = np.concatenate(volumes[:2])                     # (32, 32, 32)
    mesh = make_z_mesh(devices=CPU8[:4])
    infer = make_sharded_infer_fn(AnalyticNet(), port_config(cfg), mesh,
                                  normalize=False)
    shards = shard_volume(vol, mesh)
    seen = []
    orig = sharded.global_lin
    monkeypatch.setattr(sharded, "global_lin",
                        lambda *a: seen.append(orig(*a)) or seen[-1])
    keys = {}
    for z in (0, 3_000_000):
        seen.clear()
        infer(shards, torch.tensor(z, dtype=torch.int64))
        keys[z] = torch.cat(seen)
    used = keys[0] != torch.iinfo(torch.int64).max
    assert used.sum() > 10
    torch.testing.assert_close(keys[3_000_000][used],
                               keys[0][used] + 3_000_000 * 32 * 32,
                               rtol=0, atol=0)
    assert torch.equal(keys[3_000_000][~used], keys[0][~used])


@pytest.mark.parametrize("card", [False, True])
def test_sharded_modes(cfg, monkeypatch, request, card):
    """Shards on one card capture (``card``: the stand-in takes the CPU as
    the card); shards on the CPU, on several devices, under a process
    group, with the plain twins or ``resolve_impl="xla"`` run eagerly (no
    program)."""
    from tpuseg_torch.infer import sharded
    from tpuseg_torch.parallel import Mesh

    if card:
        request.getfixturevalue("standin_cuda")
    c = port_config(cfg)
    one = make_sharded_infer_fn(AnalyticNet(), c, make_z_mesh(devices=CPU8))
    assert one.mode == ("captured" if card else "eager: not on a CUDA device")
    assert isinstance(getattr(one, "program", None), CapturedProgram) == card
    several = make_sharded_infer_fn(
        AnalyticNet(), c, Mesh(["cpu", "meta"], ("z",), (2,)))
    plain = make_sharded_infer_fn(AnalyticNet(), c,
                                  make_z_mesh(devices=CPU8), plain=True)
    xla = make_sharded_infer_fn(AnalyticNet(), _with(
        c, postproc={"resolve_impl": "xla"}), make_z_mesh(devices=CPU8))
    monkeypatch.setattr(sharded, "is_distributed", lambda: True)
    group = make_sharded_infer_fn(AnalyticNet(), c,
                                  make_z_mesh(devices=CPU8))
    for fn, mode in ((several, "eager: several devices"),
                     (plain, "eager: plain twins"),
                     (xla, "eager: resolve_impl='xla' reads the host"),
                     (group, "eager: process group")):
        assert fn.mode == mode and fn is fn.eager
        assert not hasattr(fn, "program")


@pytest.mark.parametrize("program", ["fused", "staged"])
def test_pipeline_modes(cfg, volumes, standin_cuda, program):
    """On the (stand-in) card the factories capture, except under
    ``resolve_impl="xla"``, whose flood reads the host once a pass: its
    programs state why and run the eager body on every call."""
    from tpuseg_torch.infer import infer_volume

    c = port_config(_with(cfg, infer={"program": program}))
    xc = _with(c, postproc={"resolve_impl": "xla"})
    reason = "eager: resolve_impl='xla' reads the host"
    stack = torch.from_numpy(np.stack(volumes[:2]))
    for conf, mode in ((c, "captured"), (xc, reason)):
        net = AnalyticNet()
        fns = (make_infer_fn(net, conf), make_batched_infer_fn(net, conf))
        for fn, x in zip(fns, (stack[0], stack)):
            assert fn.mode == mode
            want = fn.eager(x)
            for _ in range(3):
                torch.testing.assert_close(fn(x), want, rtol=0, atol=0)
            last = fn.last_run.split(" + ")
            assert set(last) == {"replay" if mode == "captured" else reason}
            assert bool(fn.graphs) == (mode == "captured")
        for _ in range(3):
            infer_volume(net, volumes[0], conf, device="cpu")
        (prog,) = net._infer_volume_programs.values()
        assert prog.mode == mode and bool(prog.graphs) == (mode == "captured")


def test_infer_volume_keeps_one_program_per_configuration(cfg, volumes):
    """``infer_volume`` keeps its function on the model, one per
    configuration and ``normalize``, so a later call can replay it; the
    labels are ``make_infer_fn``'s."""
    from tpuseg_torch.infer import infer_volume, release_infer_volume

    net, c = AnalyticNet(), port_config(cfg)
    for v in volumes:
        got = infer_volume(net, v, c, normalize=False, device="cpu")
        want = make_infer_fn(net, c, normalize=False)(torch.from_numpy(v))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    infer_volume(net, volumes[0], c, device="cpu")
    programs = net._infer_volume_programs
    assert list(programs) == [(c, False), (c, True)]
    assert all(isinstance(p, CapturedProgram) for p in programs.values())
    release_infer_volume(net)
    assert not hasattr(net, "_infer_volume_programs")
