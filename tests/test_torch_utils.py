"""The port's profiling hooks and the TensorBoard writer of its metrics
logger (``tpuseg_torch/utils``), on the CPU: what the JAX package's
``utils/profiling.py`` and ``utils/logging.py`` promise, in torch."""

import json
import os
import struct
import sys

import pytest
import torch

from tpuseg_torch.utils import MetricsLogger, Timer, hard_sync, trace
from tpuseg_torch.utils.profiling import TRACE_FILE

from test_torch_model import single_torch_thread  # noqa: F401


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(None):                     # no directory: nothing recorded
        torch.mm(x, x)
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path / "t")):
        torch.mm(x, x)
    with open(tmp_path / "t" / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_hard_sync_and_timer():
    x = {"a": [torch.ones(3)], "b": 1}
    assert hard_sync(x) is x and hard_sync(5) == 5
    calls = []

    def fn(n):
        calls.append(n)
        return torch.ones(n)

    t = Timer().time(fn, 8, iters=3, warmup=1)
    assert t > 0 and calls == [8] * 4


def _scalars(log_dir):
    """(step, tag, value) of every scalar in the event files of
    ``log_dir``, read from their TFRecord framing (length, its checksum,
    the ``Event`` proto, its checksum) without TensorFlow."""
    from tensorboard.compat.proto import event_pb2

    out = []
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            event = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            out += [(event.step, v.tag, v.simple_value)
                    for v in event.summary.value]
    return out


def test_metrics_logger_tensorboard(tmp_path, monkeypatch):
    pytest.importorskip("tensorboard")
    # TensorFlow is not needed: keep its ~10 s import out of the test
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    log = MetricsLogger(str(tmp_path / "m.jsonl"), echo=False,
                        tensorboard_dir=str(tmp_path / "tb"))
    for step in (1, 2):
        log.log(step, {"loss": 1.0 / step, "grad_norm": 3.0})
    log.close()
    assert _scalars(tmp_path / "tb") == [
        (1, "loss", 1.0), (1, "grad_norm", 3.0),
        (2, "loss", 0.5), (2, "grad_norm", 3.0)]
    with open(tmp_path / "m.jsonl") as f:
        assert [json.loads(line)["loss"] for line in f] == [1.0, 0.5]


def test_metrics_logger_without_tensorboard(tmp_path, monkeypatch):
    """The writer is an opt-in: without the package it is off, the JSONL
    log goes on (the JAX package's ``ImportError -> None``)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = MetricsLogger(str(tmp_path / "m.jsonl"), echo=False,
                        tensorboard_dir=str(tmp_path / "tb"))
    log.log(1, {"loss": 2.0})
    log.close()
    assert not (tmp_path / "tb").exists()
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 1
