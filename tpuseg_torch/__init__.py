"""tpuseg_torch — the PyTorch/CUDA port of tpuseg for an NVIDIA H100.

The JAX package ``tpuseg`` stays the reference: this package mirrors its
layout (core, data, losses, models, ckpt, ops, infer, train, utils, cli)
so that each module's counterpart is easy to find, and
``tests/test_torch_*.py`` hold it against
``tpuseg`` on the same inputs. It imports ``torch``, never JAX and nothing
of ``tpuseg``: what it needs from a module there (the config dataclasses,
the numpy instance metrics) it keeps as its own copy.

Ported so far: inference (``cli/infer.py`` -> ``infer/pipeline.make_infer_fn``,
streamed in z-chunks by ``infer/streaming.stream_infer``, sharded over a z
or (z, y) mesh in one process by ``infer/sharded.make_sharded_infer_fn``,
and the two composed) and the single-device weakly-supervised training
path (``cli/train.py`` -> ``train/loop.train``), with a
hand-written CUDA kernel for every Pallas kernel of the JAX package: the
watershed's seed, chase and flood passes, the peak NMS, the fused eval
ConvBlock and the training path's full-resolution 3x3x3 conv (``csrc/``,
built by ``ops/_build.py`` at first use). ROADMAP.md lists what is still to
come.
"""

__version__ = "0.1.0"
