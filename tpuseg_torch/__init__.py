"""tpuseg_torch — the PyTorch/CUDA port of tpuseg for an NVIDIA H100.

The JAX package ``tpuseg`` stays the reference: this package mirrors its
layout (core, data, losses, models, ckpt, ops, infer, train, utils, cli)
so that each module's counterpart is easy to find, and
``tests/test_torch_*.py`` hold it against
``tpuseg`` on the same inputs. It imports ``torch`` and never JAX; of
``tpuseg`` it reads only the config dataclasses (``tpuseg.core.config``) and
the numpy instance metrics (``tpuseg.eval.instance_f1``).

Ported so far: the single-device inference path (``cli/infer.py`` ->
``infer/pipeline.make_infer_fn``) and the single-device weakly-supervised
training path (``cli/train.py`` -> ``train/loop.train``), with hand-written
CUDA kernels for the watershed's seed, chase and flood passes and for the
training path's full-resolution 3x3x3 conv (``csrc/``, built by
``ops/_build.py`` at first use). ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"
