"""The plain MedNeXt: forward (and, under autograd, backward) from a state
dict, in float32 (TF32 off where it decides ``correct``: ``readings`` sets
``reference.exact_float32`` first; the reference trainer turns TF32 on for
the weights, which are an input).

The published net (Roy et al., MICCAI 2023, arXiv:2303.09975; MIC-DKFZ's
``nnunet_mednext/network_architecture/mednextv1/blocks.py`` and
``MedNextV1.py``, ``create_mednextv1_large`` at kernel 5), written from its
equations:

* stem: Conv3d(in -> n, k 1, bias);
* block (C, R): ``x + conv3(GELU(conv2(GN(dw(x)))))``, ``dw`` Conv3d(C ->
  C, k 5, pad 2, groups C, bias), GN ``F.group_norm`` with C groups (eps
  1e-5, affine), conv2 Conv3d(C -> R C, k 1, bias), erf GELU, conv3
  Conv3d(R C -> C, k 1, bias);
* down (C -> 2C, R): the block's body with ``dw`` at stride 2 and conv3
  to 2C, plus Conv3d(C -> 2C, k 1, stride 2, bias) of the input;
* up (C -> C / 2, R): the block's body with ``dw`` ConvTranspose3d(C ->
  C, k 5, stride 2, pad 2, groups C, bias) and conv3 to C / 2, zero-padded
  by one plane at the low end of each axis, plus ConvTranspose3d(C -> C /
  2, k 1, stride 2, bias) of the input padded the same way;
* encoder levels 0-3 (blocks, then down), the bottleneck, decoder levels
  3-0 (``dec_i(skip_i + up_i(x))``), ``block_counts`` and ``exp_r`` over
  those nine stages in that order; the head ConvTranspose3d(n -> out, k 1,
  bias), whose channels 0 and 1 are ``fg_logits`` and ``peak_logits``.

Departures from the published code: two output channels, the pipeline's
fg and peak maps; no deep-supervision heads (off at inference); no GRN
(off in the published L); parameter names are the port's
(``arch/mednext.state_shapes``): ``enc.<level>.<block>``,
``down.<level>``, ``bottleneck.<block>``, ``up.<level>``,
``dec.<level>.<block>``, not MIC-DKFZ's ``enc_block_<level>``,
``down_<level>``, ``up_<level>``, ``dec_block_<level>``, ``out_0``.

``quant``, where given, rounds every conv's and transposed conv's input
and kernel (``reference/quant.py``: the controls' lower precisions). The
net has no running statistics: ``train`` and ``stats`` change nothing.
"""

from __future__ import annotations

import torch.nn.functional as F

EPS = 1e-5
LEVELS = 4
LOW_PAD = (1, 0, 1, 0, 1, 0)


def _q(quant, *ts):
    return ts if quant is None else tuple(quant(t) for t in ts)


def _conv(x, p, name, quant, transposed=False, **kw):
    x, w = _q(quant, x, p[f"{name}.weight"])
    fn = F.conv_transpose3d if transposed else F.conv3d
    return fn(x, w, p[f"{name}.bias"], **kw)


def _body(x, p, name, kind, k, quant):
    c = x.shape[1]
    if kind == "up":
        y = _conv(x, p, f"{name}.conv1", quant, transposed=True, stride=2,
                  padding=k // 2, groups=c)
    else:
        y = _conv(x, p, f"{name}.conv1", quant, stride=2 if kind == "down"
                  else 1, padding=k // 2, groups=c)
    y = F.group_norm(y, c, p[f"{name}.norm.weight"], p[f"{name}.norm.bias"],
                     EPS)
    y = F.gelu(_conv(y, p, f"{name}.conv2", quant))
    return _conv(y, p, f"{name}.conv3", quant)


def _block(x, p, name, k, quant):
    return x + _body(x, p, name, "block", k, quant)


def _down(x, p, name, k, quant):
    return (_body(x, p, name, "down", k, quant)
            + _conv(x, p, f"{name}.res_conv", quant, stride=2))


def _up(x, p, name, k, quant):
    y = F.pad(_body(x, p, name, "up", k, quant), LOW_PAD)
    res = _conv(x, p, f"{name}.res_conv", quant, transposed=True, stride=2)
    return y + F.pad(res, LOW_PAD)


def _stage(x, p, name, count, k, quant):
    for j in range(count):
        x = _block(x, p, f"{name}.{j}", k, quant)
    return x


def forward(p: dict, x, model: dict, train: bool = False,
            stats: dict | None = None, quant=None) -> dict:
    """``{"fg_logits", "peak_logits"}`` (N, D, H, W) float32 of the
    (N, D, H, W) or (N, 1, D, H, W) float32 ``x`` (sides multiples of
    16); ``p`` maps the parameter names to float32 tensors, ``model`` is a
    configuration's ``model`` group (``block_counts``, ``kernel_size``)."""
    if x.dim() == 4:
        x = x[:, None]
    assert all(s % 2 ** LEVELS == 0 for s in x.shape[2:]), x.shape
    n, k = model["block_counts"], model["kernel_size"]
    y = _stage(_conv(x, p, "stem", quant), p, "enc.0", n[0], k, quant)
    skips = [y]
    for i in range(1, LEVELS):
        y = _stage(_down(y, p, f"down.{i - 1}", k, quant), p, f"enc.{i}",
                   n[i], k, quant)
        skips.append(y)
    y = _stage(_down(y, p, f"down.{LEVELS - 1}", k, quant), p, "bottleneck",
               n[LEVELS], k, quant)
    for i in reversed(range(LEVELS)):
        y = _stage(skips[i] + _up(y, p, f"up.{i}", k, quant), p, f"dec.{i}",
                   n[2 * LEVELS - i], k, quant)
    out = _conv(y, p, "head", quant, transposed=True)
    return {"fg_logits": out[:, 0], "peak_logits": out[:, 1]}
