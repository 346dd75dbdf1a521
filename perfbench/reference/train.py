"""The plain weakly supervised train step: the batch prepared from raw
patches and their box annotations, the architecture's train-mode forward
and backward (its plain reference ``forward``, handed in as the module of
``arch/<name>.py``; the U-Net's is ``reference/unet.py``), the losses,
clipping and AdamW, in float32.

What the training configuration states, written out:

* per patch, the 1st and 99.8th percentiles of a 4096-bin histogram between
  its minimum and maximum (as ``reference/post.percentile_scalars``) map to
  0 and 1, clipped;
* z-scale augmentation: per example ``s = lo + (hi - lo) u`` with ``u`` the
  first uniform draw of the example's z-scale stream; the patch resampled
  along z about its centre at ``c + (z - c) / s`` (linear, clamped at the
  edges), the annotations' z centres and half-sizes scaled to match,
  planes sampled from outside the patch left out of the fg loss, and
  annotations whose centre left the patch dropped;
* weak targets: the peak target is the maximum over annotations of a
  gaussian at the centre with sigma ``peak_sigma x`` the box's aspect
  (half-size over the geometric mean of the three); fg is 1 inside any box
  shrunk by ``margin`` (at least 1); fg_weight is 0 between the shrunk and
  the grown boxes;
* augmentation, from the example's augment stream: six uniforms, then a
  standard normal per voxel: flips of the three axes (u < 0.5), an H/W
  swap on square patches, intensity ``x (1 + 0.2 (2u - 1)) + 0.1 (2u - 1)
  + 0.02 noise``, clipped to [0, 1];
* loss: per example a peak loss (MSE of sigmoid(logits) against the target,
  weighted by ``1 + 10 target``) and a fg loss (weighted binary
  cross-entropy plus ``dice_weight`` x soft Dice), averaged over the batch;
* update: the gradient clipped to global norm 1 (``g / norm`` where norm
  >= 1), AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every
  parameter) at a learning rate that warms up linearly from ``lr / warmup``.

The random streams are CUDA (or CPU) ``torch.Generator``s seeded per
(seed, step, example, stream) by :func:`example_seed`, the configuration's
stated stream keys, so the reference draws what the program draws without
reading anything the program made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.post import BINS

AUGMENT, ZSCALE = 0, 1
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def example_seed(seed: int, step: int, index: int, stream: int) -> int:
    state = np.random.SeedSequence([seed, step, index, stream]) \
        .generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _generator(seed, step, index, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(example_seed(seed, step, index, stream))
    return g


def normalize_patches(img: torch.Tensor, pcts) -> torch.Tensor:
    """(B, D, H, W) float32 -> per-patch percentile normalized."""
    out = []
    for v in img.float():
        lo = v.min()
        span = torch.clamp(v.max() - lo, min=1e-12)
        idx = torch.clamp(((v.reshape(-1) - lo) / span * BINS).long(), 0,
                          BINS - 1)
        counts = torch.bincount(idx, minlength=BINS).cpu().numpy()
        cdf = np.cumsum(counts.astype(np.float32) / np.float32(v.numel()),
                        dtype=np.float32)
        lo_h, span_h = np.float32(lo.item()), np.float32(span.item())
        q = [lo_h + (np.float32(np.searchsorted(cdf, np.float32(p / 100.0),
                                                side="left"))
                     + np.float32(0.5)) / np.float32(BINS) * span_h
             for p in pcts]
        width = float(max(q[1] - q[0], np.float32(1e-6)))
        out.append(torch.clamp((v - float(q[0])) / width, 0.0, 1.0))
    return torch.stack(out)


def zscale(s, image, centers, halfs, valid):
    d = image.shape[0]
    c = (d - 1) / 2.0
    z_in = c + (torch.arange(d, dtype=torch.float32, device=image.device)
                - c) / s
    z_weight = ((z_in >= 0.0) & (z_in <= d - 1.0)).float()
    z0 = torch.clamp(torch.floor(z_in).long(), 0, d - 1)
    z1 = torch.clamp(z0 + 1, 0, d - 1)
    w = torch.clamp(z_in - z0.float(), 0.0, 1.0)[:, None, None]
    image = image[z0] * (1.0 - w) + image[z1] * w
    cz = c + (centers[:, 0] - c) * s
    centers = torch.cat([cz[:, None], centers[:, 1:]], 1)
    halfs = torch.cat([(halfs[:, 0] * s)[:, None], halfs[:, 1:]], 1)
    valid = valid & (cz >= 0.0) & (cz <= d - 1.0)
    return image, centers, halfs, valid, z_weight


def weak_targets(centers, halfs, valid, shape, sigma: float, margin: float,
                 aniso: bool) -> dict:
    """(B, D, H, W) float32 ``peak``, ``fg``, ``fg_weight``; one
    annotation at a time."""
    dev = centers.device
    b = centers.shape[0]
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32,
                                          device=dev) for s in shape],
                           indexing="ij")
    peak = torch.zeros((b, *shape), device=dev)
    inner = torch.zeros((b, *shape), dtype=torch.bool, device=dev)
    outer = torch.zeros_like(inner)
    for i in range(b):
        for m in torch.nonzero(valid[i]).flatten().tolist():
            c, h = centers[i, m], halfs[i, m]
            if aniso:
                hs = torch.clamp(h, min=1e-3)
                sig = sigma * (hs / torch.exp(torch.log(hs).mean()))
                d2 = sum(((grids[a] - c[a]) / sig[a]) ** 2 for a in range(3))
                g = torch.exp(-0.5 * d2)
            else:
                d2 = sum((grids[a] - c[a]) ** 2 for a in range(3))
                g = torch.exp(-0.5 * d2 / sigma ** 2)
            peak[i] = torch.maximum(peak[i], g)
            r_in = torch.clamp(h - margin, min=1.0)
            r_out = h + margin
            inside_in = inside_out = True
            for a in range(3):
                dist = (grids[a] - c[a]).abs()
                inside_in = inside_in & (dist <= r_in[a])
                inside_out = inside_out & (dist <= r_out[a])
            inner[i] |= inside_in
            outer[i] |= inside_out
    return {"peak": peak, "fg": inner.float(),
            "fg_weight": (inner | ~outer).float()}


def augment(g, image, targets: dict):
    u = torch.rand(6, generator=g, device=g.device)
    noise = torch.randn(tuple(image.shape), generator=g, device=g.device)
    square = image.shape[1] == image.shape[2]

    def spatial(x):
        for a in range(3):
            if bool(u[a] < 0.5):
                x = x.flip(a)
        if square and bool(u[3] < 0.5):
            x = x.transpose(1, 2)
        return x

    image = spatial(image)
    targets = {k: spatial(v) for k, v in targets.items()}
    scale = 1.0 + 0.2 * (2.0 * u[4] - 1.0)
    shift = 0.1 * (2.0 * u[5] - 1.0)
    image = torch.clamp(image * scale + shift + 0.02 * noise, 0.0, 1.0)
    return image, targets


def prepare_batch(raw: dict, data: dict, seed: int, step: int,
                  device) -> tuple:
    """Raw numpy patches (``image``, ``centers``, ``half_sizes``,
    ``valid``) -> ((B, D, H, W) images, targets) on ``device``."""
    img = normalize_patches(torch.as_tensor(raw["image"]).to(device).float(),
                            data["normalize_pcts"])
    centers = torch.as_tensor(raw["centers"]).to(device).float()
    halfs = torch.as_tensor(raw["half_sizes"]).to(device).float()
    valid = torch.as_tensor(raw["valid"]).to(device).bool()
    b = img.shape[0]
    z_weight = None
    if data.get("aug_zscale") is not None:
        lo, hi = data["aug_zscale"]
        outs = []
        for i in range(b):
            u = torch.rand((), generator=_generator(seed, step, i, ZSCALE,
                                                    device), device=device)
            outs.append(zscale(lo + (hi - lo) * u, img[i], centers[i],
                               halfs[i], valid[i]))
        img, centers, halfs, valid, z_weight = (torch.stack(t)
                                                for t in zip(*outs))
    tgt = weak_targets(centers, halfs, valid, tuple(img.shape[1:]),
                       data["peak_sigma"], data["box_ignore_margin"],
                       data["peak_sigma_aniso"])
    if z_weight is not None:
        tgt["fg_weight"] = tgt["fg_weight"] * z_weight[:, :, None, None]
    imgs, tgts = [], []
    for i in range(b):
        im, tg = augment(_generator(seed, step, i, AUGMENT, device), img[i],
                         {k: v[i] for k, v in tgt.items()})
        imgs.append(im)
        tgts.append(tg)
    return torch.stack(imgs), {k: torch.stack([t[k] for t in tgts])
                               for k in tgt}


def losses(out: dict, tgt: dict, dice_weight: float) -> dict:
    dims = (1, 2, 3)
    pred = torch.sigmoid(out["peak_logits"])
    w = 1.0 + 10.0 * tgt["peak"]
    lp = ((w * (pred - tgt["peak"]) ** 2).sum(dims) / w.sum(dims)).mean()
    x, t, w = out["fg_logits"], tgt["fg"], tgt["fg_weight"]
    bce = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    bce = (w * bce).sum(dims) / torch.clamp(w.sum(dims), min=1.0)
    prob = torch.sigmoid(x)
    dice = 1.0 - (2.0 * (w * prob * t).sum(dims) + 1.0) / (
        (w * prob).sum(dims) + (w * t).sum(dims) + 1.0)
    lf = (bce + dice_weight * dice).mean()
    return {"loss": lp + lf, "peak_loss": lp, "fg_loss": lf}


def learning_rate(train: dict, count: int) -> float:
    """The warmup-cosine schedule's value for update ``count`` (0-based),
    float32 arithmetic."""
    f32 = np.float32
    warmup, peak = train["warmup_steps"], train["lr"]
    init = peak / max(warmup, 1)
    if count < warmup:
        frac = f32(1) - f32(count) / f32(warmup)
        return float(f32(init - peak) * frac + f32(peak))
    decay = max(train["total_steps"], warmup + 1) - warmup
    c = f32(min(count - warmup, decay))
    return float(f32(peak) * f32(0.5) * (f32(1) + np.cos(
        f32(math.pi) * c / f32(decay))))


class Trainer:
    """The reference's train state: float32 parameters, statistics (the
    entries ``arch.is_statistic`` names, updated by the forward) and AdamW
    moments, from a state dict (copied). ``arch`` is the architecture's
    module: its ``forward`` and ``is_statistic``."""

    def __init__(self, arch, state: dict, cfg: dict, device, quant=None):
        self.arch, self.cfg, self.device, self.quant = arch, cfg, device, quant
        self.params = {k: v.detach().to(device).float().clone()
                       .requires_grad_(True)
                       for k, v in state.items() if not arch.is_statistic(k)}
        self.stats = {k: v.detach().to(device).float().clone()
                      for k, v in state.items() if arch.is_statistic(k)}
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    def step(self, raw: dict, seed: int) -> dict:
        """One update from a raw batch; returns the losses (floats) and
        the clipped gradient the optimizer took, by parameter."""
        c = self.cfg
        imgs, tgt = prepare_batch(raw, c["data"], seed, self.count,
                                  self.device)
        p = {**self.params, **self.stats}
        out = self.arch.forward(p, imgs, c["model"], train=True,
                                stats=self.stats, quant=self.quant)
        loss = losses(out, tgt, c["train"]["dice_weight"])
        names = list(self.params)
        grads = torch.autograd.grad(loss["loss"],
                                    [self.params[k] for k in names])
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = 1.0 if float(norm) < 1.0 else 1.0 / norm
            lr = learning_rate(c["train"], self.count)
            t = self.count + 1
            bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(t))
            bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(t))
            taken = {}
            for k, g in zip(names, grads):
                g = g * scale
                taken[k] = g
                self.mu[k].mul_(B1).add_((1 - B1) * g)
                self.nu[k].mul_(B2).add_((1 - B2) * g * g)
                u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                          + ADAM_EPS)
                u = u + c["train"]["weight_decay"] * self.params[k]
                self.params[k].add_(-lr * u)
        self.count += 1
        return {**{k: float(v.detach()) for k, v in loss.items()},
                "grads": taken}
