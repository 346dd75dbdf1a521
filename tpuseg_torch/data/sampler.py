"""Host-side patch sampler (numpy; copy of ``tpuseg/data/sampler.py``,
bit-identical batches and ``state_dict`` for a given seed and step — the
machine with the card has no JAX, and ``tpuseg.data`` imports it).

A deterministic, resumable iterator over random instance-centred crops of
one or more annotated volumes: every batch is a pure function of
(seed, step), so resuming only needs ``step``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from tpuseg_torch.data.synthetic import SyntheticVolume


class PatchSampler:
    """Random instance-centred 3D crops with padded weak annotations.

    Yields dict batches:
      image:      (B, D, H, W) in the SOURCE dtype (uint8/uint16 microscopy
                  stays integer: the upload is 2-4x smaller and the float32
                  cast happens on the device in ``train.step.prepare_batch``)
      centers:    (B, M, 3)    float32 — patch-relative instance centers
      half_sizes: (B, M, 3)    float32
      valid:      (B, M)       bool
    """

    def __init__(
        self,
        volumes: Sequence[SyntheticVolume],
        patch_size=(64, 64, 64),
        batch_size: int = 8,
        max_instances: int = 64,
        jitter: float = 8.0,
        seed: int = 0,
        step: int = 0,
    ):
        if not volumes:
            raise ValueError("need at least one volume")
        self.volumes = list(volumes)
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        self.max_instances = max_instances
        self.jitter = jitter
        self.seed = seed
        self.step = step

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.seed = int(d["seed"])
        self.step = int(d["step"])

    # -- sampling ------------------------------------------------------------
    def _sample_patch(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        vol = self.volumes[rng.integers(len(self.volumes))]
        D, H, W = vol.image.shape
        pd, ph, pw = self.patch_size
        if len(vol.centers):
            c = vol.centers[rng.integers(len(vol.centers))]
            c = c + rng.uniform(-self.jitter, self.jitter, 3)
        else:
            c = np.array([D / 2, H / 2, W / 2])
        origin = np.round(c - np.array([pd, ph, pw]) / 2).astype(int)
        origin = np.clip(origin, 0, np.array([D - pd, H - ph, W - pw]))
        oz, oy, ox = origin
        image = vol.image[oz : oz + pd, oy : oy + ph, ox : ox + pw]

        rel = vol.centers - origin
        inside = np.all((rel >= 0) & (rel < np.array(self.patch_size)), axis=1)
        rel = rel[inside]
        half = vol.half_sizes[inside]
        m = min(len(rel), self.max_instances)
        centers = np.zeros((self.max_instances, 3), np.float32)
        halfs = np.zeros((self.max_instances, 3), np.float32)
        valid = np.zeros((self.max_instances,), bool)
        centers[:m] = rel[:m]
        halfs[:m] = half[:m]
        valid[:m] = True
        return {"image": image, "centers": centers, "half_sizes": halfs, "valid": valid}

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(self.step,))
        )
        self.step += 1
        items = [self._sample_patch(rng) for _ in range(self.batch_size)]

        def stack(k):
            out = np.stack([it[k] for it in items])
            # image keeps the SOURCE dtype; annotations normalize to float32,
            # valid stays bool
            if k in ("image", "valid"):
                return out
            return out.astype(np.float32)

        return {k: stack(k) for k in items[0]}

    def __iter__(self):
        while True:
            yield self.next_batch()
