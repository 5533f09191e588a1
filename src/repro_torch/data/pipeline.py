"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``).

* **Counter-based determinism** — batch ``k`` is a pure function of
  (seed, k): numpy Philox keyed on (seed, step), the reference's own
  code, so the batches are bit-identical to the reference's.
* **Document packing** — synthetic "documents" with a length distribution
  are packed into fixed-length rows with EOS separators and a loss mask
  that blanks cross-document positions.

Batches are numpy arrays; the score pass and the model move them to the
parameters' device. ``place`` and ``prefetch`` (the reference's sharded
placement and host pipeline) wait with the sharded tier.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic LM batches for a ModelConfig."""
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    pack_documents: bool = True
    mean_doc_len: int = 512

    def batch_at(self, step: int) -> dict:
        """Batch ``step`` — pure function of (seed, step)."""
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=[0, 0, 0, step]))
        V = self.cfg.vocab
        T = self.seq
        if self.pack_documents:
            toks = np.empty((self.batch, T + 1), np.int32)
            mask = np.ones((self.batch, T), np.float32)
            for b in range(self.batch):
                pos = 0
                row = np.empty(T + 1, np.int32)
                while pos < T + 1:
                    dl = max(2, int(rng.geometric(1.0 / self.mean_doc_len)))
                    dl = min(dl, T + 1 - pos)      # tail doc may be short
                    row[pos:pos + dl] = rng.integers(3, V, dl)
                    row[pos] = 2                      # BOS/EOS separator
                    if pos > 0:
                        mask[b, pos - 1] = 0.0        # no loss across docs
                    pos += dl
                toks[b] = row
        else:
            toks = rng.integers(3, V, (self.batch, T + 1)).astype(np.int32)
            mask = np.ones((self.batch, T), np.float32)

        out = {"inputs": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
        if self.cfg.family in ("encdec", "audio"):
            Tt = min(T, self.cfg.max_target_positions - 1)
            out = {"frames": rng.standard_normal(
                       (self.batch, self.cfg.enc_seq, self.cfg.enc_d_model)
                   ).astype(np.float32),
                   "inputs": toks[:, :Tt], "labels": toks[:, 1:Tt + 1],
                   "mask": mask[:, :Tt]}
        elif self.cfg.family == "vlm":
            out["prefix_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_patches, self.cfg.d_model)
            ).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
