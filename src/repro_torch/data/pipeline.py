"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``).

* **Counter-based determinism** — batch ``k`` is a pure function of
  (seed, k): numpy Philox keyed on (seed, step), the reference's own
  code, so the batches are bit-identical to the reference's.
* **Document packing** — synthetic "documents" with a length distribution
  are packed into fixed-length rows with EOS separators and a loss mask
  that blanks cross-document positions.

Batches are numpy arrays; the score pass and the model move them to the
parameters' device. ``place`` lays one over a mesh's data-parallel axes
(the reference's ``batch_spec``/``input_shardings``:
``launch/shardings.py:105-121``), and ``prefetch`` keeps batches in
flight ahead of the step.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticLM", "place", "prefetch", "split_leading"]


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


def split_leading(x, count: int) -> list:
    """``count`` pieces of ``x`` along its leading axis, as the reference's
    input shardings lay a batch over the DP axes: a 0-d leaf and a batch
    of 1 are replicated; otherwise the axis splits evenly, and an axis
    that does not divide raises, as ``jax.device_put`` does."""
    if x.ndim == 0 or x.shape[0] == 1:
        return [x] * count
    if x.shape[0] % count:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split "
                         f"over {count} data-parallel positions")
    size = x.shape[0] // count
    return [x[i * size:(i + 1) * size] for i in range(count)]


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.ndim == 0 else np.ascontiguousarray(a))


def place(batch: dict, mesh: Mesh) -> list:
    """A host batch laid over ``mesh``: one batch a position, in position
    order, on that position's device. Each leaf's leading axis is split
    over ``dp_axes(mesh)`` (``split_leading``); positions that share a DP
    index and a device share the tensors."""
    dp = dp_axes(mesh)
    count = 1
    for a in dp:
        count *= mesh.shape[a]
    pieces = {k: split_leading(_tensor(x), count) for k, x in batch.items()}
    made, out = {}, []
    for coords in mesh.coords():
        i = 0
        for a in dp:
            i = i * mesh.shape[a] + coords[a]
        dev = mesh.device(**coords)
        if (i, dev) not in made:
            made[(i, dev)] = {k: p[i].to(dev) for k, p in pieces.items()}
        out.append(made[(i, dev)])
    return out


def prefetch(it: Iterator, mesh: Mesh = None, depth: int = 1) -> Iterator:
    """Software pipeline: keep ``depth`` batches in flight, each ``place``d
    over ``mesh`` when one is given."""
    buf = collections.deque()
    for item in it:
        if mesh is not None:
            item = place(item, mesh)
        buf.append(item)
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
