"""RANSAC minimal samples drawn from an explicit ``torch.Generator``.

The JAX package draws them with ``jax.random.categorical`` over masked
logits, which torch cannot reproduce. The port splits each estimator into
drawing the samples (here) and solving and scoring a given index tensor,
so tests can feed the indices JAX drew. The draw here has the same law:
each index uniform over the valid entries, independently, with
replacement; with no valid entry every index is 0, as the all--inf
categorical gives.
"""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key`` (for
    example (seed, stream, frame, attempt)), so every use in a run draws
    its own reproducible stream."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


def draw_samples(valid: torch.Tensor, n: int, m: int, generator: torch.Generator) -> torch.Tensor:
    """(..., N) validity -> (..., n, m) int64 indices of valid entries."""
    lead = valid.shape[:-1]
    u = torch.rand(lead + (n * m,), generator=generator, device=valid.device)
    cnt = valid.sum(-1, keepdim=True)                                # (..., 1)
    k = torch.minimum(torch.floor(u * cnt).to(torch.int64), torch.clamp(cnt - 1, min=0))
    csum = torch.cumsum(valid.to(torch.int64), dim=-1)
    idx = torch.searchsorted(csum.contiguous(), (k + 1).contiguous())
    idx = torch.where(cnt > 0, idx, torch.zeros_like(idx))
    return idx.reshape(lead + (n, m))
