"""Random draws for a global batch of which this process computes some rows.

Under data parallelism each process computes a block of rows of one global
batch. The JAX package draws t, ε, the dropout masks and the sampler's
noise for the global batch, so a step over a mesh equals the step on one
device. The port does the same: inside :func:`global_batch` every draw of
the model, the losses and the sampler (:func:`draw`) is made at the global
batch's shape from the caller's generator and narrowed to this process's
rows. Every process's generator then makes the same draws and stays in
step with a one-process run's.

The block is a module global, not a context variable: a rematerialised
block's dropout is drawn again in the backward, on the autograd engine's
device thread, and must see the block the forward saw.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch

# (rows of the global batch, first row here, one past the last row here)
_BLOCK: Optional[Tuple[int, int, int]] = None


@contextlib.contextmanager
def global_batch(total: int, start: int, stop: int) -> Iterator[None]:
    """Draws inside are made for a batch of ``total`` rows, of which this
    process computes rows ``[start, stop)``."""
    global _BLOCK
    if not 0 <= start < stop <= total:
        raise ValueError(f"rows [{start}, {stop}) of a batch of {total}")
    previous, _BLOCK = _BLOCK, (total, start, stop)
    try:
        yield
    finally:
        _BLOCK = previous


def active() -> bool:
    """Whether a :func:`global_batch` block is open."""
    return _BLOCK is not None


def draw(fill: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int],
         dim: int = 0):
    """``fill(shape)``, or inside :func:`global_batch` ``fill`` at the
    global batch's size along ``dim`` narrowed to this process's rows.
    ``shape[dim]`` must then be the number of rows here. ``fill`` may
    return a tuple of tensors, each narrowed."""
    shape = tuple(int(s) for s in shape)
    if _BLOCK is None:
        return fill(shape)
    total, start, stop = _BLOCK
    if shape[dim] != stop - start:
        raise ValueError(
            f"a draw of shape {shape} inside a global batch of {total} rows "
            f"with {stop - start} of them here: dim {dim} is not this "
            "process's rows")
    if total == stop - start:
        return fill(shape)
    out = fill(shape[:dim] + (total,) + shape[dim + 1:])

    def rows(t: torch.Tensor) -> torch.Tensor:
        return t.narrow(dim, start, stop - start).contiguous()

    return tuple(rows(t) for t in out) if isinstance(out, tuple) else rows(out)
