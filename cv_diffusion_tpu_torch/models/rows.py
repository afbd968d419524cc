"""Random draws for a global batch of which this process computes some rows.

Under data parallelism each process computes a block of rows of one global
batch; under spatial parallelism also a strip of image rows of each image.
The JAX package draws t, ε, the dropout masks and the sampler's noise for
the global batch, so a step over a mesh equals the step on one device. The
port does the same: inside :func:`global_batch` every draw of the model,
the losses and the sampler (:func:`draw`) is made at the global batch's
shape (its batch dim, and the image-row dim of a draw of image shape) from
the caller's generator and narrowed to this process's block. Every
process's generator then makes the same draws and stays in step with a
one-process run's. Timesteps [B] are split over the batch only.

The block is a module global, not a context variable: a rematerialised
block's dropout is drawn again in the backward, on the autograd engine's
device thread, and must see the block the forward saw.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch

Block = Tuple[int, int, int]   # (global size, first here, one past the last)

# the batch's block, and (strips, this process's strip) of the image rows
# (None: whole images here)
_BLOCK: Optional[Block] = None
_STRIPS: Optional[Tuple[int, int]] = None


def _checked(block: Block, what: str) -> Block:
    total, start, stop = block
    if not 0 <= start < stop <= total:
        raise ValueError(f"{what} [{start}, {stop}) of {total}")
    return block


@contextlib.contextmanager
def global_batch(total: int, start: int, stop: int,
                 strips: Optional[Tuple[int, int]] = None) -> Iterator[None]:
    """Draws inside are made for a batch of ``total`` rows, of which this
    process computes rows ``[start, stop)``; with ``strips`` (n, i), of
    images whose rows it computes strip i of n equal strips (at every
    resolution: a draw of L rows is rows [i·L, (i+1)·L) of n·L)."""
    global _BLOCK, _STRIPS
    block = _checked((total, start, stop), "rows")
    if strips is not None and not 0 <= strips[1] < strips[0]:
        raise ValueError(f"strip {strips[1]} of {strips[0]}")
    previous, _BLOCK, _STRIPS = (_BLOCK, _STRIPS), block, strips
    try:
        yield
    finally:
        _BLOCK, _STRIPS = previous


def active() -> bool:
    """Whether a :func:`global_batch` block is open."""
    return _BLOCK is not None


def draw(fill: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int],
         dim: int = 0, hdim: Optional[int] = None):
    """``fill(shape)``, or inside :func:`global_batch` ``fill`` at the
    global batch's size along ``dim`` (and, for a draw of image shape whose
    image-row dim is ``hdim``, at the whole image's rows along it) narrowed
    to this process's block. ``shape[dim]`` must then be the rows here.
    ``fill`` may return a tuple of tensors, each narrowed."""
    shape = list(int(s) for s in shape)
    if _BLOCK is None:
        return fill(tuple(shape))
    total, start, stop = _BLOCK
    if shape[dim] != stop - start:
        raise ValueError(
            f"a draw of shape {tuple(shape)} inside a global batch of {total} rows "
            f"with {stop - start} of them here: dim {dim} is not this process's rows")
    cuts = [(dim, total, start, stop)]
    if hdim is not None and _STRIPS is not None:
        n, i = _STRIPS
        cuts.append((hdim, n * shape[hdim], i * shape[hdim], (i + 1) * shape[hdim]))
    cuts = [c for c in cuts if c[1] != c[3] - c[2]]
    if not cuts:
        return fill(tuple(shape))
    for d, total, _, _ in cuts:
        shape[d] = total
    out = fill(tuple(shape))

    def narrowed(t: torch.Tensor) -> torch.Tensor:
        for d, _, start, stop in cuts:
            t = t.narrow(d, start, stop - start)
        return t.contiguous()

    return tuple(narrowed(t) for t in out) if isinstance(out, tuple) else narrowed(out)
