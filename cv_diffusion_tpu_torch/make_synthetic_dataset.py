"""Dataset CLI of the port: ``python -m cv_diffusion_tpu_torch.make_synthetic_dataset``.

Counterpart of ``scripts/make_synthetic_dataset.py``, its flags and
defaults: a LOL-style ``out/{train,val}/{low,high}/`` tree of procedural
scenes (Fourier backgrounds, value-noise texture, shapes) degraded by the
synthetic low-light model, reproducible per image from ``--seed`` (val at
seed + 77). Written with numpy alone (``data/synthetic.py::write_split``,
``data/png.py``). The JAX script mixes crops of scikit-learn's two bundled
photographs into a quarter of the train split when scikit-learn imports;
the card's machine has none, so the port writes procedural scenes only: its
train split is the JAX script's with scikit-learn absent, pixel for pixel.

    python -m cv_diffusion_tpu_torch.make_synthetic_dataset --out D \\
        --train 400 --val 15 --size 192
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from .data.synthetic import write_split
from .evaluate import SPLIT_SEED_OFFSET


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[1].replace("\n", " "),
        allow_abbrev=False)
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=400,
                   help="train pairs (procedural scenes only: no photo crops, "
                        "which need scikit-learn)")
    p.add_argument("--val", type=int, default=15,
                   help="LOL eval15-sized held-out split (seed + 77)")
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    write_split(out / "train", args.train, args.size, args.seed)
    write_split(out / "val", args.val, args.size, args.seed + SPLIT_SEED_OFFSET)
    print(f"Wrote {args.train} train + {args.val} val pairs "
          f"({args.size}x{args.size}) under {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
