#!/usr/bin/env python
"""Write a committed artifact's weights as the PyTorch port's ``.npz``.

    python scripts/torch_port_export_weights.py [--artifact vreg1b_gt03_ema]
        [--out artifacts_torch/<artifact>.npz]

Reads ``artifacts/<artifact>`` with the JAX package's orbax loader
(``training.checkpoint.load_inference_params``), converts it with
``cv_diffusion_tpu_torch.weights.state_dict_from_jax``, and writes it with
``weights.save_state_dict_npz``: one ``np.savez_compressed`` file that
numpy alone reads back (``weights.load_state_dict_npz``, no pickle):

- ``plane0`` … ``plane3``: byte k of every little-endian float32 weight,
  the weights concatenated in the state dict's order;
- ``index``: JSON (UTF-8 bytes as uint8) ``[[name, shape, offset], …]``,
  offsets in floats;
- ``sha256``: the hex SHA-256 of the raw float32 bytes (ASCII as uint8);
- ``source``: the artifact's name (ASCII as uint8).

Needs the JAX stack and orbax; the port itself never imports them.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def export(artifact: str, out: str) -> dict:
    from cv_diffusion_tpu.training.checkpoint import load_inference_params
    from cv_diffusion_tpu_torch.config import load_model_config
    from cv_diffusion_tpu_torch.weights import (save_state_dict_npz,
                                                state_dict_from_jax)

    path = os.path.join(REPO, "artifacts", artifact)
    cfg = load_model_config(os.path.join(path, "model_config.json"))
    sd = state_dict_from_jax(load_inference_params(path, verbose=False), cfg)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    digest = save_state_dict_npz(sd, out, artifact)
    return {"artifact": artifact, "out": out, "tensors": len(sd),
            "floats": sum(t.numel() for t in sd.values()),
            "bytes": os.path.getsize(out), "sha256": digest}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="vreg1b_gt03_ema")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    out = args.out or os.path.join(REPO, "artifacts_torch", f"{args.artifact}.npz")
    print(json.dumps(export(args.artifact, out)))


if __name__ == "__main__":
    main()
