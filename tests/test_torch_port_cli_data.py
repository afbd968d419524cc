"""The dataset CLI and the migration entry of the port against the JAX
package.

``python -m cv_diffusion_tpu_torch.make_synthetic_dataset`` against
``scripts/make_synthetic_dataset.py``'s ``write_split`` (loaded from its
path, Pillow writing): the val split equal in decoded pixels, the train
split equal with scikit-learn's import blocked (the JAX script then writes
procedural scenes only, as the port always does), and, where scikit-learn
imports here, different from the JAX script's photo-mixed split: the
divergence kept on purpose. The PNG bytes differ (another encoder).

``python -m cv_diffusion_tpu_torch.migrate`` on a reference checkpoint made
from a JAX tiny UNet's random parameters (``export_unet_state_dict``, and
the add mode's condition encoder in the layout that JAX's
``convert_condition_encoder_state_dict`` reads), written with
``torch.save``: the package's weights must equal ``state_dict_from_jax`` of
the same parameters bit for bit.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from cv_diffusion_tpu.utils.torch_compat import (convert_condition_encoder_state_dict,
                                                 export_unet_state_dict)
from cv_diffusion_tpu_torch import make_synthetic_dataset, migrate
from cv_diffusion_tpu_torch.config import variant_of
from cv_diffusion_tpu_torch.export.serving import ServingPipeline
from cv_diffusion_tpu_torch.weights import load_state_dict_npz, state_dict_from_jax

from test_torch_port_weights import one_torch_thread, random_jax_params  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_dataset_script():
    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_dataset",
        os.path.join(REPO, "scripts", "make_synthetic_dataset.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def decoded(root):
    """{relative path: pixels} of a split's PNGs, decoded by Pillow."""
    out = {}
    for sub in ("low", "high"):
        for f in sorted(os.listdir(os.path.join(root, sub))):
            with Image.open(os.path.join(root, sub, f)) as im:
                out[f"{sub}/{f}"] = np.array(im.convert("RGB"))
    return out


def assert_same_split(a, b):
    da, db = decoded(a), decoded(b)
    assert list(da) == list(db)
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_dataset_cli_equals_jax(jax_dataset_script, tmp_path, monkeypatch):
    out = make_synthetic_dataset.main(["--out", str(tmp_path / "port"), "--train", "5",
                                       "--val", "4", "--size", "48", "--seed", "3"])
    assert out == tmp_path / "port"
    jax_root = tmp_path / "jax"
    jax_dataset_script.write_split(jax_root / "val", 4, 48, 3 + 77, photo_fraction=0.0)
    assert_same_split(tmp_path / "port" / "val", jax_root / "val")
    assert (tmp_path / "port" / "val" / "low" / "00000.png").read_bytes() != (
        jax_root / "val" / "low" / "00000.png").read_bytes()    # another encoder
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "sklearn", None)
        m.setitem(sys.modules, "sklearn.datasets", None)
        jax_dataset_script.write_split(jax_root / "train", 5, 48, 3)
    assert_same_split(tmp_path / "port" / "train", jax_root / "train")


def test_dataset_cli_writes_no_photo_crops(jax_dataset_script, tmp_path):
    """Where scikit-learn imports, the JAX script's train split holds crops
    of its photographs; the port's never does (its ``--help`` says so)."""
    pytest.importorskip("sklearn.datasets")
    make_synthetic_dataset.main(["--out", str(tmp_path / "port"), "--train", "4",
                                 "--val", "1", "--size", "48", "--seed", "0"])
    jax_dataset_script.write_split(tmp_path / "jax", 4, 48, 0)
    port, jax_ = decoded(tmp_path / "port" / "train"), decoded(tmp_path / "jax")
    assert any(not np.array_equal(port[k], jax_[k]) for k in port)
    assert "no photo crops" in make_synthetic_dataset.build_parser().format_help()


@pytest.mark.parametrize("mode", ["concat", "add"])
def test_migrate_equals_state_dict_from_jax(mode, tmp_path, capsys):
    jcfg, tcfg, params = random_jax_params("tiny", 256, seed=5, condition_mode=mode)
    ref = export_unet_state_dict(params["unet"], jcfg.unet)
    sd = {f"unet.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items()}
    if mode == "add":
        enc = params["condition_encoder"]
        for i, name in ((0, "conv1"), (2, "conv2")):
            sd[f"condition_encoder.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(enc[name]["kernel"], (3, 2, 0, 1))))
            sd[f"condition_encoder.{i}.bias"] = torch.from_numpy(np.asarray(enc[name]["bias"]))
        back = convert_condition_encoder_state_dict(sd)   # JAX reads them back
        for name in ("conv1", "conv2"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(back[name][leaf], enc[name][leaf])
    ckpt = tmp_path / "ref.pt"
    torch.save({"model_state_dict": sd, "epoch": 7, "best_val_loss": 0.5}, ckpt)
    files = migrate.main([str(ckpt), str(tmp_path / "pkg"), "--device", "cpu"])
    assert f"variant=tiny, in_channels={6 if mode == 'concat' else 3}" in capsys.readouterr().out
    got = load_state_dict_npz(files["params"], "cpu")
    want = state_dict_from_jax(params, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    with open(files["config"]) as f:
        model = json.load(f)["model"]
    assert model["condition_mode"] == mode and variant_of(model["unet"]) == "tiny"
    pipe = ServingPipeline.from_package(str(tmp_path / "pkg"), device="cpu")
    out = pipe(np.full((20, 30, 3), 40, np.uint8), seed=0)
    assert out.shape == (20, 30, 3) and out.dtype == np.uint8


def test_migrate_refuses_what_is_not_a_reference_unet(tmp_path):
    jcfg, _, params = random_jax_params("tiny", 256, seed=1, condition_mode="add")
    sd = {f"unet.{k}": torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_unet_state_dict(params["unet"], jcfg.unet).items()}
    torch.save(sd, tmp_path / "no_encoder.pt")   # add mode, encoder missing
    with pytest.raises(ValueError, match="condition_encoder"):
        migrate.main([str(tmp_path / "no_encoder.pt"), str(tmp_path / "p"), "--device", "cpu"])
    del sd["unet.final_conv.bias"]
    sd.update({f"condition_encoder.{i}.{p}": torch.zeros(1) for i in (0, 2)
               for p in ("weight", "bias")})
    torch.save({"model_state_dict": sd}, tmp_path / "broken.pt")
    with pytest.raises(RuntimeError, match="final_conv.bias"):
        migrate.main([str(tmp_path / "broken.pt"), str(tmp_path / "p"), "--device", "cpu"])
