"""The serving CLIs of the port on the CPU: inference, directory
evaluation and the benchmark.

A tiny UNet at 32² with random weights (``weights.init_weights``) is
written as a ``save_params`` directory (with a recorded v-prediction config
and the student grid [739]) and as a serving package. The inference CLI's
PNGs must equal ``ServingPipeline``'s uint8 outputs for the same inputs and
seed exactly (one process, one CPU: the same operations on the same
values). Directory evaluation must give ``evaluate_artifact``'s per-image
metrics on the same split and noise: exactly at the same batching, and
within ``RAGGED_TOL`` at batch 5 (a ragged last batch; another batch size
may take other CPU convolution algorithms). JAX parity of the pipeline
and of the metrics is held by the other port tests.
"""

import ast
import json
import os
import struct

import numpy as np
import pytest
import torch

from cv_diffusion_tpu_torch import benchmark, evaluate, inference
from cv_diffusion_tpu_torch.config import diffusion_config, to_json
from cv_diffusion_tpu_torch.data import png
from cv_diffusion_tpu_torch.data.synthetic import write_split
from cv_diffusion_tpu_torch.export.serving import (ServingConfig, ServingPipeline,
                                                   create_serving_package)
from cv_diffusion_tpu_torch.models.diffusion import create_model
from cv_diffusion_tpu_torch.training.checkpoint import save_params
from cv_diffusion_tpu_torch.weights import init_weights

from test_torch_port_weights import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
GRID = (739,)
# per-image metrics at another batching: |Δ| in dB for PSNR, in units for
# the others. Batches of another size take other CPU convolution
# algorithms, whose float32 sums run in another order: at batch 5 the
# outputs moved by ~1e-6 and MAE by up to 1.3e-6 (of 0.26); these bounds
# are ~10x that, and ~100x below what one LSB of an output changes
RAGGED_TOL = {"psnr": 1e-4, "ssim": 1e-5, "mae": 1e-5, "gmsd": 1e-5}


def write_bmp(path, img):
    """A 24-bit bottom-up BMP of uint8 RGB ``img``."""
    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    body = rows.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 0, 0, 0, 0)
    path.write_bytes(header + info + body)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """(save_params directory, fp32 package, weights, config) of a tiny
    v-prediction student with the grid [739]."""
    root = tmp_path_factory.mktemp("cli_model")
    cfg = diffusion_config("tiny", SIZE, prediction_type="v_prediction")
    weights = init_weights(cfg, seed=0, device="cpu")
    save_params(str(root / "ckpt"), weights, to_json(cfg),
                {"student_timesteps.json": json.dumps({"timesteps": list(GRID)})})
    model, schedule = create_model(cfg, device="cpu")
    model.load_state_dict(weights, strict=True)
    create_serving_package(str(root / "pkg"), model, schedule, timesteps=GRID)
    return root / "ckpt", root / "pkg", weights, cfg


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A directory of PNG and BMP images of two sizes."""
    root = tmp_path_factory.mktemp("cli_images")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(24, 40), (40, 24), (24, 40), (32, 32), (40, 24)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            write_bmp(root / f"img{i}.bmp", img)
        else:
            png.write_png(root / f"img{i}.png", img)
    return root


def reference_pipeline(model_dirs, fmt, dtype, batch_size):
    ckpt, pkg, weights, cfg = model_dirs
    if fmt == "package":
        return ServingPipeline.from_package(str(pkg), device="cpu", batch_size=batch_size)
    model, schedule = create_model(diffusion_config(
        "tiny", SIZE, prediction_type="v_prediction", dtype=dtype), device="cpu")
    model.load_state_dict(weights, strict=True)
    return ServingPipeline(model, schedule, ServingConfig(
        image_size=SIZE, timesteps=GRID, batch_size=batch_size), device="cpu")


@pytest.mark.parametrize("fmt,dtype,batch_size", [
    ("checkpoint", "bfloat16", 1), ("checkpoint", "float32", 4), ("package", None, 1),
    ("package", None, 4)])
def test_inference_cli_equals_the_pipeline(model_dirs, images, tmp_path, fmt, dtype,
                                           batch_size):
    ckpt, pkg, _, _ = model_dirs
    argv = ["--input", str(images), "--output", str(tmp_path / "out"), "--format", fmt,
            "--model", str(pkg if fmt == "package" else ckpt), "--image_size", str(SIZE),
            "--batch_size", str(batch_size), "--device", "cpu", "--no_pallas"]
    if dtype:
        argv += ["--dtype", dtype]      # bfloat16 is the default: both spelled out
    result = inference.main(argv)
    files = sorted(images.iterdir())
    assert [os.path.basename(p) for p in result["outputs"]] == [
        f.stem + ".png" for f in files]
    imgs = png.read_images(files)
    pipe = reference_pipeline(model_dirs, fmt, dtype, batch_size)
    want = pipe.batch(imgs) if batch_size > 1 else [pipe(img) for img in imgs]
    for path, img, ref in zip(result["outputs"], imgs, want):
        got = png.read_image(path)
        assert got.shape == img.shape
        np.testing.assert_array_equal(got, ref, err_msg=path)


def test_inference_cli_one_file_and_jpeg_refused(model_dirs, images, tmp_path, capsys):
    ckpt = str(model_dirs[0])
    src = images / "img0.png"
    out = inference.main(["--input", str(src), "--output", str(tmp_path / "one"),
                          "--model", ckpt, "--device", "cpu", "--image_size", str(SIZE)])
    assert out["outputs"] == [str(tmp_path / "one" / "img0.png")]
    assert "Using recorded student timestep grid: [739]" in capsys.readouterr().out
    pipe = reference_pipeline(model_dirs, "checkpoint", "bfloat16", 1)
    np.testing.assert_array_equal(png.read_image(out["outputs"][0]),
                                  pipe(png.read_image(src)))
    # a JPEG is refused by name, as a file and inside a directory
    jpg = tmp_path / "photos" / "Holiday.JPG"
    jpg.parent.mkdir()
    jpg.write_bytes(b"\xff\xd8\xff\xe0 not decoded")
    png.write_png(tmp_path / "photos" / "a.png", np.zeros((8, 8, 3), np.uint8))
    for src in (jpg, jpg.parent):
        with pytest.raises(ValueError, match="Holiday.JPG"):
            inference.main(["--input", str(src), "--model", ckpt, "--device", "cpu"])
    with pytest.raises(ValueError, match="PNG only"):
        inference.main(["--input", str(images / "img0.png"), "--output",
                        str(tmp_path / "x.bmp"), "--model", ckpt, "--device", "cpu"])


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    """Seven pairs of the synthetic validation split at 32², written."""
    root = tmp_path_factory.mktemp("cli_val")
    write_split(root, 7, SIZE, 0 + evaluate.SPLIT_SEED_OFFSET)
    return root


def artifact_path_metrics(model_dirs, seed):
    """``evaluate_artifact``'s code path (the in-memory split, its noise,
    ``enhance_split`` in batches of 8) on the checkpoint's model."""
    _, _, weights, _ = model_dirs
    model, schedule = create_model(diffusion_config(
        "tiny", SIZE, prediction_type="v_prediction"), device="cpu")
    model.load_state_dict(weights, strict=True)
    low, high = evaluate.eval_split(7, SIZE, 0)
    init, step = evaluate.eval_noise(7, SIZE, seed, len(GRID))
    pred = evaluate.enhance_split(model, schedule, low, init, step, GRID, "cpu")
    return evaluate.per_image_metrics(pred, evaluate.target_unit(high, "cpu")), pred


def test_directory_evaluate_equals_the_artifact_path(model_dirs, val_split, tmp_path):
    ckpt = str(model_dirs[0])
    runs = {}
    for batch in (8, 5):
        argv = ["--data_dir", str(val_split), "--model", ckpt, "--image_size", str(SIZE),
                "--batch_size", str(batch), "--dtype", "float32", "--seeds", "2",
                "--device", "cpu", "--json", str(tmp_path / f"b{batch}.json")]
        if batch == 8:
            argv += ["--save_outputs", str(tmp_path / "saved")]
        runs[batch] = evaluate.main(argv)
        assert json.loads((tmp_path / f"b{batch}.json").read_text()) == runs[batch]
    for seed in (0, 1):
        want, pred = artifact_path_metrics(model_dirs, seed)
        exact = runs[8]["seeds"][str(seed)]
        ragged = runs[5]["seeds"][str(seed)]
        assert exact["files"] == ragged["files"] == [f"{i:05d}.png" for i in range(7)]
        for k, tol in RAGGED_TOL.items():
            assert exact[k] == want[k], k
            np.testing.assert_allclose(ragged[k], want[k], rtol=0, atol=tol, err_msg=k)
        assert exact["ms_ssim"] == [None] * 7       # below 176²
        if seed == 0:
            saved = [png.read_image(tmp_path / "saved" / f) for f in exact["files"]]
            np.testing.assert_array_equal(np.stack(saved), evaluate.to_u8(pred))
    assert runs[8]["timesteps"] == list(GRID) and runs[8]["variant"] == "tiny"
    assert runs[8]["seeds"]["0"]["psnr"] != runs[8]["seeds"]["1"]["psnr"]
    s = runs[8]["summary"]
    means = [np.mean(runs[8]["seeds"][k]["psnr"]) for k in ("0", "1")]
    assert s["psnr_mean"] == pytest.approx(np.mean(means), abs=1e-12)
    assert s["psnr_std_across_seeds"] == pytest.approx(np.std(means), abs=1e-12)
    # the shape of benchmarks/evals_r5/*.json (scripts/evaluate.py:237-262)
    with open(os.path.join(REPO, "benchmarks", "evals_r5", "vreg1b_gt03_s1.json")) as f:
        r5 = json.load(f)
    assert list(runs[8]) == list(r5)
    assert list(s) == list(r5["summary"])
    assert list(runs[8]["seeds"]["0"]) == list(next(iter(r5["seeds"].values())))


def test_directory_evaluate_serves_an_int8_act_package_through_qconv(model_dirs, val_split):
    """An int8_act package is evaluated by the int8-compute model its
    config records (JAX scripts/evaluate.py:76-84)."""
    from cv_diffusion_tpu_torch.export.quantization import (act_quant_model,
                                                            calibrate_act_scales)
    ckpt, _, weights, cfg = model_dirs
    qmodel, _ = act_quant_model(cfg, device="cpu")
    qmodel.load_state_dict(weights, strict=True)
    model, schedule = create_model(cfg, device="cpu")
    model.load_state_dict(weights, strict=True)
    batch = {"low_light": np.full((2, SIZE, SIZE, 3), -0.5, np.float32),
             "normal_light": np.zeros((2, SIZE, SIZE, 3), np.float32)}
    scales = calibrate_act_scales(qmodel, schedule, [batch],
                                  generator=torch.Generator().manual_seed(0))
    pkg = os.path.join(os.path.dirname(ckpt), "int8_act")
    create_serving_package(pkg, model, schedule, quantize="int8_act",
                           act_scales=scales, timesteps=GRID)
    loaded, _, variant = evaluate.load_model(pkg, "small", SIZE, 4, "bfloat16", False,
                                             "cpu")
    assert loaded.config.unet.act_quant is True and variant == "tiny"
    out = evaluate.evaluate_directory(str(val_split), pkg, image_size=SIZE,
                                      batch_size=4, device="cpu")
    assert all(np.isfinite(out["seeds"]["0"]["psnr"]))


def jax_row_keys():
    """The keys of the JAX benchmark script's result rows
    (``scripts/benchmark.py:49-57``), read from its source."""
    with open(os.path.join(REPO, "scripts", "benchmark.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "append"
                and isinstance(node.args[0], ast.Dict)):
            return tuple(k.value for k in node.args[0].keys)
    raise AssertionError("no results.append({...}) in scripts/benchmark.py")


def test_benchmark_cli_rows_and_trace(model_dirs, tmp_path, capsys):
    result = benchmark.main(["--variant", "tiny", "--image_size", str(SIZE), "--num_steps",
                             "2", "--batch_sizes", "1", "2", "--num_runs", "2",
                             "--dtype", "float32", "--device", "cpu",
                             "--profile", str(tmp_path / "trace")])
    assert benchmark.ROW_KEYS == jax_row_keys()
    assert [tuple(r) for r in result["rows"]] == [benchmark.ROW_KEYS] * 2
    assert [r["batch"] for r in result["rows"]] == [1, 2]
    for r in result["rows"]:
        assert 0 < r["min_ms"] <= r["mean_ms"] <= r["max_ms"]
        assert r["per_step_ms"] == pytest.approx(r["mean_ms"] / 2)
        assert r["img_per_sec"] == pytest.approx(r["batch"] * 1e3 / r["mean_ms"])
    assert os.path.dirname(result["trace"]) == str(tmp_path / "trace")
    with open(result["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert "Batch-1 end-to-end" in capsys.readouterr().out
    stats = benchmark.main(["--model", str(model_dirs[1]), "--format", "package",
                            "--num_runs", "2", "--device", "cpu"])["stats"]
    assert {"mean_ms", "p50_ms", "inference_ms", "fps"} <= set(stats)
