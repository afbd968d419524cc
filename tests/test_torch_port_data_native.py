"""The port's copy of the C++ data loader against the JAX package's.

Both libraries are built here with ``g++`` from their own sources
(``cv_diffusion_tpu_torch/csrc/dataloader.cc`` through
``ops/cuda_build.py::build_host``, ``native/dataloader.cc`` loaded by the
JAX package through ``CVDM_NATIVE_LIB``), with the same flags, into
``tmp_path``; for the same seeds they give identical batches. The port's
numpy rotation equals the native one, its PNG decoder the native decoder,
and ``create_dataloaders`` routes to the native loaders as JAX's does.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from cv_diffusion_tpu.data import native as jnative
from cv_diffusion_tpu_torch.data import augment as taugment
from cv_diffusion_tpu_torch.data import dataset as tdataset
from cv_diffusion_tpu_torch.data import native as tnative
from cv_diffusion_tpu_torch.data import png
from cv_diffusion_tpu_torch.data.prefetch import PrefetchLoader
from cv_diffusion_tpu_torch.ops import cuda_build

from test_torch_port_weights import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both libraries built into a temporary directory and loaded, each
    module's cache put back afterwards."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    out = str(tmp_path_factory.mktemp("native"))
    port = cuda_build.build_host(tnative.SOURCE, tnative.LIBS, build_dir=out)
    jax_src = os.path.join(out, "jax_dataloader.cc")
    shutil.copy(os.path.join(REPO, "native", "dataloader.cc"), jax_src)
    jax_lib = cuda_build.build_host(jax_src, tnative.LIBS, build_dir=out)
    saved = (tnative._LIB, tnative._REASON, jnative._LIB,
             os.environ.get("CVDM_NATIVE_LIB"))
    lib = ctypes.CDLL(port.path)
    tnative._declare(lib)
    tnative._LIB, tnative._REASON = lib, None
    os.environ["CVDM_NATIVE_LIB"] = jax_lib.path
    jnative._LIB = None
    assert jnative.native_available()
    yield
    tnative._LIB, tnative._REASON, jnative._LIB = saved[:3]
    if saved[3] is None:
        os.environ.pop("CVDM_NATIVE_LIB", None)
    else:
        os.environ["CVDM_NATIVE_LIB"] = saved[3]


@pytest.fixture(scope="module")
def lol_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("lol")
    rng = np.random.default_rng(0)
    for sub in ("low", "high"):
        (root / sub).mkdir()
    for i in range(6):
        high = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
        low = (high * rng.uniform(0.1, 0.4)).astype(np.uint8)
        # the port's encoder, rows cycling through the five filters
        png.write_png(root / "low" / f"{i:02d}.png", low, (0, 1, 2, 3, 4))
        Image.fromarray(high).save(root / "high" / f"{i:02d}.png")
    return root


def _paths(root, sub):
    return sorted(str(p) for p in (root / sub).iterdir())


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_libraries_give_identical_batches(libs, lol_dir, seed):
    lows, highs = _paths(lol_dir, "low"), _paths(lol_dir, "high")
    for augment in (True, False):
        got = tnative.load_pair_batch(lows, highs, 32, seed, augment)
        want = jnative.load_pair_batch(lows, highs, 32, seed, augment)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = tnative.load_synth_batch(highs, 32, seed, (2.0, 3.0), (0.02, 0.03))
    want = jnative.load_synth_batch(highs, 32, seed, (2.0, 3.0), (0.02, 0.03))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_loaders_iterate_as_jax(libs, lol_dir):
    kw = dict(image_size=32, batch_size=4, shuffle=True, drop_last=True, seed=2)
    got = tnative.NativeDataLoader.from_dataset_dir(str(lol_dir), **kw)
    want = jnative.NativeDataLoader.from_dataset_dir(str(lol_dir), **kw)
    gs = tnative.NativeSyntheticDataLoader(_paths(lol_dir, "high"), **kw)
    ws = jnative.NativeSyntheticDataLoader(_paths(lol_dir, "high"), **kw)
    assert len(got) == len(want) == 1
    for _ in range(2):                        # the epochs reseed alike
        for a, b in zip(list(got) + list(gs), list(want) + list(ws)):
            assert a["filenames"] == b["filenames"]
            for key in ("low_light", "normal_light"):
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("angle", [-15.0, -7.3, 0.0, 4.9, 15.0])
def test_numpy_rotation_equals_the_native_one(libs, angle):
    img = np.random.default_rng(11).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    want = jnative.rotate_u8(img, angle)
    np.testing.assert_array_equal(tnative.rotate_u8(img, angle), want)
    np.testing.assert_array_equal(taugment.rotate(img, angle), want)


def test_native_decoder_equals_the_numpy_decoder(libs, lol_dir):
    for p in _paths(lol_dir, "low") + _paths(lol_dir, "high"):
        np.testing.assert_array_equal(tnative.decode_image(p), png.read_image(p))


def _kind(x):
    if x is None:
        return None
    if isinstance(x, PrefetchLoader):
        return "prefetch:" + _kind(x.loader)
    return type(x).__name__


def test_create_dataloaders_routes_to_native(libs, lol_dir, tmp_path, capsys):
    root = str(lol_dir)
    kw = dict(batch_size=2, image_size=32, device="cpu")
    train, val = tdataset.create_dataloaders(root, root, **kw)
    assert (_kind(train), _kind(val)) == ("prefetch:NativeDataLoader",
                                          "prefetch:NativeDataLoader")
    # the native eval batches are the Python eval batches
    python_val = tdataset.create_dataloaders(root, root, native=False,
                                             prefetch=0, **kw)[1]
    for a, b in zip(val, python_val):
        assert a["filenames"] == b["filenames"]
        np.testing.assert_array_equal(a["low_light"], b["low_light"])
    train, _ = tdataset.create_dataloaders(str(lol_dir / "high"), None,
                                           use_synthetic=True, native=True, **kw)
    assert _kind(train) == "prefetch:NativeSyntheticDataLoader"
    train, _ = tdataset.create_dataloaders(root, None, paired=False, **kw)
    assert _kind(train) == "prefetch:DataLoader"
    assert "paired=False" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="paired=False"):
        tdataset.create_dataloaders(root, None, paired=False, native=True, **kw)
    bmp = tmp_path / "bmp"
    for sub in ("low", "high"):
        (bmp / sub).mkdir(parents=True)
        Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(bmp / sub / "a.bmp")
    assert _kind(tdataset.create_dataloaders(str(bmp), None, **kw)[0]) == \
        "prefetch:DataLoader"
    with pytest.raises(RuntimeError, match="non-PNG/JPEG"):
        tdataset.create_dataloaders(str(bmp), None, native=True, **kw)


def test_unavailable_library_says_why(tmp_path, monkeypatch):
    """Where the headers are missing (as libpng's and libjpeg's are on the
    card's machine) the build fails, ``native_available`` is False, the
    reason names the header, and every entry point raises with it."""
    src = tmp_path / "dataloader.cc"
    src.write_text("#include <no_such_header_png.h>\n")
    monkeypatch.setattr(tnative, "SOURCE", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_REASON", None)
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler here")
    assert not tnative.native_available()
    assert "no_such_header_png.h" in tnative.native_unavailable_reason()
    with pytest.raises(RuntimeError, match="unavailable: .*no_such_header_png"):
        tnative.decode_image(str(src))
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.NativeDataLoader([], [], 32, 2)
