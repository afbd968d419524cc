"""Serving packages and the serving pipeline's batching, against the JAX
package (``cv_diffusion_tpu/export/serving.py``).

- Each codec's package (fp32, bf16, int8) round-trips bit for bit through
  ``params.npz``; its ``model_config.json`` equals the one JAX's
  ``create_serving_package`` writes for the same settings, key for key but
  ``framework``, and its ``noise_schedule.npz`` equals JAX's; ``int8_act``
  without calibrated scales and ``include_graph`` are refused (int8_act
  packages: ``tests/test_torch_port_int8_act.py``).
- The bf16 and int8 packages load to the weights JAX's own
  ``load_serving_package`` gives, bit for bit, and serve within 5e-3 of
  JAX's ``enhance`` on those params with the same explicit noise, unfused
  and with ``use_pallas_irb`` (JAX's Pallas kernels in interpret mode). The
  model here is the tiny variant cut to one level at 16² (its IRBs with SE,
  ``mid_attn``, the time MLP and the convolutions): JAX quantizes tensor by
  tensor, compiling its ops for every distinct shape, and few shapes keep
  the test short. ``tests/test_torch_port_quantization.py`` holds every
  tensor of the whole tiny model to JAX.
- ``from_package`` takes its defaults from the package
  (``tests/test_export.py:272-303``), ``batch`` keeps at most
  ``MAX_IN_FLIGHT`` chunks ahead of the fetch, input order and determinism
  (``:201-246``), ``benchmark`` returns JAX's keys (``:305``), and the
  sampler's noise comes from the function eager ``enhance`` draws it with.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.export import serving as jserving
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
from cv_diffusion_tpu_torch.config import diffusion_config
from cv_diffusion_tpu_torch.export.quantization import (dequantize_int8,
                                                        quantize_model)
from cv_diffusion_tpu_torch.export.serving import (ServingConfig,
                                                   ServingPipeline,
                                                   create_serving_package,
                                                   load_serving_package)
from cv_diffusion_tpu_torch.models.diffusion import (create_model, enhance,
                                                     sampler_noise)
from cv_diffusion_tpu_torch.weights import (init_weights, load_state_dict_npz,
                                            state_dict_from_jax)

from test_torch_port_weights import one_torch_thread  # noqa: F401
from test_torch_port_weights import random_jax_params

TOL = 5e-3                       # README "Testing": the full sampler
SIZE = 16
SMALL = dict(channel_multipliers=(1,), attention_resolutions=())
BENCH_KEYS = ("mean_ms", "std_ms", "min_ms", "max_ms", "p50_ms",
              "preprocess_ms", "inference_ms", "per_step_ms",
              "postprocess_ms", "fps")


@pytest.fixture(scope="module")
def tiny32():
    """The port's tiny model at 32² on random weights, on the CPU."""
    cfg = diffusion_config("tiny", 32)
    model, schedule = create_model(cfg, device="cpu")
    model.load_state_dict(init_weights(cfg, seed=0, device="cpu"), strict=True)
    return model, schedule


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, schedule and params, port config, per codec JAX's
    loaded package and the port's package directory): the same random
    weights on both sides."""
    jcfg, tcfg, params = random_jax_params("tiny", SIZE, seed=5, **SMALL)
    jmodel, jsched = jax_create_model(jcfg)
    model, schedule = create_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    root = tmp_path_factory.mktemp("packages")
    packages = {}
    for codec in ("bf16", "int8"):
        jserving.create_serving_package(str(root / f"jax_{codec}"), jmodel, jsched,
                                        params, quantize=codec, timesteps=[739])
        create_serving_package(str(root / f"port_{codec}"), model, schedule,
                               quantize=codec, timesteps=[739])
        packages[codec] = (jserving.load_serving_package(str(root / f"jax_{codec}")),
                           str(root / f"port_{codec}"))
    return (jmodel, jsched, params), tcfg, packages


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_package_round_trips_bit_for_bit(tiny32, tmp_path, codec):
    model, schedule = tiny32
    state = {k: t.detach().clone() for k, t in model.state_dict().items()}
    files = create_serving_package(str(tmp_path), model, schedule,
                                   quantize=codec, timesteps=[739])
    stored = load_state_dict_npz(files["params"], "cpu")
    want, tag = quantize_model(state, model.config, codec)
    if tag == "int8":
        assert {k.split("/")[0] for k in stored} == {"values", "scales", "quantized"}
        for part in ("values", "scales"):
            for k, t in want[part].items():
                got = stored[f"{part}/{k}"]
                assert got.dtype == t.dtype and torch.equal(got, t), (part, k)
        assert {k: bool(stored[f"quantized/{k}"]) for k in state} == want["quantized"]
        want = dequantize_int8(want)
    else:
        assert set(stored) == set(want)
        for k, t in want.items():
            assert stored[k].dtype == t.dtype and torch.equal(stored[k], t), k
    _, _, loaded, meta = load_serving_package(str(tmp_path), "cpu")
    assert meta["quantization"] == tag and meta["framework"] == "cv_diffusion_tpu_torch"
    for k, t in want.items():
        assert loaded[k].dtype == torch.float32 and torch.equal(loaded[k], t.float()), k


@pytest.mark.parametrize("settings", [
    dict(quantize="bf16", timesteps=[739], batch_size=1),
    dict(quantize="none", num_inference_steps=2, batch_size=4,
         dynamic_batch=True, deterministic=True),
])
def test_package_files_equal_jax(pair, tmp_path, settings):
    (jmodel, jsched, params), tcfg, _ = pair
    jserving.create_serving_package(str(tmp_path / "jax"), jmodel, jsched, params,
                                    **settings)
    model, schedule = create_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    create_serving_package(str(tmp_path / "port"), model, schedule, **settings)
    with open(tmp_path / "jax" / "model_config.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "model_config.json") as f:
        got = json.load(f)
    assert want.pop("framework") == "cv_diffusion_tpu"
    assert got.pop("framework") == "cv_diffusion_tpu_torch"
    assert got == want
    with np.load(tmp_path / "jax" / "noise_schedule.npz") as a, \
            np.load(tmp_path / "port" / "noise_schedule.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(quantize="int8_act"), ValueError, "calibrated act_scales"),
    (dict(include_graph=True), NotImplementedError, "CUDA graph"),
])
def test_unported_package_options_raise(tiny32, tmp_path, kwargs, error, match):
    model, schedule = tiny32
    with pytest.raises(error, match=match):
        create_serving_package(str(tmp_path), model, schedule, **kwargs)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "use_pallas_irb"])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_codec_package_serves_like_jax(pair, codec, fused):
    _, tcfg, packages = pair
    (jmodel, jsched, jparams, _), port_dir = packages[codec]
    model, schedule, state, meta = load_serving_package(port_dir, "cpu",
                                                        use_pallas_irb=fused)
    assert meta["quantization"] == codec
    assert model.config.unet.use_pallas_irb == fused
    # the weights JAX serves, bit for bit (bf16 upcast, int8 dequantized)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    assert set(want) == set(state)
    for k, t in want.items():
        assert torch.equal(state[k], t), k
    if fused:
        jmodel, _ = jax_create_model(dataclasses.replace(
            jmodel.config, unet=dataclasses.replace(jmodel.config.unet,
                                                    use_pallas_irb=True)))
    rng = np.random.default_rng(9)
    low = rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    init = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    noise = rng.standard_normal((1, 1, SIZE, SIZE, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x, i, n: jax_enhance(
        jmodel, jsched, v, jax.random.key(0), x, init_noise=i, step_noise=n,
        timesteps=[739]))({"params": jparams}, jnp.asarray(low),
                          jnp.asarray(init), jnp.asarray(noise))
    got = enhance(model, schedule, torch.from_numpy(low), timesteps=[739],
                  init_noise=torch.from_numpy(init),
                  step_noise=torch.from_numpy(noise), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_from_package_defaults_from_metadata(tiny32, tmp_path):
    model, schedule = tiny32
    create_serving_package(str(tmp_path), model, schedule, num_inference_steps=2)
    pipe = ServingPipeline.from_package(str(tmp_path), device="cpu")
    assert pipe.config.image_size == 32            # from package metadata
    assert pipe.config.num_inference_steps == 2    # from package metadata
    assert pipe.grid == [519, 19]                  # the stock 2-step grid
    pipe = ServingPipeline.from_package(str(tmp_path), device="cpu",
                                        image_size=None,
                                        num_inference_steps=1, batch_size=4)
    assert pipe.config.image_size == 32            # None override dropped
    assert pipe.config.num_inference_steps == 1    # explicit override wins
    assert pipe.config.batch_size == 4
    pipe = ServingPipeline.from_package(
        str(tmp_path), ServingConfig(image_size=32, num_inference_steps=3),
        device="cpu", batch_size=4)
    assert pipe.config.num_inference_steps == 3 and pipe.config.batch_size == 1
    img = np.zeros((32, 32, 3), dtype=np.uint8)
    assert pipe(img).shape == (32, 32, 3)


def test_batch_window_order_and_determinism(tiny32):
    """Long lists: at every dispatch at most MAX_IN_FLIGHT earlier chunks
    are unfetched; outputs come back in input order (each image its own
    size) and the same seed gives the same outputs."""
    model, schedule = tiny32
    pipe = ServingPipeline(model, schedule, ServingConfig(
        image_size=32, num_inference_steps=2, batch_size=2), device="cpu")
    dispatched, fetched = [0], [0]
    run, fetch = pipe._run, pipe._fetch

    def counting_run(*args, **kwargs):
        dispatched[0] += 1
        assert dispatched[0] - 1 - fetched[0] <= pipe.MAX_IN_FLIGHT
        return run(*args, **kwargs)

    def counting_fetch(pending):
        fetched[0] += 1
        return fetch(pending)

    pipe._run, pipe._fetch = counting_run, counting_fetch
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 60, (30 + i, 44 - i, 3), dtype=np.uint8)
            for i in range(13)]          # 7 chunks of 2, the last one padded
    outs = pipe.batch(imgs, seed=3)
    assert dispatched[0] == fetched[0] == 7 and len(outs) == 13
    for img, out in zip(imgs, outs):
        assert out.shape == img.shape and out.dtype == np.uint8
    again = pipe.batch(imgs, seed=3)
    for a, b in zip(outs, again):
        np.testing.assert_array_equal(a, b)
    # chunk 1 alone, seeded as the batch seeds it, gives the same images
    chunk = ServingPipeline(model, schedule, pipe.config, device="cpu")
    for a, b in zip(chunk.batch(imgs[2:4], seed=4), outs[2:4]):
        np.testing.assert_array_equal(a, b)


def test_benchmark_returns_the_jax_keys(tiny32):
    model, schedule = tiny32
    pipe = ServingPipeline(model, schedule, ServingConfig(
        image_size=32, num_inference_steps=2), device="cpu")
    stats = pipe.benchmark(num_runs=2, warmup=1)
    assert tuple(stats) == BENCH_KEYS
    assert all(np.isfinite(v) for v in stats.values())


def test_sampler_noise_is_what_enhance_draws(tiny32):
    """One function draws the sampler's noise for eager ``enhance`` and for
    the serving graph's buffers: init first, then [steps, B, S, S, 3] (also
    for one step); filled in place it draws the same numbers."""
    model, schedule = tiny32
    shape = (2, 32, 32, 3)
    low = torch.rand(shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    drawn = enhance(model, schedule, low, timesteps=[739, 259],
                    generator=torch.Generator().manual_seed(7), device="cpu")
    init, step = sampler_noise(torch.Generator().manual_seed(7), shape, 2, "cpu")
    assert step.shape == (2,) + shape
    explicit = enhance(model, schedule, low, timesteps=[739, 259],
                       init_noise=init, step_noise=step, device="cpu")
    assert torch.equal(drawn, explicit)
    gen = torch.Generator().manual_seed(7)
    want = (torch.randn(shape, generator=gen), torch.randn((1,) + shape, generator=gen))
    buffers = (torch.zeros(shape), torch.zeros((1,) + shape))
    got = sampler_noise(torch.Generator().manual_seed(7), shape, 1, "cpu", out=buffers)
    assert got[0] is buffers[0] and got[1] is buffers[1]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the pipeline's eager sampler draws through it too
    pipe = ServingPipeline(model, schedule, ServingConfig(
        image_size=32, timesteps=(739, 259)), device="cpu")
    canvas = torch.randint(0, 256, shape, dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    out = pipe._run(canvas, torch.Generator().manual_seed(7))
    want = ((enhance(model, schedule, canvas.float() / 127.5 - 1.0,
                     timesteps=[739, 259], init_noise=init, step_noise=step,
                     device="cpu") * 127.5 + 127.5).clamp(0, 255).to(torch.uint8))
    assert torch.equal(out, want)
