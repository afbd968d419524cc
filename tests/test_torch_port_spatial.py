"""The port's spatial sharding on the CPU: the UNet's layers, its forward
and the sampler over a ``(data, spatial)`` mesh, against the port's
one-process layers and paths and the JAX package.

Four processes of the port (``tests/torch_dp_rank.py spatial``, gloo,
started once for the module) run each layer on its strip of image rows
(or tokens) on a ``(2, 2)`` and a ``(1, 4)`` mesh, forward and backward in
float64, the tiny UNet at 32² on ``(1, 4)`` (whose four levels give strips
of 8, 4, 2 and 1 rows) and the sampler on ``(2, 2)``. The test holds each
rank's block against the same computation on the whole input in this
process, and the sampler against JAX's ``enhance``. What a spatial axis
does not run (ROADMAP item 8c) and an image height that does not split
are refused in this process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
from cv_diffusion_tpu.ops.attention import linear_attention_xla
from cv_diffusion_tpu_torch import parallel as tpar
from cv_diffusion_tpu_torch.models.diffusion import enhance, sampler_noise
from cv_diffusion_tpu_torch.models.distillation import (make_distillation_step,
                                                        make_regression_distillation_step)
from cv_diffusion_tpu_torch.parallel.mesh import SpatialShard
from cv_diffusion_tpu_torch.training import train_state as tts
from cv_diffusion_tpu_torch.training.trainer import DistillationTrainer
from cv_diffusion_tpu_torch.weights import state_dict_from_jax

import torch_dp_rank
from torch_dp_rank import (LAYERS, SPATIAL_MESHES, layer_inputs, run_layer,
                           spatial_layers, step_config, tiny)
from test_torch_port_weights import (jax_in_float64, one_torch_thread,  # noqa: F401
                                     random_jax_params)

WORLD = 4
SIZE = 32
LAYER_TOL = 1e-9            # float64, sharded against whole
SAMPLER_TOL = 5e-3          # the README's sampler tolerance (JAX vs the port)
# float32, the same sampler at other row counts: the CPU's sgemm rounds a
# row differently at 4 rows than at 8 (test_torch_port_parallel.py says
# where); 1.9e-4 measured at 2 steps
ONE_PROCESS_SAMPLER_TOL = 1e-3
FORWARD_TOL = dict(atol=2e-4, rtol=2e-3)     # tests/test_parallel.py:326-327


@pytest.fixture(scope="module")
def case():
    """JAX config, port config and random weights (flax-init norms) of the
    tiny v-prediction UNet at 32²."""
    return random_jax_params("tiny", SIZE, seed=7, perturb_norms=False)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """(inputs, each process's results) of the ``spatial`` task."""
    _, tcfg, params = case
    rng = np.random.default_rng(4)
    inputs = dict(
        weights=state_dict_from_jax(params, tcfg),
        noisy=rng.standard_normal((2, 3, SIZE, SIZE)).astype(np.float32),
        low_nchw=rng.uniform(-1, 0, (2, 3, SIZE, SIZE)).astype(np.float32),
        t=np.asarray([120, 860], dtype=np.int64),
        low=rng.uniform(-1, 0, (8, SIZE, SIZE, 3)).astype(np.float32))
    directory = str(tmp_path_factory.mktemp("spatial"))
    return inputs, torch_dp_rank.spawn("spatial", directory, inputs, WORLD)


def _coords(shape, rank):
    where = np.argwhere(np.arange(WORLD).reshape(shape) == rank)[0]
    return dict(zip(("data", "spatial"), where.tolist()))


def _strip(a, index, n, dim):
    rows = a.shape[dim] // n
    return np.take(a, range(index * rows, (index + 1) * rows), axis=dim)


@pytest.mark.parametrize("name", [n for n in LAYERS if n not in ("linear",)])
def test_layer_sharded_matches_whole(ranks, name, one_torch_thread):  # noqa: F811
    """Each layer on its strip of image rows (or tokens) of a (2, 2) and a
    (1, 4) mesh: the output, the gradient of output·w with respect to the
    input (each rank's strip) and to the parameters (summed over a spatial
    line) equal the layer on the whole input, float64 within 1e-9: the
    3×3 conv and depthwise (halo rows), Downsample (one row above),
    Upsample (edge rows copied at the border), GroupNorm plain, with FiLM,
    split_skip's parts and fold_gn's Gram affine, SE, softmax attention and
    the fused IRB (gathered; forward only, plain version)."""
    _, results = ranks
    x, qkv = layer_inputs()
    kind = spatial_layers()[name][2]
    want_y, want_dx, want_dp = run_layer(name, qkv if kind == "tokens" else x)
    dim = {"tokens": 1, "image": 2, "replicated": None}[kind]
    for shape in SPATIAL_MESHES:
        n = shape[1]
        sums = {}
        for rank, res in enumerate(results):
            got = res["layers"][(shape, name)]
            c = _coords(shape, rank)
            y = want_y.numpy() if dim is None else _strip(want_y.numpy(), c["spatial"], n, dim)
            np.testing.assert_allclose(got["out"], y, atol=LAYER_TOL, rtol=0,
                                       err_msg=f"{shape} rank {rank}")
            if want_dx is None:
                continue
            xdim = 2 if kind == "tokens" else 2
            np.testing.assert_allclose(got["dx"], _strip(want_dx.numpy(), c["spatial"], n, xdim),
                                       atol=LAYER_TOL, rtol=0)
            if c["data"] == 0:
                for i, g in enumerate(got["dparams"]):
                    sums[i] = g if i not in sums else sums[i] + g
        for i, g in enumerate(want_dp):
            np.testing.assert_allclose(sums[i], g.numpy(), atol=LAYER_TOL, rtol=0,
                                       err_msg=f"{shape} param {i}")


def test_linear_attention_sharded_matches_jax(ranks, monkeypatch):
    """Token-sharded linear attention through the four sharded entries
    (their plain versions here) on a (2, 2) and a (1, 4) mesh: each rank's
    output and its tokens' dq, dk, dv against JAX's ``linear_attention_xla``
    and its VJP on the whole sequence, narrowed, float64 within 1e-9."""
    _, results = ranks
    _, qkv = layer_inputs()
    w = torch.randn(torch_dp_rank.TOKENS, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64).numpy()
    with jax_in_float64(monkeypatch):
        q, k, v = (jnp.asarray(t.numpy()) for t in qkv)
        y, vjp = jax.vjp(linear_attention_xla, q, k, v)
        dq, dk, dv = (np.asarray(g) for g in vjp(jnp.asarray(w)))
        y = np.asarray(y)
    dqkv = np.stack([dq, dk, dv])
    for shape in SPATIAL_MESHES:
        for rank, res in enumerate(results):
            got = res["layers"][(shape, "linear")]
            s = _coords(shape, rank)["spatial"]
            np.testing.assert_allclose(got["out"], _strip(y, s, shape[1], 1),
                                       atol=LAYER_TOL, rtol=0)
            np.testing.assert_allclose(got["dx"], _strip(dqkv, s, shape[1], 2),
                                       atol=LAYER_TOL, rtol=0)


def test_unet_forward_on_four_strips_matches_one_process(ranks, one_torch_thread):  # noqa: F811
    """The tiny UNet at 32², float32, on a (1, 4) mesh (strips of 8, 4, 2
    and 1 rows at its four levels): each rank's strip of the output against
    the one-process forward within JAX's own bounds for its sharded
    forward, 2e-4 / 2e-3 (``tests/test_parallel.py:326-327``). The
    control, every rank's strip run alone with no exchange, fails them."""
    inputs, results = ranks
    model, _ = tiny(inputs)
    with torch.no_grad():
        want = model(*(torch.from_numpy(inputs[k]) for k in ("noisy", "low_nchw")),
                     torch.from_numpy(inputs["t"])).numpy()
    worst = 0.0
    for rank, res in enumerate(results):
        part = _strip(want, rank, 4, 2)
        np.testing.assert_allclose(res["forward"]["sharded"], part, **FORWARD_TOL)
        excess = np.abs(res["forward"]["alone"] - part) - (
            FORWARD_TOL["atol"] + FORWARD_TOL["rtol"] * np.abs(part))
        worst = max(worst, float(excess.max()))
    assert worst > 0, "the no-exchange control passed the bound"


def test_unet_bf16_forward_on_strips_is_as_close_to_float32(ranks, one_torch_thread):  # noqa: F811
    """In bf16 compute the strips' sums round apart from the whole image's,
    so the (1, 4) forward is held by its distance from the float32
    forward: its mean is at most 1.5× the one-process bf16 forward's
    (``chip_smoke.py``'s SP_BF16_RATIO for the served student)."""
    from cv_diffusion_tpu_torch.models.diffusion import with_dtype

    inputs, results = ranks
    model, _ = tiny(inputs)
    args = [torch.from_numpy(inputs[k]) for k in ("noisy", "low_nchw")] + [
        torch.from_numpy(inputs["t"])]
    with torch.no_grad():
        f32 = model(*args).numpy()
        one = with_dtype(model, "bfloat16")(*args).float().numpy()
    sharded = np.concatenate([r["forward"]["bf16"] for r in results], axis=2)
    assert np.abs(sharded - f32).mean() <= 1.5 * np.abs(one - f32).mean()


def test_spatial_sampler_matches_enhance_and_jax(case, ranks, one_torch_thread):  # noqa: F811
    """The sampler on a (2, 2) mesh (two rows of the batch of 8 and 16
    image rows a process, eager: ``graphs`` stays empty), its noise drawn
    for the global batch: the gathered batch against the port's
    one-process ``enhance`` (1e-3, float32 at other row counts) and JAX's
    ``enhance`` on the same noise (the sampler tolerance 5e-3); ``gather``
    puts each process's block in its place."""
    jcfg, _, params = case
    inputs, results = ranks
    model, schedule = tiny(inputs)
    low = torch.from_numpy(inputs["low"])
    init, step = sampler_noise(torch.Generator().manual_seed(5), (8, SIZE, SIZE, 3), 2, "cpu")
    one = enhance(model, schedule, low, num_inference_steps=2, init_noise=init,
                  step_noise=step, device="cpu").numpy()
    whole = results[0]["serve"]["whole"]
    np.testing.assert_allclose(whole, one, atol=ONE_PROCESS_SAMPLER_TOL, rtol=0)
    for rank, res in enumerate(results):
        c = _coords((2, 2), rank)
        block = whole[4 * c["data"]:4 * c["data"] + 4, 16 * c["spatial"]:16 * c["spatial"] + 16]
        assert np.array_equal(res["serve"]["local"], block)
        assert np.array_equal(res["serve"]["whole"], whole)
        assert res["serve"]["graphs"] == {}
    jmodel, jschedule = jax_create_model(jcfg)
    ref = jax_enhance(jmodel, jschedule, {"params": params}, jax.random.key(0),
                      jnp.asarray(inputs["low"]), num_inference_steps=2,
                      init_noise=jnp.asarray(init.numpy()),
                      step_noise=jnp.asarray(step.numpy()))
    np.testing.assert_allclose(whole, np.asarray(ref), atol=SAMPLER_TOL, rtol=0)


def test_dropout_masks_are_the_one_process_draws(ranks):
    """Dropout inside a global batch of 4 images of 32 rows: each rank's
    mask (its 2 rows of the batch, its 16 image rows) is the one-process
    mask's block."""
    _, results = ranks
    from cv_diffusion_tpu_torch.models import blocks

    want = blocks.dropout(torch.ones(4, 3, 32, 32), 0.5,
                          torch.Generator().manual_seed(9)).numpy()
    for rank, res in enumerate(results):
        c = _coords((2, 2), rank)
        np.testing.assert_array_equal(
            res["dropout"], want[2 * c["data"]:2 * c["data"] + 2, :,
                                 16 * c["spatial"]:16 * c["spatial"] + 16])


def test_spatial_axis_refuses_what_it_does_not_run(case):
    """On a (1, 2) layout (no process group): ``act_quant`` models (int8 and
    fake-quant, their dynamic amax would need a max over the group),
    ``qat_act``, the distillation steps and ``DistillationTrainer`` raise
    ``NotImplementedError`` naming ROADMAP item 8c; an image height that
    does not split into strips every level halves evenly raises
    ``ValueError`` (JAX's partitioner would pad: a kept divergence)."""
    _, tcfg, params = case
    mesh = tpar.make_mesh((1, 2), devices=[0, 1])
    weights = state_dict_from_jax(params, tcfg)
    for mode in (True, "fake"):
        model, schedule = tiny({"weights": weights}, act_quant=mode)
        with pytest.raises(NotImplementedError, match="item 8c"):
            tpar.make_sharded_sample_fn(model, schedule, 2, mesh=mesh)
        with pytest.raises(NotImplementedError, match="item 8c"):
            tts.make_eval_step(model, schedule, step_config(), mesh=mesh)
    model, schedule = tiny({"weights": weights})
    with pytest.raises(NotImplementedError, match="item 8c"):
        tts.make_train_step(model, schedule, step_config(qat_act=True), mesh=mesh)
    for make in (lambda: make_distillation_step(model, schedule, mesh=mesh),
                 lambda: make_regression_distillation_step(model, schedule, mesh=mesh),
                 lambda: DistillationTrainer(model, schedule, weights, [None],
                                             config=step_config(), mesh=mesh)):
        with pytest.raises(NotImplementedError, match="item 8c"):
            make()
    sampler = tpar.make_sharded_sample_fn(model, schedule, 2, mesh=mesh)
    with pytest.raises(ValueError, match="multiple of 16"):
        sampler(weights, torch.Generator().manual_seed(0), torch.zeros(1, 40, 40, 3))
    shard = SpatialShard(None, 4, 1)
    shard.check_height(32, 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        shard.check_height(48, 4)
