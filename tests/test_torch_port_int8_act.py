"""The port's int8 activation compute path against the JAX package's, on the
CPU: PTQ calibration, the int8 UNet and sampler, ``int8_act`` packages and
the export CLI.

The tiny UNet at 32², v-prediction, random weights, its 71 ``QConv``s. JAX's
calibration draws (``calibrate_act_scales``: per batch ``split`` into t and
ε keys; ``calibrate_activations``: one three-way split) are replayed with
``jax.random`` and handed to the port as explicit draws. Within a block the
int8 convolutions are exact on both sides; what differs is the float work
between them (GroupNorm, SE, attention), at float32 rounding, and where such
a value sits on a rounding boundary of the next quantization the two sides
take neighbouring int8 values. So the int8 blocks and the sampler are held
by the mean of their difference, with the float blocks (and the float
sampler) as the control that must fail the same bound.
"""

import dataclasses
import json
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.export import quantization as jquant
from cv_diffusion_tpu.export.serving import \
    create_serving_package as jax_create_serving_package
from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.unet import EfficientUNet
from cv_diffusion_tpu_torch.export import quantization as tquant
from cv_diffusion_tpu_torch.export.serving import (ServingPipeline,
                                                   create_serving_package,
                                                   load_serving_package)
from cv_diffusion_tpu_torch.models.diffusion import run_sampler, with_dtype
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.weights import (act_scales_from_jax, act_scales_to_jax,
                                            state_dict_from_jax)

from test_torch_port_bf16 import port_block_names
from test_torch_port_weights import (jax_in_float64, nchw, nhwc,  # noqa: F401
                                     one_torch_thread, port_model,
                                     random_jax_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
# mean |Δ| of an int8 block's output, relative to the mean |output|: the
# port's int8 blocks on JAX's inputs (measured below 1e-4 on every block of
# the tiny UNet) and the float blocks, the control (above 2e-3 on every
# block with a convolution after a quantized input)
BLOCK_TOL = 5e-4
# the 1-step sampler's output, mean |Δ| against JAX's int8 sampler in
# float32: the port's int8 sampler (measured 1.0e-2: random tiny weights
# carry the flips of the early layers through the network) and, the
# control, its float sampler (6.3e-2). In float64 the two int8 samplers
# agree to 1e-9.
SAMPLER_TOL = 2e-2
# each calibrated amax against JAX's in float32: measured at most 8.1e-3
# (most equal); in float64, 1e-12
SCALE_RTOL = 1e-2


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("low_light", "normal_light")} for _ in range(n)]


def jax_calibration_draws(batches, rng=None):
    """``calibrate_act_scales``' draws (``quantization.py:234-247``): per
    batch ``rng, b = split(rng)``, ``t_rng, n_rng = split(b)``, t and ε."""
    rng = jax.random.key(0) if rng is None else rng
    out = []
    for batch in batches:
        rng, b_rng = jax.random.split(rng)
        t_rng, n_rng = jax.random.split(b_rng)
        high = batch["normal_light"]
        out.append((np.asarray(jax.random.randint(t_rng, (high.shape[0],), 0, 1000)),
                    np.asarray(jax.random.normal(n_rng, high.shape, high.dtype))))
    return out


def jax_activation_draws(batches):
    """``calibrate_activations``' draws (``:311-317``): ``rng, t_rng, n_rng =
    split(rng, 3)`` per batch."""
    rng, out = jax.random.key(0), []
    for batch in batches:
        rng, t_rng, n_rng = jax.random.split(rng, 3)
        high = batch["normal_light"]
        out.append((np.asarray(jax.random.randint(t_rng, (high.shape[0],), 0, 1000)),
                    np.asarray(jax.random.normal(n_rng, high.shape, high.dtype))))
    return out


@pytest.fixture(scope="module")
def case():
    """The tiny model's configs and params, the calibration batches, JAX's
    act_quant model and its calibrated scales, and the port's act_quant
    model calibrated on JAX's draws."""
    jcfg, tcfg, params = random_jax_params("tiny", SIZE, seed=41)
    batches = _batches(2, 42)
    qjmodel, jschedule = jquant.act_quant_model(jcfg)
    jscales = jquant.calibrate_act_scales(qjmodel, jschedule, params, batches)
    qcfg = dataclasses.replace(tcfg, unet=dataclasses.replace(tcfg.unet, act_quant=True))
    model = port_model(qcfg, params)
    schedule = make_schedule(qcfg.scheduler)
    scales = tquant.calibrate_act_scales(model, schedule, batches,
                                         draws=jax_calibration_draws(batches))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, batches=batches,
                qjmodel=qjmodel, jschedule=jschedule,
                jscales=jax.tree_util.tree_map(np.asarray, jscales),
                model=model, schedule=schedule, scales=scales)


def test_calibrated_scales_match_jax(case):
    """Every QConv of the tiny UNet: the statically bound ones at 6.0 and
    every calibrated amax equal to JAX's within SCALE_RTOL (float32 rounding
    of the float work before it, and the quantization flips it causes;
    ``test_calibration_in_float64_equals_jax``); the first, ``init_conv``'s,
    sees the noised input itself and equals JAX's bit for bit."""
    model, tcfg = case["model"], case["tcfg"]
    want = act_scales_from_jax(tcfg, case["jscales"], tquant.qconv_modules(model))
    got = case["scales"]
    assert set(got) == set(want) and len(got) == 71
    bound = [n for n, m in tquant.qconv_modules(model).items() if m.act_bound is not None]
    assert len(bound) == 28 and all(float(got[n]) == 6.0 for n in bound)
    assert float(got["unet.init_conv"]) == float(want["unet.init_conv"])
    for n in got:
        np.testing.assert_allclose(float(got[n]), float(want[n]), rtol=SCALE_RTOL,
                                   atol=0, err_msg=n)
    tquant.assert_calibrated(got)
    assert all(m.amax_positive for m in tquant.qconv_modules(model).values())
    # back to JAX's collection, leaf for leaf
    back = act_scales_to_jax(tcfg, got)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(case["jscales"]))


def test_with_dtype_keeps_act_scales(case):
    """``with_dtype`` carries the calibrated scales, which the state dict
    does not hold, into the bf16-compute model."""
    other = with_dtype(case["model"], "bfloat16")
    got = tquant.act_scales(other)
    assert set(got) == set(case["scales"])
    assert all(torch.equal(got[n], case["scales"][n]) for n in got)
    assert all(m.amax_positive for m in tquant.qconv_modules(other).values())


def test_calibration_in_float64_equals_jax(case, monkeypatch):
    """Both sides in float64 (JAX's float32 casts patched, its batches and
    draws float64): every calibrated amax equal to JAX's to 1e-12, so the
    float32 differences above are float32 rounding and the quantization
    flips it causes, not another function."""
    jcfg, tcfg, params = case["jcfg"], case["tcfg"], case["params"]
    batches = [{k: v.astype(np.float64) for k, v in b.items()} for b in case["batches"]]
    with jax_in_float64(monkeypatch, extra=(jquant, jdiffusion)):
        j64 = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, dtype="float64"))
        qjmodel, jschedule = jquant.act_quant_model(j64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jscales = jquant.calibrate_act_scales(qjmodel, jschedule, p64, batches)
        draws = jax_calibration_draws(batches)
    assert draws[0][1].dtype == np.float64
    qcfg = dataclasses.replace(tcfg, unet=dataclasses.replace(tcfg.unet, act_quant=True))
    model = port_model(qcfg, params).double()
    got = tquant.calibrate_act_scales(model, case["schedule"], batches, draws=draws)
    want = act_scales_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jscales), got)
    for n in got:
        assert got[n].dtype == torch.float64
        np.testing.assert_allclose(float(got[n]), float(want[n]), rtol=1e-12, atol=0,
                                   err_msg=n)


def test_calibrate_activations_matches_jax(case):
    """The static calibration of every module's output: JAX's intermediate
    names key for key (188 in the tiny UNet), each absmax within 2e-3 of
    JAX's (the float model; the float32 GroupNorm of both frameworks is that
    far from exact on random data, ROADMAP queue 3)."""
    batches = case["batches"]
    jmodel, jschedule = jax_create_model(case["jcfg"])
    want = jquant.calibrate_activations(jmodel, jschedule, {"params": case["params"]},
                                        batches)
    model = port_model(case["tcfg"], case["params"])
    got = tquant.calibrate_activations(model, case["schedule"], batches,
                                       draws=jax_activation_draws(batches))
    assert list(got) == sorted(want) and len(got) == 188
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-6, err_msg=k)


def _jax_int8_blocks(ucfg, params, scales, x, t):
    """JAX's int8 UNet on (x, t) with ``scales``: for each top-level block
    its inputs and output."""
    def tap(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and len(context.module.scope.path) == 1:
            context.module.sow("intermediates", "io", (args, out))
        return out

    def f(p, s, xx, tt):
        with nn.intercept_methods(tap):
            return EfficientUNet(ucfg).apply({"params": p, "act_scales": s}, xx, tt,
                                             mutable=["intermediates"])

    _, state = jax.jit(f)(params, scales, jnp.asarray(x), jnp.asarray(t))
    return {k: v["io"][0] for k, v in state["intermediates"].items()}


def _block_errors(unet, ucfg, io):
    """{JAX block: mean |port − JAX| / mean |JAX|} of each port block handed
    JAX's inputs."""
    names, errs = port_block_names(ucfg), {}
    for name, (args, ref) in io.items():
        inputs = []
        for a in map(np.asarray, args):
            if a.dtype == np.bool_:
                continue
            inputs.append(torch.from_numpy(a.copy()) if a.dtype == np.int32 else
                          (nchw(a) if a.ndim == 4 else torch.from_numpy(a.copy())))
        with torch.no_grad():
            got = unet.get_submodule(names[name])(*inputs).float()
        got = nhwc(got) if got.ndim == 4 else got.numpy()
        ref = np.asarray(ref, np.float64)
        errs[name] = float(np.abs(got - ref).mean() / np.abs(ref).mean())
    return errs


def test_int8_unet_block_by_block_on_jax_inputs(case):
    """Each top-level block of the int8 UNet (JAX's calibrated scales loaded
    into the port) handed the inputs JAX's block received gives JAX's
    output within BLOCK_TOL; the float blocks, handed the same inputs, must
    exceed it wherever a quantized convolution runs."""
    jcfg, tcfg, params = case["jcfg"], case["tcfg"], case["params"]
    qj = dataclasses.replace(jcfg.unet, act_quant=True)
    rng = np.random.default_rng(43)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 6)).astype(np.float32)
    t = np.asarray([739, 120], np.int32)
    io = _jax_int8_blocks(qj, params["unet"], case["jscales"]["unet"], x, t)
    model = case["model"]
    tquant.load_act_scales(model, act_scales_from_jax(tcfg, case["jscales"],
                                                      tquant.qconv_modules(model)))
    errs = _block_errors(model.unet, qj, io)
    assert max(errs.values()) <= BLOCK_TOL, errs
    control = _block_errors(port_model(tcfg, params).unet, qj, io)
    quantized = [n for n in control if n not in ("time_mlp", "final_norm")]
    assert all(control[n] > BLOCK_TOL for n in quantized), control


def test_int8_sampler_matches_jax(case, monkeypatch):
    """The 1-step sampler ([739]) of the int8 model on JAX's scales and the
    same explicit noise: the port within SAMPLER_TOL (mean |Δ|) of JAX's;
    the float sampler, the control, beyond it; both in float64 equal to
    1e-9."""
    jcfg, tcfg, params = case["jcfg"], case["tcfg"], case["params"]
    rng = np.random.default_rng(44)
    low = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    init = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    step = rng.standard_normal((1, 2, SIZE, SIZE, 3)).astype(np.float32)
    variables = {"params": params, "act_scales": case["jscales"]}
    ref = np.asarray(jax.jit(lambda v, x, i, s: jax_enhance(
        case["qjmodel"], case["jschedule"], v, jax.random.key(0), x, init_noise=i,
        step_noise=s, timesteps=[739]))(variables, low, init, step))
    model = case["model"]
    tquant.load_act_scales(model, act_scales_from_jax(tcfg, case["jscales"],
                                                      tquant.qconv_modules(model)))

    def port(m):
        with torch.no_grad():
            return run_sampler(m, case["schedule"], torch.from_numpy(low),
                               torch.from_numpy(init), torch.from_numpy(step),
                               [739]).numpy()
    err = float(np.abs(port(model) - ref).mean())
    control = float(np.abs(port(port_model(tcfg, params)) - ref).mean())
    assert err <= SAMPLER_TOL < control, (err, control)

    with jax_in_float64(monkeypatch, extra=(jquant, jdiffusion)):
        j64 = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, dtype="float64"))
        qjmodel, jschedule = jquant.act_quant_model(j64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ref64 = np.asarray(jax.jit(lambda v, x, i, s: jax_enhance(
            qjmodel, jschedule, v, jax.random.key(0), x, init_noise=i, step_noise=s,
            timesteps=[739]))(v64, low.astype(np.float64), init.astype(np.float64),
                              step.astype(np.float64)))
    model64 = port_model(dataclasses.replace(tcfg, unet=dataclasses.replace(
        tcfg.unet, act_quant=True)), params).double()
    tquant.load_act_scales(model64, act_scales_from_jax(
        tcfg, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), case["jscales"]),
        tquant.qconv_modules(model64)))
    with torch.no_grad():
        got64 = run_sampler(model64, case["schedule"], torch.from_numpy(low).double(),
                            torch.from_numpy(init).double(),
                            torch.from_numpy(step).double(), [739]).numpy()
    assert ref64.dtype == got64.dtype == np.float64
    np.testing.assert_allclose(got64, ref64, rtol=0, atol=1e-9)


def test_int8_act_package_round_trip(case, tmp_path):
    """An int8_act package: bf16 weights (loaded back as their float32
    upcast), the scales as calibrated, ``model_config.json`` equal to JAX's
    for the same package but ``framework`` (``unet.act_quant: true``), an
    int8-compute model; with ``use_pallas_irb`` no IRB takes the fused
    route and the sampler's output is the unfused one's."""
    tcfg, model = case["tcfg"], case["model"]
    float_model = port_model(tcfg, case["params"])
    files = create_serving_package(str(tmp_path / "port"), float_model, case["schedule"],
                                   quantize="int8_act", act_scales=case["scales"],
                                   timesteps=[739])
    assert set(files) == {"act_scales", "params", "config", "schedule"}
    jmodel, jschedule = jax_create_model(case["jcfg"])
    jax_create_serving_package(str(tmp_path / "jax"), jmodel, jschedule, case["params"],
                               quantize="int8_act", act_scales=case["jscales"],
                               timesteps=[739])
    with open(tmp_path / "jax" / "model_config.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "model_config.json") as f:
        got = json.load(f)
    assert want.pop("framework") != got.pop("framework")
    assert got == want and got["quantization"] == "int8_act"
    outs = []
    for fused in (False, True):
        loaded, _, state, meta = load_serving_package(str(tmp_path / "port"), "cpu",
                                                      use_pallas_irb=fused)
        assert loaded.config.unet.act_quant is True
        assert loaded.config.unet.use_pallas_irb == fused
        assert not any(getattr(m, "use_pallas_irb", False) for m in loaded.modules())
        for k, t in float_model.state_dict().items():
            assert torch.equal(state[k], t.to(torch.bfloat16).float()), k
        assert {k: float(v) for k, v in tquant.act_scales(loaded).items()} == \
            {k: float(v) for k, v in case["scales"].items()}
        pipe = ServingPipeline.from_package(str(tmp_path / "port"), device="cpu",
                                            use_pallas_irb=fused)
        img = np.random.default_rng(45).integers(0, 256, (20, 28, 3), dtype=np.uint8)
        outs.append(pipe(img, seed=0))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_int8_act_package_refuses_uncalibrated_scales(case, tmp_path):
    model = port_model(case["tcfg"], case["params"])
    with pytest.raises(ValueError, match="calibrated act_scales"):
        create_serving_package(str(tmp_path), model, case["schedule"], quantize="int8_act")
    bad = dict(case["scales"])
    bad["unet.final_conv"] = torch.tensor(0.0)
    with pytest.raises(ValueError, match="unet.final_conv"):
        create_serving_package(str(tmp_path), model, case["schedule"],
                               quantize="int8_act", act_scales=bad)


def test_export_cli_int8_act(case, tmp_path):
    """``python -m cv_diffusion_tpu_torch.export --quantize int8_act
    --calib_dir``: calibrates on the directory's pairs, writes the package,
    which serves; ``--graph`` and int8_act without ``--calib_dir`` are
    refused; ``--help`` names ``--use_ema``'s choice."""
    from cv_diffusion_tpu_torch.config import to_json
    from cv_diffusion_tpu_torch.data import png
    from cv_diffusion_tpu_torch.export import __main__ as cli
    from cv_diffusion_tpu_torch.training.checkpoint import save_params

    rng = np.random.default_rng(46)
    for i in range(8):
        for sub in ("low", "high"):
            png.write_png(tmp_path / "lol" / sub / f"{i}.png",
                          rng.integers(0, 256, (36, 40, 3), dtype=np.uint8))
    save_params(str(tmp_path / "ckpt"), port_model(case["tcfg"], case["params"]).state_dict(),
                to_json(case["tcfg"]))
    out = tmp_path / "pkg"
    cli.main(["--checkpoint", str(tmp_path / "ckpt"), "--output", str(out),
              "--variant", "tiny", "--image_size", str(SIZE), "--quantize", "int8_act",
              "--calib_dir", str(tmp_path / "lol"), "--calib_batches", "1",
              "--timesteps", "739", "--device", "cpu"])
    with open(out / "model_config.json") as f:
        meta = json.load(f)
    assert meta["quantization"] == "int8_act" and meta["timesteps"] == [739]
    assert meta["model"]["scheduler"]["prediction_type"] == "v_prediction"
    pipe = ServingPipeline.from_package(str(out), device="cpu")
    img = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
    assert pipe(img, seed=0).shape == img.shape
    with pytest.raises(NotImplementedError, match="StableHLO"):
        cli.main(["--checkpoint", str(tmp_path / "ckpt"), "--graph", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--checkpoint", str(tmp_path / "ckpt"), "--quantize", "int8_act"])
    proc = subprocess.run([sys.executable, "-m", "cv_diffusion_tpu_torch.export", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "raw parameters" in proc.stdout


def test_benchmark_quantized_model_keys(case):
    """``benchmark_quantized_model`` (JAX ``quantization.py:334``): per codec
    the JAX function's keys, the int8 entry marked as dequantized weights
    (not int8 compute), the speed-ups anchored to fp32, and the model's own
    weights left as they were."""
    model = port_model(case["tcfg"], case["params"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    res = tquant.benchmark_quantized_model(model, case["schedule"], batch_size=1,
                                           num_runs=1, num_inference_steps=1)
    assert list(res) == ["fp32", "bf16", "int8"]
    for r in res.values():
        assert set(r) == {"mean_ms", "std_ms", "min_ms", "max_ms", "p50_ms", "size_mb",
                          "compression", "compute_path", "img_per_sec", "speedup_vs_fp32"}
    assert res["int8"]["compute_path"] == "dequantized-weights"
    assert res["fp32"]["speedup_vs_fp32"] == 1.0 and res["int8"]["compression"] > 3
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
