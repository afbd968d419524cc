"""End-to-end uint8 → uint8 serving, and serving packages.

Counterpart of ``cv_diffusion_tpu/export/serving.py``.
:class:`ServingPipeline`: pre-process (letterbox to S×S), normalise ``u8 /
127.5 − 1``, the LCM sampler, ``clip(x·127.5 + 127.5, 0, 255)`` cast to
uint8 by truncation, post-process back to the input's size. Everything from
the canvas on runs on the device. As in the JAX package's
``load_serving_package``, serving routes linear attention through the
hand-written kernel.

On a CUDA device the sampler, from the uint8 canvas in to the uint8 canvas
out, is one CUDA graph per batch size (:class:`SamplerGraph`), captured at
the first request of that size and replayed after: the port's counterpart
of the JAX package's one jitted ``u8_fn`` (``serving.py:353-363``). A
failed capture raises; nothing falls back to running the sampler op by op.
On the CPU the sampler runs eagerly. :meth:`ServingPipeline.batch` keeps
``MAX_IN_FLIGHT`` chunks on the device ahead of the host's fetch, as JAX
does, and :meth:`ServingPipeline.benchmark` times the stages.

Serving packages (:func:`create_serving_package`,
:func:`load_serving_package`, :meth:`ServingPipeline.from_package`) hold
``model_config.json`` in the JAX package's schema, ``noise_schedule.npz``,
and the params in the port's weights format (``params.npz``), as float32,
bfloat16 or int8 with float32 scales (``export/quantization.py``); bf16
and int8 are brought back to float32 at load. An ``int8_act`` package
holds bf16 weights and the calibrated activation scales
(``act_scales.npz``), and is served by the int8-compute model
(``unet.act_quant: true``): every convolution through the hand-written int8
kernels, replayed from the CUDA graph as any other path. :meth:`ServingPipeline.
from_artifact` serves a committed artifact on its own weights (the fp32 path
of ``load_serving_package``). Every pipeline computes in its model config's
``unet.dtype`` (JAX ``serving.py:292-294``): a package or config that says
``"bfloat16"`` is served in bf16 compute on float32 weights, through both
kernels' bf16 entries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import (DiffusionConfig, from_dict, load_model_config,
                      load_timesteps, to_json)
from ..device import pin_fp32, resolve_device
from ..models.diffusion import (LowLightDiffusion, create_model, enhance,
                                sampler_noise)
from ..models.scheduler import LCMSchedule, lcm_timesteps
from ..ops import (flash_attention_kernel, fused_irb_kernel,
                   linear_attention_kernel, qconv_kernel)
from ..weights import load_state_dict_npz, save_state_dict_npz
from .preprocess import PostProcessor, PreprocessMeta, PreProcessor
from .quantization import (assert_calibrated, dequantize_int8, load_act_scales,
                           quantize_model)

# the repository's root: ``artifacts/<name>/`` holds an artifact's JSON
# files, ``artifacts_torch/<name>.npz`` its weights in the port's format
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAMEWORK = "cv_diffusion_tpu_torch"
# sampler runs on a side stream before a capture: they build and load the
# kernel libraries, let cuDNN choose its algorithms and warm the allocator
GRAPH_WARMUP = 3


@dataclass
class ServingConfig:
    """Serving settings (the JAX ``ServingConfig`` without its XLA-only
    fields, and without ``dtype``, which nothing in the JAX package reads:
    a pipeline computes in its model config's ``unet.dtype``)."""

    image_size: int = 256
    num_inference_steps: int = 4
    batch_size: int = 1
    keep_aspect: bool = True
    seed: int = 0
    # renoise-free DDIM-style steps instead of the stochastic LCM step
    deterministic: bool = False
    # explicit descending grid (a distilled student's own, e.g. (739,));
    # None = the stock lcm_timesteps grid of num_inference_steps
    timesteps: Optional[tuple] = None


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' wrappers' launch counts, by kernel."""
    return {"linear_attention": linear_attention_kernel.linear_attention_kernel.launches,
            "flash_attention_fwd": flash_attention_kernel.flash_attention_forward.launches,
            "flash_attention_bwd_dkv":
                flash_attention_kernel.flash_attention_backward_dkv.launches,
            "flash_attention_bwd_dq":
                flash_attention_kernel.flash_attention_backward_dq.launches,
            "fused_irb_v2": fused_irb_kernel.fused_irb_v2.launches,
            "fused_irb_v1": fused_irb_kernel.fused_irb_v1.launches,
            "qconv_quantize": qconv_kernel.quantize.launches,
            "qconv_quantize_weight": qconv_kernel.quantize_weight.launches,
            "qconv_dense": qconv_kernel.int8_conv.launches,
            "qconv_depthwise": qconv_kernel.int8_depthwise.launches}


class SamplerGraph:
    """The uint8 → uint8 sampler at one batch size, captured as a CUDA graph.

    It owns the static buffers: the canvas, ``init_noise``, ``step_noise``
    and the output. Before the capture the sampler runs ``GRAPH_WARMUP``
    times on a side stream (PyTorch's recipe), so that every kernel library
    is built and loaded and cuDNN has chosen its algorithms; the capture
    records the kernels' launches on the capture stream. A call copies the
    canvas in, fills the noise from the request's generator with
    :func:`~..models.diffusion.sampler_noise` (the order and shapes in which
    eager ``enhance`` draws it) and replays; it returns the static output,
    which the next replay of any graph of the same pool overwrites.
    """

    @torch.inference_mode()
    def __init__(self, sample: Callable, batch: int, size: int, steps: int,
                 device: torch.device, pool, in_dtype=torch.uint8):
        start = time.perf_counter()
        self.canvas = torch.zeros((batch, size, size, 3), dtype=in_dtype,
                                  device=device)
        self.noise = (torch.zeros((batch, size, size, 3), device=device),
                      torch.zeros((steps, batch, size, size, 3), device=device))
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                sample(self.canvas, *self.noise)
        torch.cuda.current_stream(device).wait_stream(side)
        before = kernel_launches()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = sample(self.canvas, *self.noise)
        after = kernel_launches()
        # the hand-written kernels' launches inside one replay
        self.launches = {k: after[k] - before[k] for k in after}
        self.replays = 0
        self.seconds = time.perf_counter() - start   # warm-up and capture

    @torch.inference_mode()
    def __call__(self, canvas_u8: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        self.canvas.copy_(canvas_u8)
        sampler_noise(generator, self.canvas.shape, self.noise[1].shape[0],
                      self.canvas.device, out=self.noise)
        return self._replay()

    @torch.inference_mode()
    def replay(self, canvas: torch.Tensor, init_noise: torch.Tensor,
               step_noise: torch.Tensor) -> torch.Tensor:
        """A replay on explicit noise (the data-parallel sampler's rows of
        the global batch's noise)."""
        self.canvas.copy_(canvas)
        for buf, t in zip(self.noise, (init_noise, step_noise)):
            buf.copy_(t)
        return self._replay()

    def _replay(self) -> torch.Tensor:
        self.graph.replay()
        self.replays += 1
        return self.out


class ServingPipeline:
    """uint8 HWC image(s) in, uint8 HWC image(s) of the same size out."""

    # chunks kept on the device ahead of the host's fetch (the JAX
    # package's window, serving.py:411-416): the device samples chunks N+1
    # and N+2 while the host fetches chunk N, and at most MAX_IN_FLIGHT + 1
    # chunk outputs are held on the device
    MAX_IN_FLIGHT = 2

    def __init__(self, model: LowLightDiffusion, schedule: LCMSchedule,
                 config: Optional[ServingConfig] = None, *, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            pin_fp32()
        self.config = config or ServingConfig(image_size=model.config.image_size)
        self.model = model.to(self.device).eval()
        self.schedule = schedule.to(self.device)
        self.pre = PreProcessor(self.config.image_size, self.config.keep_aspect,
                                self.device)
        self.post = PostProcessor()
        cfg = self.config
        self.grid = (list(cfg.timesteps) if cfg.timesteps else lcm_timesteps(
            cfg.num_inference_steps, schedule.config.num_train_timesteps,
            schedule.config.original_inference_steps))
        # one graph per batch size, all in one memory pool (CUDA only)
        self.graphs: Dict[int, SamplerGraph] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._counter = 0

    @classmethod
    def from_config(cls, model_config_path: str, timesteps_path: str,
                    weights: Dict[str, torch.Tensor], device="cuda", *,
                    variant: Optional[str] = None,
                    image_size: Optional[int] = None,
                    **serving_overrides) -> "ServingPipeline":
        """A pipeline for an artifact's ``model_config.json`` and
        ``student_timesteps.json``, with ``weights`` (a state dict, e.g. from
        ``weights.init_weights`` or ``weights.state_dict_from_jax``) loaded
        with ``strict=True``. ``variant``/``image_size`` override the file's
        UNet widths and resolution; other keywords set ServingConfig
        fields."""
        cfg = load_model_config(model_config_path, variant, image_size)
        return cls._build(cfg, load_timesteps(timesteps_path), weights, device,
                          serving_overrides)

    @classmethod
    def from_artifact(cls, name: str, device="cuda", *,
                      use_pallas_irb: bool = False,
                      **serving_overrides) -> "ServingPipeline":
        """The committed artifact ``name`` on its own weights: the model
        and grid from ``artifacts/<name>/``'s ``model_config.json`` and
        ``student_timesteps.json``, the weights from
        ``artifacts_torch/<name>.npz`` (``weights.load_state_dict_npz``) of
        this repository. ``use_pallas_irb`` routes
        every stride-1 IRB through the fused kernel; other keywords set
        ServingConfig fields. Raises ``FileNotFoundError`` for an artifact
        whose weights file is not in the tree."""
        path = os.path.join(REPO_ROOT, "artifacts", name)
        npz = os.path.join(REPO_ROOT, "artifacts_torch", f"{name}.npz")
        if not os.path.isfile(npz):
            raise FileNotFoundError(
                f"{npz}: artifact {name!r} has no weights file in the port's "
                "format in this tree (only vreg1b_gt03_ema fits the copy "
                "limit; ROADMAP queue 1 item 1)")
        cfg = load_model_config(os.path.join(path, "model_config.json"))
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_pallas_irb=use_pallas_irb))
        grid = load_timesteps(os.path.join(path, "student_timesteps.json"))
        return cls._build(cfg, grid, load_state_dict_npz(npz, device), device,
                          serving_overrides)

    @classmethod
    def from_package(cls, package_dir: str,
                     config: Optional[ServingConfig] = None, device="cuda",
                     use_pallas_irb: bool = False,
                     **overrides) -> "ServingPipeline":
        """A pipeline for a serving package (JAX ``serving.py:366-392``).

        Without an explicit ``config``, the ServingConfig takes the
        package's recorded image size, step count, grid and
        ``deterministic`` (``model_config.json``); keyword ``overrides``
        replace single fields, and None overrides are ignored.
        ``use_pallas_irb`` routes every stride-1 IRB through the fused
        kernel."""
        model, schedule, _, meta = load_serving_package(
            package_dir, device, use_pallas_irb=use_pallas_irb)
        if config is None:
            meta_ts = meta.get("timesteps")
            fields = dict(
                image_size=model.config.image_size,
                num_inference_steps=meta.get("num_inference_steps", 4),
                deterministic=meta.get("deterministic", False),
                timesteps=tuple(meta_ts) if meta_ts else None)
            fields.update({k: v for k, v in overrides.items() if v is not None})
            config = ServingConfig(**fields)
        return cls(model, schedule, config, device=device)

    @classmethod
    def _build(cls, cfg, grid, weights, device, serving_overrides):
        model, schedule = create_model(cfg, device=device)
        model.load_state_dict(weights, strict=True)
        config = ServingConfig(image_size=cfg.image_size,
                               num_inference_steps=len(grid), timesteps=grid,
                               **serving_overrides)
        return cls(model, schedule, config, device=device)

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        """Explicit seed → the same output for the same input; no seed →
        config.seed advanced by a per-call counter."""
        if seed is None:
            seed = self.config.seed + self._counter
            self._counter += 1
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, canvas_u8: torch.Tensor, init_noise: torch.Tensor,
                step_noise: torch.Tensor) -> torch.Tensor:
        """uint8 [B, S, S, 3] → uint8 [B, S, S, 3] on explicit noise: what a
        :class:`SamplerGraph` captures."""
        low = canvas_u8.float() / 127.5 - 1.0
        out = enhance(self.model, self.schedule, low, timesteps=self.grid,
                      init_noise=init_noise, step_noise=step_noise,
                      deterministic=self.config.deterministic,
                      device=self.device).float()
        return (out * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)

    @torch.inference_mode()
    def run_eager(self, canvas_u8: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
        """The sampler op by op, its noise drawn from ``generator`` as a
        graph's replay draws it: how the CPU serves, and what the graph is
        held against on a CUDA device."""
        noise = sampler_noise(generator, canvas_u8.shape, len(self.grid),
                              self.device)
        return self._sample(canvas_u8, *noise)

    def graph(self, batch: int) -> SamplerGraph:
        """The CUDA graph of the sampler at ``batch``, captured at its first
        use."""
        if batch not in self.graphs:
            self.graphs[batch] = SamplerGraph(
                self._sample, batch, self.config.image_size, len(self.grid),
                self.device, self._pool)
        return self.graphs[batch]

    @torch.inference_mode()
    def _run(self, canvas_u8: torch.Tensor, generator: torch.Generator,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 [B, S, S, 3] → uint8 [B, S, S, 3], on the device: a replay
        of the batch size's graph on a CUDA device, the eager sampler on the
        CPU. The result is written to ``out`` (or a new tensor) in stream
        order, so no later replay overwrites it."""
        if self.device.type == "cuda":
            res = self.graph(canvas_u8.shape[0])(canvas_u8, generator)
        else:
            res = self.run_eager(canvas_u8, generator)
        return (torch.empty_like(res) if out is None else out).copy_(res)

    @torch.inference_mode()
    def __call__(self, image_u8: np.ndarray,
                 seed: Optional[int] = None) -> np.ndarray:
        """Enhance one uint8 HWC image."""
        canvas, meta = self.pre(image_u8)
        out = self._run(canvas, self._generator(seed))
        return self.post(out[0], meta)

    def _fetch_async(self, out: torch.Tensor, metas: Sequence[PreprocessMeta]):
        """Queue a chunk's post-processing and its copies to the host
        (pinned memory) behind it on the stream; returns what
        :meth:`_fetch` completes."""
        cuda = self.device.type == "cuda"
        host = [self.post.on_device(out[i], meta).to("cpu", non_blocking=cuda)
                for i, meta in enumerate(metas)]
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        return host, done

    def _fetch(self, pending) -> List[np.ndarray]:
        """Wait for one chunk's copies to the host; its images."""
        host, done = pending
        if done is not None:
            done.synchronize()
        return [t.numpy() for t in host]

    @torch.inference_mode()
    def batch(self, images: Sequence[np.ndarray],
              seed: Optional[int] = None) -> List[np.ndarray]:
        """Enhance a list of uint8 HWC images in device batches of
        ``config.batch_size`` (the last one padded with black canvases, one
        graph for any list length); with a seed, chunk i uses ``seed + i``.
        Up to ``MAX_IN_FLIGHT`` chunks are on the device ahead of the fetch,
        as in the JAX package (``serving.py:418-456``): each chunk's output
        is copied into a ring of ``MAX_IN_FLIGHT + 1`` buffers before the
        next replay, and its post-processing and copies to the host are
        queued behind it; a chunk is fetched only when the window is full.
        Outputs keep input order."""
        bs = max(1, self.config.batch_size)
        ring: List[torch.Tensor] = []
        in_flight: list = []
        outs: List[np.ndarray] = []
        for chunk_idx, start in enumerate(range(0, len(images), bs)):
            pre = [self.pre(img) for img in images[start:start + bs]]
            x = torch.cat([canvas for canvas, _ in pre])
            if x.shape[0] < bs:
                x = torch.cat([x, x.new_zeros((bs - x.shape[0],) + x.shape[1:])])
            slot = chunk_idx % (self.MAX_IN_FLIGHT + 1)
            if slot == len(ring):
                ring.append(torch.empty_like(x))
            out = self._run(x, self._generator(
                None if seed is None else seed + chunk_idx), out=ring[slot])
            in_flight.append(self._fetch_async(out, [meta for _, meta in pre]))
            while len(in_flight) > self.MAX_IN_FLIGHT:
                outs.extend(self._fetch(in_flight.pop(0)))   # chunk N - k
        while in_flight:
            outs.extend(self._fetch(in_flight.pop(0)))
        return outs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark(self, num_runs: int = 20, warmup: int = 3) -> Dict[str, float]:
        """Per-stage latency (JAX ``serving.py:458-497``): one 480×640 image
        from ``np.random.default_rng(0)``, run i seeded ``i``; pre-process,
        device (ending at a synchronise on CUDA) and post-process times and
        their totals, in ms, with the JAX package's keys."""
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
        for _ in range(warmup):
            self(img)
        pre_t, dev_t, post_t, tot_t = [], [], [], []
        for i in range(num_runs):
            t0 = time.perf_counter()
            x, meta = self.pre(img)
            self._sync()
            t1 = time.perf_counter()
            out = self._run(x, self._generator(i))
            self._sync()
            t2 = time.perf_counter()
            self.post(out[0], meta)
            t3 = time.perf_counter()
            pre_t.append(t1 - t0)
            dev_t.append(t2 - t1)
            post_t.append(t3 - t2)
            tot_t.append(t3 - t0)
        arr = np.asarray(tot_t) * 1000
        return {
            "mean_ms": float(arr.mean()),
            "std_ms": float(arr.std()),
            "min_ms": float(arr.min()),
            "max_ms": float(arr.max()),
            "p50_ms": float(np.percentile(arr, 50)),
            "preprocess_ms": float(np.mean(pre_t) * 1000),
            "inference_ms": float(np.mean(dev_t) * 1000),
            "per_step_ms": float(np.mean(dev_t) * 1000 /
                                 self.config.num_inference_steps),
            "postprocess_ms": float(np.mean(post_t) * 1000),
            "fps": float(1000.0 / arr.mean()),
        }


def make_sample_fn(model: LowLightDiffusion, schedule: LCMSchedule,
                   num_inference_steps: int, deterministic: bool = False,
                   timesteps: Optional[Sequence[int]] = None) -> Callable:
    """``fn(params_or_variables, generator, low_light) → enhanced`` (JAX
    ``make_sample_fn``, ``serving.py:72``): the sampler of ``model`` on
    ``low_light`` [B, H, W, 3] in [-1, 1], its noise drawn from
    ``generator`` (``diffusion.sampler_noise``), the output float32.
    ``params_or_variables`` is a bare state dict, used in place of the
    module's parameters for the call, or ``{"params": ..., "act_scales":
    ...}`` (an ``int8_act`` package's), whose scales are loaded into the
    model's QConvs. ``deterministic`` takes renoise-free steps;
    ``timesteps`` replaces the stock grid."""
    def fn(params, generator, low_light):
        variables = params if "params" in params else {"params": params}
        if "act_scales" in variables:
            load_act_scales(model, variables["act_scales"])
        out = enhance(model, schedule, low_light,
                      num_inference_steps=num_inference_steps,
                      timesteps=timesteps, deterministic=deterministic,
                      generator=generator, params=variables["params"],
                      device=next(model.parameters()).device)
        return out.float()

    return fn


# a package's int8 params: the quantized dict flattened under these prefixes
_INT8_PARTS = ("values", "scales", "quantized")


def create_serving_package(output_dir: str, model: LowLightDiffusion,
                           schedule: LCMSchedule,
                           num_inference_steps: int = 4,
                           quantize: str = "none",
                           include_graph: bool = False,
                           batch_size: int = 1,
                           act_scales: Optional[Dict[str, torch.Tensor]] = None,
                           dynamic_batch: bool = False,
                           deterministic: bool = False,
                           timesteps: Optional[Sequence[int]] = None
                           ) -> Dict[str, str]:
    """Write a serving package of ``model``'s weights (JAX
    ``create_serving_package``, ``serving.py:159``):

      params.npz           the weights in the port's format, as the codec
                           ``quantize`` gives them (``none``/``fp32``,
                           ``bf16``, ``int8``: values, scales and mask;
                           ``int8_act``: bf16)
      act_scales.npz       (``int8_act``) the calibrated activation scales,
                           ``{QConv name: amax}`` (``export.quantization.
                           calibrate_act_scales``), in the same format
      model_config.json    the JAX package's schema; ``framework`` is
                           ``cv_diffusion_tpu_torch``; an ``int8_act``
                           package's model has ``unet.act_quant: true``
      noise_schedule.npz   ᾱ and the timestep grid

    ``int8_act`` raises ``ValueError`` without ``act_scales`` or with an
    amax ≤ 0 (JAX ``:190-196``). Raises ``NotImplementedError`` for
    ``include_graph``. Returns the files written, by role."""
    if include_graph:
        raise NotImplementedError(
            "include_graph: the JAX package's StableHLO sampler has no "
            "PyTorch counterpart; on a CUDA device ServingPipeline captures "
            "the sampler as a CUDA graph when it serves")
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    state = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    model_cfg = model.config
    files = {}
    if quantize == "int8_act":
        if act_scales is None:
            raise ValueError(
                "int8_act packages need calibrated act_scales "
                "(export.quantization.calibrate_act_scales)")
        assert_calibrated(act_scales)
        qparams, codec = quantize_model(state, model.config, "bf16")
        codec = "int8_act"
        model_cfg = dataclasses.replace(model.config, unet=dataclasses.replace(
            model.config.unet, act_quant=True))
        files["act_scales"] = str(out / "act_scales.npz")
        save_state_dict_npz({k: torch.as_tensor(v).detach().float().cpu().reshape(())
                             for k, v in act_scales.items()},
                            files["act_scales"], source="serving package, act_scales")
    else:
        qparams, codec = quantize_model(state, model.config, quantize)
    if codec == "int8":
        qparams = {f"{part}/{k}": torch.tensor(v) if part == "quantized" else v
                   for part in _INT8_PARTS for k, v in qparams[part].items()}
    files["params"] = str(out / "params.npz")
    save_state_dict_npz(qparams, files["params"], source=f"serving package, {codec}")

    if timesteps is not None:
        timesteps = [int(t) for t in timesteps]
        num_inference_steps = len(timesteps)
    cfg = {
        "model": json.loads(to_json(model_cfg)),
        "num_inference_steps": num_inference_steps,
        "quantization": codec,
        "input": ["dynamic" if dynamic_batch else batch_size,
                  model.config.image_size, model.config.image_size, 3],
        "deterministic": deterministic,
        "timesteps": timesteps,
        "framework": FRAMEWORK,
    }
    files["config"] = str(out / "model_config.json")
    with open(files["config"], "w") as f:
        json.dump(cfg, f, indent=2)

    ts = (timesteps if timesteps is not None
          else lcm_timesteps(num_inference_steps,
                             schedule.config.num_train_timesteps,
                             schedule.config.original_inference_steps))
    files["schedule"] = str(out / "noise_schedule.npz")
    np.savez(files["schedule"],
             alphas_cumprod=schedule.alphas_cumprod.cpu().numpy(),
             timesteps=np.asarray(ts, dtype=np.int32))
    return files


def load_serving_package(package_dir: str, device="cuda",
                         use_pallas_irb: Optional[bool] = None
                         ) -> Tuple[LowLightDiffusion, LCMSchedule,
                                    Dict[str, torch.Tensor], Dict]:
    """(model, schedule, state_dict, package config) from a package (JAX
    ``load_serving_package``, ``serving.py:266``), on ``device``. int8
    params are dequantized to float32 (JAX ``:303-306``), bf16 ones upcast
    to float32: JAX's float32 model computes with its bf16 params in float32
    too. An ``int8_act`` package's model is the int8-compute one its config
    records, with its bf16 weights upcast the same way and its activation
    scales loaded (``export.quantization.load_act_scales``).
    ``use_pallas_irb`` (None: as recorded) sets the fused-IRB route, which
    the int8-compute model does not take (as in JAX)."""
    pkg = Path(package_dir)
    with open(pkg / "model_config.json") as f:
        cfg = json.load(f)
    model_cfg = from_dict(DiffusionConfig, cfg["model"])
    if use_pallas_irb is not None:
        model_cfg = dataclasses.replace(model_cfg, unet=dataclasses.replace(
            model_cfg.unet, use_pallas_irb=use_pallas_irb))
    codec = cfg.get("quantization", "fp32")
    tensors = load_state_dict_npz(str(pkg / "params.npz"), device)
    if codec == "int8":
        parts = {p: {} for p in _INT8_PARTS}
        for key, t in tensors.items():
            part, name = key.split("/", 1)
            parts[part][name] = bool(t) if part == "quantized" else t
        state = dequantize_int8(parts)
    elif codec in ("bf16", "fp32", "int8_act"):
        state = {k: t.float() for k, t in tensors.items()}
    else:
        raise ValueError(f"{package_dir}: unknown codec {codec!r}")
    model, schedule = create_model(model_cfg, device=device)
    model.load_state_dict(state, strict=True)
    if codec == "int8_act":
        load_act_scales(model, load_state_dict_npz(str(pkg / "act_scales.npz"), device))
    return model, schedule, state, cfg
