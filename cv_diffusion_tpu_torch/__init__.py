"""PyTorch/CUDA port of ``cv_diffusion_tpu`` for one NVIDIA H100.

Imports torch and numpy only, never JAX or the JAX package. Entry points:
``export.serving.ServingPipeline``, ``models.diffusion.create_model`` and
``models.diffusion.enhance``; they run on CUDA unless given ``device="cpu"``.
The hand-written kernels live in ``csrc/`` and are built with ``nvcc`` at
first use.
"""
