"""Serving: pre/post-processing, the uint8 pipeline, serving packages,
quantization (weight codecs, int8 activation compute and its calibration)
and QAT: the JAX package's ``export`` names that have a PyTorch
counterpart (its StableHLO export and XLA compilation cache have none)."""
from .preprocess import PreProcessor, PostProcessor, PreprocessMeta
from .quantization import (QuantizationConfig, quantize_model, quantize_bf16,
                           quantize_int8, dequantize_int8,
                           quantization_report, quantization_error)
from .serving import (ServingConfig, ServingPipeline,
                      create_serving_package, load_serving_package)
from .quantization import calibrate_activations, benchmark_quantized_model
from .qat import fake_quant_params, fake_quant_tensor, make_qat_train_step
