from .cdf import CdfTable, build_cdf_table, pmf_to_quantized_cdf
from .entropy_bottleneck import EntropyBottleneck, eb_params_from_variables, eb_update
from .gaussian_conditional import (
    SCALES_LEVELS,
    GaussianConditional,
    SCALES_MAX,
    SCALES_MIN,
    build_indexes,
    gc_update,
    get_scale_table,
)
from .ops import compute_padding, dequantize, lower_bound, quantize, quantize_ste

__all__ = [
    "CdfTable",
    "build_cdf_table",
    "pmf_to_quantized_cdf",
    "EntropyBottleneck",
    "eb_params_from_variables",
    "eb_update",
    "GaussianConditional",
    "SCALES_LEVELS",
    "SCALES_MAX",
    "SCALES_MIN",
    "build_indexes",
    "gc_update",
    "get_scale_table",
    "compute_padding",
    "dequantize",
    "lower_bound",
    "quantize",
    "quantize_ste",
]
