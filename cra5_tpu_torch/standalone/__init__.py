"""The standalone C++ codec: artifact export and the binary's build and run
(counterpart of ``cra5_tpu/standalone``)."""

from .export import (
    build_codec_binary,
    export_analysis,
    export_codec,
    export_synthesis,
    extract_cdf_from_latents,
    load_tables_file,
    read_tensor_file,
    run_codec,
    write_tables_file,
    write_tensor_file,
)

__all__ = [
    "build_codec_binary",
    "export_codec",
    "export_analysis",
    "export_synthesis",
    "extract_cdf_from_latents",
    "load_tables_file",
    "read_tensor_file",
    "run_codec",
    "write_tables_file",
    "write_tensor_file",
]
