"""Command-line tools of the port (counterpart of ``cra5_tpu/tools``)."""
