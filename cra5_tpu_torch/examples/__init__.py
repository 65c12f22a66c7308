"""Runnable walkthroughs of the port, one module per script of the JAX
package's ``examples/``, under the same names:

    python -m cra5_tpu_torch.examples.quickstart --device cpu --tiny
    python -m cra5_tpu_torch.examples.train_demo_268      # on the card

``quickstart`` (the ``cra5_api`` flow), ``test_model`` (a zoo model and a
VAEformer roundtrip), ``roundtrip_timing`` (encode/decode seconds through
``cra5_api``), ``train_268v_smoke`` (the 268v remat training step),
``train_demo_268`` (268v training with a mid-run checkpoint, a resume into
a fresh ``Trainer`` and the CDF tables rebuilt from the trained entropy
model), ``train_demo_report`` (its result JSON as Markdown) and
``profile_268_train`` (``remat=True`` against ``remat="dots"``). Each has
``main(argv=None)``. Every one runs on the card unless given ``--device
cpu``, and raises without a card.
"""

from __future__ import annotations

import torch


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu")


def sync(device: torch.device) -> None:
    """Wait for the device's queued work, so a host clock read after it
    includes that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
