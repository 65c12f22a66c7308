"""The benchmark's plain reference: the VAEformer codec and its training
step in plain PyTorch and NumPy, float32 with TF32 off.

Nothing here imports ``jax``, the JAX package or the PyTorch port. The
reference takes the benchmark's inputs (weights made from the seed, the
fitted entropy parameters, the fields) and works out again everything the
program derives from them: the CDF tables, the latents, symbols and
indexes, the reconstruction, the loss, the gradients and the update. It
reads the program's outputs (streams, reconstructions, losses, optimizer
state) only to judge them.

``lowp.Precision`` rounds the operands of every matrix product: "fp32"
leaves them, "tf32" and "fp8" are the controls, the reference computed one
precision below what the configuration states.
"""
