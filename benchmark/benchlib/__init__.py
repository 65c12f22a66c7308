"""The benchmark's own code: the harness, the traffic generators (``jobs``),
the seeded weights and fields, the entropy fit, the FLOP counter, the
table of peaks, the trace reduction and the judges that decide
``correct``. It imports the program under test only inside the jobs, and
never ``jax`` or the JAX package.
"""
