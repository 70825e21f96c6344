"""repro_torch — the PyTorch/CUDA port of the TensorGalerkin system.

A second package beside the JAX reference ``repro``, with its layout and
names: ``repro_torch.core`` (meshes, assembly, sparse containers, solvers),
``repro_torch.kernels`` (hand-written CUDA kernels for Hopper with plain
PyTorch versions), ``repro_torch.fem`` (problem classes),
``repro_torch.transient`` (θ-method and Newmark rollouts) and
``repro_torch.telemetry``.  It imports neither JAX nor ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
