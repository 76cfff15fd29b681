"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100.

The JAX package ``repro`` stays the reference.  This package imports
``torch`` and never ``jax``, and imports nothing from ``repro``: the
framework-free pieces it needs (model configs, the tenant metric schema)
are copied here.  Module paths mirror ``repro``'s, so
``repro_torch.models.layers`` is the counterpart of
``repro.models.layers``.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; on a
CUDA tensor the attention ops launch the hand-written kernels under
``repro_torch/kernels/csrc/``, on a CPU tensor their plain PyTorch
versions.
"""
