"""grandtpu_torch — the PyTorch/CUDA port of grandtpu for NVIDIA Hopper.

Mirrors ``grandtpu``'s layout module by module; ``grandtpu`` (JAX) stays
the reference the port is tested against, and the port imports nothing
of it:

- ``grandtpu_torch.config``  own copy of ``GrandConfig`` and the presets
- ``grandtpu_torch.data``    ``synth:`` loader, splits, self-loops (numpy)
- ``grandtpu_torch.ppr``     GFPush precompute: native C++ kernel, numpy
- ``grandtpu_torch.sparse``  ``TopKProp`` table; CSR SpMM (kernel K2)
- ``grandtpu_torch.nn``      MLP with masked BatchNorm, DropNode mean
                             (kernel K1), losses
- ``grandtpu_torch.train``   train/eval steps, early-stopped loop, ``train``
- ``grandtpu_torch.infer``   exact propagation, chunked classification
- ``grandtpu_torch.cli``     ``run`` / ``presets``
- ``grandtpu_torch.ops``     nvcc build of ``csrc/*.cu`` for sm_90a

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"
