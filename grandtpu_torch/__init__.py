"""grandtpu_torch — the PyTorch/CUDA port of grandtpu for NVIDIA Hopper.

Mirrors ``grandtpu``'s layout module by module; ``grandtpu`` (JAX) stays
the reference the port is tested against, and the port imports nothing
of it:

- ``grandtpu_torch.config``  own copy of ``GrandConfig`` and the presets
- ``grandtpu_torch.data``    ``load_data`` for every file family of
                             grandtpu (planetoid, aminer, the SparseGraph
                             npz family, reddit, Amazon2M, MAG) and the
                             ``synth:`` graphs; splits, preprocessing
                             (numpy/scipy)
- ``grandtpu_torch.ppr``     GFPush precompute: native C++ kernel, numpy
- ``grandtpu_torch.sparse``  ``TopKProp`` table; CSR SpMM (kernel K2 and
                             its bf16/int8 forms); padded-COO SpMM (K2-seg)
- ``grandtpu_torch.nn``      MLP with masked BatchNorm, DropNode mean
                             (kernel K1), losses; the MAG model and its
                             embedding-bag + DropNode mean (kernel K3, and
                             its vocab-window form)
- ``grandtpu_torch.train``   train/eval steps, early-stopped loop, ``train``
                             (dense engine, or the MAG engine on CSR data),
                             npz checkpoints in grandtpu's format
- ``grandtpu_torch.infer``   exact propagation (dense, csr, segment),
                             chunked classification, the MAG predict in
                             embedding space
- ``grandtpu_torch.dist``    the device mesh and its collectives;
                             data-parallel training placement (D2, the
                             vocab-sharded MAG table); row-partitioned
                             propagation (all_gather and halo exchange,
                             D1); the source-sharded push
- ``grandtpu_torch.cli``     ``run`` / ``predict`` / ``presets``
- ``grandtpu_torch.ops``     nvcc build of ``csrc/*.cu`` for sm_90a

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"
