"""Build and loading of the hand-written CUDA kernels (``_build``)."""
