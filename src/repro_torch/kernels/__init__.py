"""Hand-written CUDA kernels for the compute hot-spots.

Each kernel is a CUDA C++ source in ``csrc/`` (built by ``_build`` on first
use, loaded with ctypes) plus a subpackage here: ops.py (the wrapper that
checks its operands, launches the kernel on a CUDA tensor, takes the plain
version on a CPU tensor and counts its launches) and ref.py (the plain
PyTorch version).  ``registry`` lists them for the lowering compiler.
"""
