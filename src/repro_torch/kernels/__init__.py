"""CUDA kernels for the compute hot-spots.

K1, K2, K4 (flash attention, for the model substrate) and the cycle
kernel (whole cycle-level simulations, for hwsim) are CUDA C++ sources in
``csrc/``; K3 is CUDA C++ that the
megakernel emitter (core/lowering/megakernel.py) writes per fused segment,
with ``csrc/mk_common.cuh``.  ``_build`` builds them on first use and loads
them with ctypes.  Each has a subpackage here: ops.py (the wrapper that
checks its operands, launches the kernel on a CUDA tensor, takes the plain
version on a CPU tensor and counts its launches) and ref.py (the plain
PyTorch version); megakernel/check.py compares K3 with its plain version.
``stream`` holds K3's tile constants and ``registry`` lists every kernel.
"""
