"""PyTorch / CUDA (Hopper, sm_90a) port of the streaming speech-translation
system in ``infinisst_tpu``.

The JAX package stays the reference; this package mirrors its module names
(``core``, ``streaming``, ``models``, ``decode``, ``data``, ``agents``,
``kernels``) and imports nothing of it.  Entry points run on ``cuda`` unless
the caller asks for the CPU; on the CPU every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches its hand-written kernel or
raises.
"""
