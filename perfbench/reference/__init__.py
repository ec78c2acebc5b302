"""Plain references that decide ``correct``: a dense decoder's forward
pass in float32 (``decoder.py``, the ``dense`` kind's) and LAD-TS's
reverse diffusion chain in float64 (``ladn.py``), each with the
lower-precision control the check is shown to fail with.  They import
torch and numpy only: nothing of the port, of ``repro`` or of JAX."""
