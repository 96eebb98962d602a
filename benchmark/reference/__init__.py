"""The plain reference of the benchmark: guided-diffusion's UNet and DiffPIR's
restore in plain PyTorch (``unet.py``, ``diffpir.py``).  Imports nothing of
the program under test and nothing of JAX."""
