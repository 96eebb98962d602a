"""Hand-written CUDA kernels of the port, each with a plain PyTorch version.

``LAUNCHES`` counts, per kernel, the calls that launched the CUDA kernel (a
call on a CPU tensor runs the plain version and is not counted), so a run can
show which kernels its path went through.  Callers reset it with
``LAUNCHES.clear()``.
"""

import collections

LAUNCHES: collections.Counter = collections.Counter()

__all__ = ["LAUNCHES"]
