"""diffpir_tpu_torch — the PyTorch/CUDA port of diffpir_tpu for one NVIDIA H100.

Plug-and-play diffusion image restoration: a pre-trained diffusion UNet
denoiser alternates with closed-form data-fidelity steps along one sampling
trajectory.  The JAX package ``diffpir_tpu`` stays the reference; this
package imports nothing of it (and neither JAX, PyYAML nor Pillow) and is
held against it by ``tests/test_torch_*.py``.  Its GroupNorm and attention
run as hand-written CUDA kernels (``diffpir_tpu_torch.kernels``) on the card.
"""

__version__ = "0.1.0"

from diffpir_tpu_torch.config import TaskConfig, load_config
from diffpir_tpu_torch.schedule import NoiseSchedule, TrajectoryPlan, build_plan

__all__ = ["TaskConfig", "load_config", "NoiseSchedule", "TrajectoryPlan",
           "build_plan", "resolve_device"]


def resolve_device(cpu: bool):
    """The device an entry point runs on: the CPU when ``cpu`` is asked for,
    else the current CUDA card; raises when there is no card."""
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --cpu (or device='cpu') to run "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
