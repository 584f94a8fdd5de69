"""PyTorch + CUDA port of cluster_capacity_tpu (capacity estimation on an
NVIDIA Hopper card).  Imports torch and numpy, never jax and nothing of the
JAX package; the JAX package stays the reference the port is held to."""

__version__ = "0.1.0"

from .framework import ClusterCapacity
from .models.snapshot import ClusterSnapshot
from .utils.config import SchedulerProfile, load_scheduler_config

__all__ = ["ClusterCapacity", "ClusterSnapshot", "SchedulerProfile",
           "load_scheduler_config", "__version__"]
